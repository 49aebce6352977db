"""shadow_idle_ms: device idle ms a window frame in the gaps that began
while the program's shadow-pass span (vkr.shadow) was open on the host,
its cascades included (vkbench/progspans.py).  Device trace."""

from vkbench.progspans import idle_ms


def read(run):
    return idle_ms(run, "vkr.shadow")
