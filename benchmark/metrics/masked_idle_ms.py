"""masked_idle_ms: device idle ms a window frame in the gaps that began
while the program's masked-pass span (vkr.masked) was open on the host,
its rounds and accepts included (vkbench/progspans.py).  Device trace."""

from vkbench.progspans import idle_ms


def read(run):
    return idle_ms(run, "vkr.masked")
