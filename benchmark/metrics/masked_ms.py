"""masked_ms: host wall time inside the masked span (the benchmark's span
around the program's stage, vkbench/hooks.SPANS), per window frame."""

from vkbench.readers import span_ms


def read(run):
    return span_ms(run, "masked")
