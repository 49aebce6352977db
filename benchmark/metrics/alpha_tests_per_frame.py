"""alpha_tests_per_frame: pixels the masked pass's alpha test ran on,
over every layer of every round, a window frame: the program's counter
masked.alpha_px (the accept gathers' sizes)."""

from vkbench.progspans import counter_per_frame


def read(run):
    return counter_per_frame(run, "masked.alpha_px")
