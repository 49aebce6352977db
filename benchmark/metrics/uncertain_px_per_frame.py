"""uncertain_px_per_frame: pixels the shadow classifier could not prove
lit or blocked, so the filter ran on them, a window frame: the program's
counter shade.uncertain_px."""

from vkbench.progspans import counter_per_frame


def read(run):
    return counter_per_frame(run, "shade.uncertain_px")
