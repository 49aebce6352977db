"""launches_per_frame: CUDA kernels the program launched in the traced
window (the benchmark's own work left out), per frame.  Device trace."""

from vkbench.readers import per_frame


def read(run):
    return per_frame(run, "launches")
