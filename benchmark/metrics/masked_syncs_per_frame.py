"""masked_syncs_per_frame: CUDA runtime calls that wait for the device
(vkbench/trace.SYNC_CALLS) whose innermost program span lies inside the
masked pass (vkr.masked), a window frame (vkbench/progspans.py).  Device
trace."""

from vkbench.progspans import syncs_per_frame


def read(run):
    return syncs_per_frame(run, "masked")
