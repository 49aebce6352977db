"""host_syncs_per_frame: CUDA runtime calls that wait for the device in
the traced window (stream, device and event synchronisation, blocking
copies; vkbench/trace.SYNC_CALLS), per frame.  Device trace."""

from vkbench.readers import per_frame


def read(run):
    return per_frame(run, "syncs")
