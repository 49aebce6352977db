"""kernel_roofline_pct: the summed bound of every launch of the four
hand kernels in the window (roofline.py, from each launch's own inputs,
recorded at the dispatchers) over their summed device time (the
kernels' own names in the trace, with the raster kernels' segment
planner), in %.  Nothing when the window launched none."""

KERNEL_NAMES = ("raster_depth_kernel", "raster_layers_kernel",
                "plan_segments", "tonemap_kernel", "gradient_kernel")


def read(run):
    if run.trace is None:
        return None
    device_s = sum(s for name, s in run.trace["kernel_s"].items()
                   if any(k in name for k in KERNEL_NAMES))
    if device_s <= 0:
        return None
    return 100.0 * sum(run.bound_s.values()) / device_s
