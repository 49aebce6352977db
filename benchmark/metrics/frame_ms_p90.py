"""frame_ms_p90: the 90th percentile (nearest rank) of every window
frame's latency, due to color_u8 on the host, in ms.  Host clock."""

from vkbench.readers import p90_ms as read  # noqa: F401
