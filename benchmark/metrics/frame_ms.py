"""frame_ms: the window's seconds x 1000 over the frames it completed
(one frame in flight; a frame runs from due to its color_u8 on the
host).  Host clock."""

from vkbench.readers import mean_ms as read  # noqa: F401
