"""device_idle_pct: 1 - (union of the device's activity intervals /
the traced window), in %.  Device trace."""

from vkbench.readers import idle_pct as read  # noqa: F401
