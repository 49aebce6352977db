"""Device ops: torch counterparts of vk_renderer_tpu/ops."""
