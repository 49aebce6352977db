"""Regenerate the JAX reference frames of tests/test_torch_entry.py
(tests/torch_goldens/*.png), rendered by the JAX package on the CPU
backend:

- entry_512x256.png: the ``__graft_entry__.entry()`` frame (40k-triangle
  ``sponza_like`` at 512x256, CSM mode 3, tonemap, the entry's pinned
  caps), the reference of the port's ``entry("cpu")`` frame;
- dryrun_256x32.png: the single-device ``render_frame`` of
  ``__graft_entry__.dryrun_multichip(2)``'s inputs (12k-triangle
  ``sponza_like``, its FrameConfig at 256x32, the bench camera), the
  reference of the port's two-strip ``dryrun_multichip(2)`` frame.

Compiling either JAX frame takes minutes on one CPU core, too long for
the test itself.  Run from the repository root after an intentional
rendering change in the JAX package:

    env JAX_PLATFORMS=cpu python tests/make_torch_entry_goldens.py

It prints each frame's stats, which the test states as JAX_ENTRY_STATS
and JAX_DRYRUN_STATS."""

import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
GOLDEN_DIR = os.path.join(ROOT, "tests", "torch_goldens")
ENTRY_GOLDEN = os.path.join(GOLDEN_DIR, "entry_512x256.png")
DRYRUN_DEVICES = 2
DRYRUN_GOLDEN = os.path.join(GOLDEN_DIR, "dryrun_256x32.png")


def entry_frame():
    """The JAX entry's one step, jitted: render_frame's dict."""
    import jax

    import __graft_entry__
    fn, args = __graft_entry__.entry()
    return jax.jit(fn)(*args)


def dryrun_inputs(n_devices: int):
    """(scene, scene_data, settings, cfg): the inputs the JAX dry run
    builds for ``n_devices`` strips (``__graft_entry__.dryrun_multichip``,
    whose body holds them inline)."""
    import numpy as np

    from vk_renderer_tpu.graph import driver
    from vk_renderer_tpu.graph.frame import FrameConfig
    from vk_renderer_tpu.graph.scenedata import RenderSettings
    from vk_renderer_tpu.scene import procedural
    from vk_renderer_tpu.scene.camera import Camera

    scene = procedural.build_sponza_like(target_tris=12_000).build() \
        .device_put()
    settings = RenderSettings(enable_shadows=True, shadow_mode=3,
                              enable_postprocess=True)
    cfg = FrameConfig(
        width=256, height=16 * n_devices, tile_w=128, tile_h=16,
        enable_shadows=True, shadow_size=256, shadow_cascades=4,
        shadow_cap=65536, cap_opaque=65536, cap_masked=32768,
        cap_transparent=8192, rec_opaque=4096, rec_masked=2048,
        rec_transparent=1024, rec_shadow=4096, raster_chunk=32,
        masked_chunk=16, packed_rows=True, k_raster=True, masked_peels=8,
        masked_tail_rounds=1, masked_tail_peels=4)
    cam = Camera(position=np.array([9.0, 1.8, 0.3], np.float32))
    cam.yaw = np.pi / 2
    return (scene, driver.scene_data_pytree(cam, settings, cfg),
            driver.make_settings_pytree(settings), cfg)


def dryrun_frame(n_devices: int):
    """render_frame of dryrun_inputs(n_devices) on one device."""
    from vk_renderer_tpu.graph.frame import render_frame
    return render_frame(*dryrun_inputs(n_devices))


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, ROOT)
    import numpy as np

    from vk_renderer_tpu.graph.frame import stats_from_vec
    from vk_renderer_tpu.utils.image import save_png

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for path, render in ((ENTRY_GOLDEN, entry_frame),
                         (DRYRUN_GOLDEN,
                          lambda: dryrun_frame(DRYRUN_DEVICES))):
        out = render()
        save_png(path, np.asarray(out["color_u8"]))
        print(f"wrote {path}  stats={stats_from_vec(out['stats_vec'])}")


if __name__ == "__main__":
    main()
