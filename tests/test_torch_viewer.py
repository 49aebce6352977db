"""The port's interactive viewer (vk_renderer_tpu_torch/app/viewer.py)
against the JAX viewer (vk_renderer_tpu/app/viewer.py).

Both ``main``s run under one stand-in HighGUI module placed in
``sys.modules["cv2"]`` and one fixed-step clock as their ``time``, with
256^2 shadow maps (tests/viewer_script.py): the same key script, drags
and slider moves, the same frame times.  A spy on each package's
``driver.render`` records the camera, the settings, the render size and
the stats of every frame.

Held to the JAX viewer on the cube at 256x128, through every key
binding, a drag, the six trackbars and one resize (192x96): equal HUD
strings, frames >= 40 dB with equal stats, the camera within 1e-6 and
equal settings at every frame.  Port-only: the ladder's sizes, the
nearest upscale against OpenCV's, the missing-device exit code, the
core's ESC and no-key polls."""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (bounds torch's threads)
from viewer_script import ARGV, H, SCRIPT, W, run_viewer
from vk_renderer_tpu.app import viewer as jax_viewer
from vk_renderer_tpu.graph import driver as jax_driver
from vk_renderer_tpu.utils.image import psnr
from vk_renderer_tpu_torch.app import viewer
from vk_renderer_tpu_torch.graph import driver as torch_driver


@pytest.fixture(scope="module")
def both_viewers():
    with pytest.MonkeyPatch.context() as mp:
        return (run_viewer(mp, jax_viewer, jax_driver, ARGV),
                run_viewer(mp, viewer, torch_driver,
                           ARGV + ["--device", "cpu"]))


def test_viewer_matches_the_jax_viewer(both_viewers):
    """Frame for frame: HUD text, image (>= 40 dB), stats, camera (1e-6),
    settings (exact) and render size."""
    (jgui, jframes), (tgui, tframes) = both_viewers
    n = len(SCRIPT)
    assert len(jframes) == len(tframes) == len(jgui.shown) == n
    assert tgui.texts == jgui.texts and len(tgui.texts) == n
    assert [f["size"] for f in tframes] == [f["size"] for f in jframes]
    assert (W * 3 // 4, H * 3 // 4) in [f["size"] for f in tframes]
    # the window rolled over (frame time and fps on the HUD)
    assert any(" 0.0 ms" not in t for t in tgui.texts)
    for i, (jf, tf, ji, ti) in enumerate(zip(jframes, tframes, jgui.shown,
                                             tgui.shown)):
        assert ti.shape == ji.shape == (H, W, 3) and ti.dtype == np.uint8
        p = psnr(ti.astype(np.float32) / 255.0, ji.astype(np.float32) / 255.0)
        assert p >= 40.0, (i, p)
        assert tf["stats"] == jf["stats"], i
        np.testing.assert_allclose(tf["position"], jf["position"], rtol=0,
                                   atol=1e-6)
        assert abs(tf["yaw"] - jf["yaw"]) <= 1e-6
        assert abs(tf["pitch"] - jf["pitch"]) <= 1e-6
        for k, v in jf["settings"].items():
            assert np.array_equal(tf["settings"][k], v), (i, k)
    # the sliders start where the JAX ones do
    assert ({k: v[:2] for k, v in tgui.sliders.items()}
            == {k: v[:2] for k, v in jgui.sliders.items()})


def test_ladder_sizes_and_clamps():
    """The render sizes of the ladder against the JAX viewer's formula,
    and ',' / '.' clamped at both ends of it."""
    for width, height in ((1280, 720), (100, 50)):
        want = [(max(128, int(width * s)), max(64, int(height * s)))
                for s in (0.5, 0.75, 1.0)]
        assert [viewer.ladder_size(width, height, s)
                for s in viewer.SCALES] == want
        session = viewer.ViewerSession(None, width, height, 0.0)
        sizes = []
        for k in ".,,,..":
            session.key(ord(k), 0.0)
            sizes.append((session.cfg.width, session.cfg.height))
        assert sizes == [want[2], want[1], want[0], want[0], want[1],
                         want[2]]
        assert all(session.cfg_at(i).enable_shadows for i in range(3))


def test_upscale_matches_opencv_nearest():
    """The torch gather picks the pixel cv2.resize(INTER_NEAREST) picks,
    from every ladder size to the window."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    for width, height in ((1280, 720), (256, 128), (100, 50)):
        for s in viewer.SCALES:
            w, h = viewer.ladder_size(width, height, s)
            src = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            want = cv2.resize(src, (width, height),
                              interpolation=cv2.INTER_NEAREST)
            got = viewer.upscale_nearest(torch.from_numpy(src), height, width)
            assert np.array_equal(got.numpy(), want), (width, height, s)


def test_core_keys_without_a_window():
    """ESC quits like q; a poll with no key keeps a movement key held for
    HOLD_S after it was pressed, then lets it go."""
    session = viewer.ViewerSession(None, W, H, 0.0)
    assert session.key(ord("w"), 1.0)
    assert session.cam.velocity[2] == -1.0
    assert session.key(viewer.NO_KEY, 1.0 + viewer.HOLD_S / 2)
    assert session.cam.velocity[2] == -1.0
    assert session.key(viewer.NO_KEY, 1.0 + viewer.HOLD_S)
    assert not session.cam.velocity.any()
    assert not session.key(viewer.ESC, 2.0)
    assert not session.key(ord("q"), 2.0)


def test_viewer_refuses_a_missing_cuda_device(monkeypatch, capsys):
    """The default device is cuda, with no silent fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert viewer.main(["--scene", "cube"]) == 2
    assert "--device cpu" in capsys.readouterr().err
