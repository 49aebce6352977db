"""The port's driver entries (vk_renderer_tpu_torch/entry.py) on the CPU.

- ``entry("cpu")`` against the JAX package's ``__graft_entry__.entry()``:
  the scene, scene data and settings it hands ``fn`` equal the JAX
  entry's arguments value for value; one frame's stats equal the JAX
  frame's and its image is >= 40 dB against the JAX frame's.  Compiling
  the JAX frame takes minutes, so its image is the committed
  tests/torch_goldens/entry_512x256.png and its stats are stated below,
  both written by tests/make_torch_entry_goldens.py;
- ``entry("cuda")`` without a card raises;
- ``dryrun_multichip(2)``: the inputs of its ranks equal the JAX dry
  run's (scene, scene data, settings and every FrameConfig field both
  packages have); it runs a two-process gloo world and returns; its rank-0
  frame is >= 40 dB against the JAX package's single-device
  ``render_frame`` of the same inputs (the committed
  tests/torch_goldens/dryrun_256x32.png, by the same script) and its
  stats equal that frame's, but ``triangles`` and ``drawcalls``, which
  each strip counts for itself and the world sums: those lie in
  [ref, 2 ref] (tests/test_torch_sharded.py's strip bounds)."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from vk_renderer_tpu_torch import entry as port_entry
from vk_renderer_tpu_torch.graph import frame
from vk_renderer_tpu_torch.utils.image import load_png, psnr

import torch_threads  # noqa: F401  (bounds torch's threads)
import make_torch_entry_goldens as jax_goldens
from test_torch_host import assert_scene_matches_device_put

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# The JAX entry frame's stats on the CPU backend, as
#   env JAX_PLATFORMS=cpu python tests/make_torch_entry_goldens.py
# prints them (167 s of compile and frame on an 8-core CPU host).  The
# entry's pinned shadow_cap=2048 and cap_opaque=2048 overflow in both
# packages, so bin_overflow is not 0.
JAX_ENTRY_STATS = {"triangles": 50_200, "drawcalls": 184,
                   "bin_overflow": 41_424, "peel_overflow": 0,
                   "sparse_overflow": 0, "fallback_px": 0}
# The single-device JAX frame of the dry run's inputs for two strips, as
# the same script prints them.
JAX_DRYRUN_STATS = {"triangles": 50_200, "drawcalls": 184,
                    "bin_overflow": 0, "peel_overflow": 0,
                    "sparse_overflow": 0, "fallback_px": 0}


@pytest.fixture(scope="module")
def port_args():
    return port_entry.entry("cpu")


def test_entry_inputs_equal_the_jax_entry(port_args):
    sys.path.insert(0, ROOT)
    import __graft_entry__
    _, (jscene, jsd, jst) = __graft_entry__.entry()
    _, (scene, sd, st) = port_args
    assert_scene_matches_device_put(jscene, scene)
    for want, got in ((jsd, sd), (jst, st)):
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(np.asarray(want[k]),
                                          got[k].numpy(), err_msg=k)


def test_entry_frame_matches_the_jax_frame(port_args):
    fn, args = port_args
    out = fn(*args)
    assert frame.stats_from_vec(out["stats_vec"]) == JAX_ENTRY_STATS
    assert tuple(out["color"].shape) == (3, 256, 512)
    assert bool(torch.isfinite(out["color"]).all())
    want = load_png(jax_goldens.ENTRY_GOLDEN)[..., :3]
    p = psnr(out["color_u8"].numpy().astype(np.float32) / 255.0,
             want.astype(np.float32) / 255.0)
    assert p >= 40.0, f"PSNR {p:.1f} dB vs the JAX entry frame"


def test_entry_refuses_a_missing_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry("cuda")


def test_dryrun_inputs_equal_the_jax_dryrun():
    n = jax_goldens.DRYRUN_DEVICES
    jscene, jsd, jst, jcfg = jax_goldens.dryrun_inputs(n)
    scene, sd, st, cfg = port_entry.dryrun_inputs(n)
    assert_scene_matches_device_put(jscene, scene)
    for want, got in ((jsd, sd), (jst, st)):
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(np.asarray(want[k]),
                                          got[k].numpy(), err_msg=k)
    # every field but the port's shadow_traced_windows, which picks the
    # JAX frame's traced-mode classifier windows and has no JAX field
    shared = [f.name for f in dataclasses.fields(cfg)
              if hasattr(jcfg, f.name)]
    assert len(shared) == len(dataclasses.fields(cfg)) - 1
    for name in shared:
        assert getattr(cfg, name) == getattr(jcfg, name), name


def test_dryrun_multichip_matches_the_jax_frame():
    n = jax_goldens.DRYRUN_DEVICES
    got = port_entry.dryrun_multichip(n)
    stats = got["stats"]
    per_strip = ("triangles", "drawcalls")   # each strip counts its own
    for k in per_strip:
        assert JAX_DRYRUN_STATS[k] <= stats[k] <= n * JAX_DRYRUN_STATS[k], k
    assert ({k: v for k, v in stats.items() if k not in per_strip}
            == {k: v for k, v in JAX_DRYRUN_STATS.items()
                if k not in per_strip})
    assert got["color_u8"].shape == (16 * n, 256, 3)
    want = load_png(jax_goldens.DRYRUN_GOLDEN)[..., :3]
    p = psnr(got["color_u8"].numpy().astype(np.float32) / 255.0,
             want.astype(np.float32) / 255.0)
    assert p >= 40.0, f"PSNR {p:.1f} dB vs the JAX frame"
