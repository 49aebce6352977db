"""The port's benchmark driver (vk_renderer_tpu_torch/app/bench.py) on the
CPU.

- ``main`` on the glTF fixture at 64x32 with 256^2 shadow maps and 2
  timed frames: stdout is exactly bench.py's one JSON line; stderr holds
  the parity line (PSNR infinite: on the CPU both frames are plain) and
  the nine-key stats line; the stats equal the JAX package's
  ``driver.render`` stats for the same scene, settings, config and
  camera, and the warm-up frame is >= 40 dB against the JAX frame;
- without a card ``--device cuda`` exits 2 and prints nothing on stdout;
- ``plain_kernels()`` restores the four dispatchers after a body that
  raises;
- no module of the port, and not chip_smoke.py, imports JAX or the JAX
  package: an ``ast`` walk of every file, and a subprocess that imports
  the bench and the entries."""

import ast
import contextlib
import glob
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vk_renderer_tpu_torch.app import bench
from vk_renderer_tpu_torch.graph import driver, frame
from vk_renderer_tpu_torch.ops import masked, post
from vk_renderer_tpu_torch.ops import raster_kernels as rk
from vk_renderer_tpu_torch.scene.types import scene_to_torch
from vk_renderer_tpu_torch.utils.image import psnr

import torch_threads  # noqa: F401  (bounds torch's threads)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "textured_box",
                       "scene.gltf")
W, H, SHADOW = 64, 32, 256
ARGV = ["--device", "cpu", "--gltf", FIXTURE, "--width", str(W),
        "--height", str(H), "--shadow-size", str(SHADOW), "--frames", "2",
        "--no-continuity"]
STATS_LINE_KEYS = ["frametime_ms", "triangles", "drawcalls", "bin_overflow",
                   "peel_overflow", "sparse_overflow", "fallback_px",
                   "backend", "scene_triangles"]


@pytest.fixture(scope="module")
def bench_run():
    """(rc, stdout lines, stderr JSON lines) of main(ARGV)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(ARGV)
    return (rc, out.getvalue().splitlines(),
            [json.loads(ln) for ln in err.getvalue().splitlines()
             if ln.startswith("{")])


@pytest.fixture(scope="module")
def jax_frame():
    """The JAX package's driver.render of the fixture at the bench camera,
    settings and pure config defaults at W x H, SHADOW."""
    from vk_renderer_tpu.graph import driver as jdriver
    from vk_renderer_tpu.graph.frame import stats_from_vec
    from vk_renderer_tpu.graph.scenedata import RenderSettings
    from vk_renderer_tpu.scene import procedural
    from vk_renderer_tpu.scene.assembly import SceneBuilder
    b = SceneBuilder()
    b.load_gltf(FIXTURE, "scene")
    b.cubemap = procedural.make_sky_cubemap(256)
    settings = RenderSettings(enable_shadows=True, shadow_mode=3,
                              enable_postprocess=True)
    cfg = jdriver.config_from_settings(settings, W, H, shadow_size=SHADOW)
    out = jdriver.render(b.build().device_put(), bench.bench_camera(),
                         settings, cfg)
    return np.asarray(out["color_u8"]), stats_from_vec(out["stats_vec"])


def test_bench_prints_the_contract_lines(bench_run):
    rc, stdout, lines = bench_run
    assert rc == 0
    assert len(stdout) == 1
    line = json.loads(stdout[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == f"scene_{W}x{H}_fps"
    assert line["unit"] == "fps" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 60.0, 4)
    parity = [ln for ln in lines if "parity_psnr_db" in ln]
    assert parity == [{"parity_psnr_db": float("inf"), "parity_pass": True}]
    (stats,) = [ln for ln in lines if "frametime_ms" in ln]
    assert list(stats) == STATS_LINE_KEYS
    assert stats["backend"] == "cpu" and stats["scene_triangles"] == 14
    assert not [ln for ln in lines if "continuity_scene" in ln]


def test_bench_stats_match_the_jax_frame(bench_run, jax_frame):
    _, _, lines = bench_run
    (stats,) = [ln for ln in lines if "frametime_ms" in ln]
    want = jax_frame[1]
    assert {k: stats[k] for k in frame.STATS_KEYS} == want
    assert want["triangles"] > 0


def test_bench_frame_matches_the_jax_frame(jax_frame):
    """The bench's warm-up frame (the function main calls) against the
    JAX frame: >= 40 dB on the u8 image, equal stats."""
    host, name = bench.load_scene(FIXTURE)
    assert name == "scene"
    settings = bench.bench_settings()
    cfg = driver.config_from_settings(settings, W, H, shadow_size=SHADOW)
    out, stats = bench.warm_up(scene_to_torch(host, "cpu"),
                               bench.bench_camera(), settings, cfg)
    assert int((out["depth"] < 1.0).sum()) > 0      # the box is in view
    got = out["color_u8"].numpy()
    assert got.shape == jax_frame[0].shape == (H, W, 3)
    p = psnr(got.astype(np.float32) / 255.0,
             jax_frame[0].astype(np.float32) / 255.0)
    assert p >= 40.0, f"PSNR {p:.1f} dB"
    assert stats == jax_frame[1]


def test_bench_refuses_a_missing_cuda_device(monkeypatch, capsys):
    """The default device is cuda, with no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "--device cpu" in captured.err


def test_plain_kernels_restores_the_dispatchers_after_a_raise():
    real = (rk.rasterize_depth_grid, rk.rasterize_layers_grid,
            frame.POSTPROCESS_REGISTRY["tonemap"], post.gradient,
            masked.masked_resolve)
    with pytest.raises(ValueError, match="inside"):
        with bench.plain_kernels():
            assert (rk.rasterize_depth_grid, rk.rasterize_layers_grid,
                    frame.POSTPROCESS_REGISTRY["tonemap"],
                    post.gradient, masked.masked_resolve) == (
                        rk.rasterize_depth_grid_plain,
                        rk.rasterize_layers_grid_plain,
                        post.tonemap_plain, post.gradient_plain,
                        masked.masked_resolve_plain)
            raise ValueError("inside")
    assert (rk.rasterize_depth_grid, rk.rasterize_layers_grid,
            frame.POSTPROCESS_REGISTRY["tonemap"], post.gradient,
            masked.masked_resolve) == real


def _imported_roots(path: str) -> set:
    """The top-level package of every absolute import in a source file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_module_imports_jax():
    files = sorted(glob.glob(os.path.join(ROOT, "vk_renderer_tpu_torch",
                                          "**", "*.py"), recursive=True))
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 30
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "vk_renderer_tpu"}
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_bench_and_entries_load_no_jax():
    code = ("import sys, vk_renderer_tpu_torch.app.bench, "
            "vk_renderer_tpu_torch.entry; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'vk_renderer_tpu'}))")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
