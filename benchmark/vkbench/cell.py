"""One run of one cell: set-up, the measured window, the trace, the
comparison with the reference, the result line.

A cell renders on one card through ``graph/driver.render`` (the
program's ``render_frame``).

The loop is closed with one frame in flight: a frame is due when the
previous frame's ``color_u8`` is on the host, and its latency runs from
then until its own ``color_u8`` is.  Set-up (imports, scene load, the
kernels' libraries, warm-up frames at the cell's own size) ends where the
window begins.  After the window the program's state is freed and the
reference renders the frames picked for the comparison.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import sys
import time

import numpy as np

from . import check, hooks, manifest, trace, walk

COMPARED_FRAMES = 3      # frames of the window held against the reference
CHUNK_S = 5.0            # the window's latency, mean by chunks (stderr)
FORBIDDEN = ("jax", "jaxlib", "flax", "vk_renderer_tpu")


class Run:
    """What a run measured; the metric readers (``benchmark/metrics``)
    read its attributes."""

    def __init__(self):
        self.latencies: list[float] = []   # seconds, every window frame
        self.done_at: list[float] = []     # seconds into the window
        self.window_s = 0.0
        self.setup_s = 0.0
        self.scene_load_s = 0.0
        self.trace: dict | None = None    # trace.summarize()
        self.bound_s: dict = {}           # hand kernel -> window's bounds

    @property
    def frames(self) -> int:
        return len(self.latencies)


def settings_of(cfg: dict, RenderSettings):
    return RenderSettings(**cfg["settings"])


def frame_config_of(cfg: dict, settings, config_from_settings):
    return config_from_settings(settings, **cfg["frame"])


def camera_of(pose, Camera):
    x, y, z, yaw, pitch = pose
    return Camera(position=np.array([x, y, z], np.float32), yaw=float(yaw),
                  pitch=float(pitch))


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def load_program(cfg: dict, device):
    """The program's scene on ``device`` and the cell's settings; returns
    (scene, settings, frame config, scene-load seconds)."""
    from vk_renderer_tpu_torch.app.headless import build_scene
    from vk_renderer_tpu_torch.graph.driver import config_from_settings
    from vk_renderer_tpu_torch.graph.scenedata import RenderSettings
    from vk_renderer_tpu_torch.scene.types import scene_to_torch
    t0 = time.perf_counter()
    host = build_scene("scene", str(manifest.ROOT / cfg["scene"]["gltf"]),
                       str(manifest.ROOT / cfg["scene"]["cubemap"]))
    scene = scene_to_torch(host, device)
    _sync(device)
    load_s = time.perf_counter() - t0
    settings = settings_of(cfg, RenderSettings)
    return (scene, settings,
            frame_config_of(cfg, settings, config_from_settings), load_s)


def program_renderer(scene, settings, fcfg):
    """pose -> the program's output dict for that pose."""
    from vk_renderer_tpu_torch.graph import driver
    from vk_renderer_tpu_torch.scene.camera import Camera

    def render(pose):
        return driver.render(scene, camera_of(pose, Camera), settings, fcfg)
    return render


def run_cell(cell: str, seed: int, seconds: float, trace_on: bool, *,
             device, t_start: float, cfg: dict | None = None,
             mix: dict | None = None):
    """Set-up, window, comparison.  Returns (result dict, lines for
    stderr, the compared numbers with their limits last).  ``cfg`` and
    ``mix`` override the manifest's files (the harness's CPU tests run
    small copies)."""
    import torch
    man = manifest.load()
    if cfg is None or mix is None:
        w = manifest.workload(man, cell)
        cfg = manifest.config(man, w["config"]) if cfg is None else cfg
        mix = manifest.traffic(w["traffic"]) if mix is None else mix
    run = Run()
    hk = hooks.Hooks(trace_on)

    scene, settings, fcfg, run.scene_load_s = load_program(cfg, device)
    render = program_renderer(scene, settings, fcfg)
    with contextlib.ExitStack() as stack:
        hk.install(stack, device)
        # warm-up at the cell's own size, from poses spread over the loop
        t_warm = time.perf_counter()
        for pose in walk.warmup(mix, seed):
            out = render(pose)
            out["color_u8"].cpu()
        warm_frame_s = ((time.perf_counter() - t_warm)
                        / max(1, mix["warmup_poses"]))
        n_guess = max(COMPARED_FRAMES,
                      min(len(mix["poses"]), int(0.5 * seconds
                                                 / max(warm_frame_s, 1e-3))))
        picked = walk.sample(seed, n_guess, COMPARED_FRAMES)
        slots = {i: _slot(hk.seen, out) for i in picked}
        hk.sizing = False
        hk.seen.clear()
        stats_rows = torch.zeros((8192, out["stats_vec"].numel()),
                                 dtype=out["stats_vec"].dtype, device=device)
        if hk.trace:
            hk.bound.zero_()     # the window's launches only
        gc.collect()
        _sync(device)
        run.setup_s = time.monotonic() - t_start

        prof = trace.profiler() if hk.trace else contextlib.nullcontext()
        with prof:
            _window(run, hk, render, mix, seed, seconds, slots, stats_rows)
        _sync(device)
        if hk.trace:
            run.trace = trace.summarize(prof)
            run.bound_s = dict(zip(hooks.KERNELS,
                                   hk.bound.cpu().tolist()))
    n = run.frames
    stats = stats_rows[:min(n, stats_rows.shape[0])].cpu()
    failed = int((stats[:, check.OVERFLOW] > 0).any(1).sum())
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    captured = [(i, slots[i]) for i in picked if i < n]
    del scene, render, out, stats_rows
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # the reference, after the window, on the same poses and settings
    numbers = _reference_numbers(cfg, mix, seed, captured, device)
    ok, checks = check.judge(numbers, cfg["limits"], failed, len(captured))
    return (_result(man, cell, run, ok, checks, peak, failed, device),
            latency_lines(run) + check.lines(checks))


def latency_lines(run: Run) -> list[str]:
    """How the window's frame latency spreads: its quantiles, and its
    mean in each chunk of ``CHUNK_S`` seconds (a slow process is slow
    throughout; a stall is slow in one chunk)."""
    if not run.latencies:
        return []
    lat = sorted(run.latencies)
    q = {p: 1e3 * lat[max(0, math.ceil(p / 100 * len(lat)) - 1)]
         for p in (10, 50, 90, 100)}
    chunks: dict = {}
    for t, s in zip(run.done_at, run.latencies):
        chunks.setdefault(int(t // CHUNK_S), []).append(s)
    means = [round(1e3 * sum(v) / len(v), 1)
             for _, v in sorted(chunks.items())]
    return [f"latency ms: p10 {q[10]:.1f} p50 {q[50]:.1f} p90 {q[90]:.1f} "
            f"max {q[100]:.1f}; mean by {CHUNK_S:.0f} s chunk {means}"]


def _slot(seen: dict, out: dict) -> dict:
    import torch
    slot = {k: torch.empty_like(v) for k, v in seen.items()}
    slot["color_u8"] = torch.empty_like(out["color_u8"])
    slot["stats_vec"] = torch.empty_like(out["stats_vec"])
    return slot


def _window(run: Run, hk, render, mix, seed, seconds, slots,
            stats_rows) -> None:
    t_first = time.perf_counter()
    i = 0
    with hk.span("window"):
        while True:
            due = time.perf_counter()
            slot = slots.get(i)
            hk.slot = slot
            with hk.span("frame"):
                out = render(walk.pose(mix, seed, i))
                with hk.span("pull"):
                    out["color_u8"].cpu()
            hk.slot = None
            with hk.span("own"):
                if slot is not None:
                    slot["color_u8"].copy_(out["color_u8"])
                    slot["stats_vec"].copy_(out["stats_vec"])
                if i < stats_rows.shape[0]:
                    stats_rows[i].copy_(out["stats_vec"])
            done = time.perf_counter()
            run.latencies.append(done - due)
            run.done_at.append(done - t_first)
            i += 1
            if done - t_first >= seconds:
                break
    run.window_s = time.perf_counter() - t_first


def _reference_numbers(cfg, mix, seed, captured, device):
    if not captured:
        return None
    import reference
    from reference.graph.driver import config_from_settings
    scene = reference.load_scene(str(manifest.ROOT / cfg["scene"]["gltf"]),
                                 str(manifest.ROOT / cfg["scene"]["cubemap"]),
                                 device)
    settings = settings_of(cfg, reference.RenderSettings)
    fcfg = frame_config_of(cfg, settings, config_from_settings)
    frames = []
    for i, prog in captured:
        cam = camera_of(walk.pose(mix, seed, i), reference.Camera)
        ref = reference.render(scene, cam, settings, fcfg)
        frames.append(check.compare(prog, ref))
        del ref
    return check.worst(frames)


def _result(man, cell, run: Run, ok, checks, peak, failed, device) -> dict:
    import torch
    metrics = {}
    for m in manifest.metrics(man, cell, run.trace is not None):
        value = manifest.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    out = {"correct": bool(ok), "attempted": run.frames, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if run.trace is not None:
        out["device"]["busy_s"] = run.trace["busy_s"]
        out["device"]["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = checks
    return out


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that must not be loaded, compared
    whole (``vk_renderer_tpu_torch`` is not ``vk_renderer_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_env() -> None:
    """The CUDA driver's JIT cache inside the checkout, at a fixed path
    (the program's own libraries build into its ``build/`` there)."""
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(manifest.ROOT / ".bench_cache" / "nv"))
