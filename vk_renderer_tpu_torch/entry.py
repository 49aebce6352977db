"""Driver entry points: a one-step render on one device and a multi-worker
dry run.

Counterpart of the JAX package's ``__graft_entry__.py`` (at the
repository root):

- ``entry(device)`` returns ``(fn, (scene, scene_data, settings))``: one
  ``render_frame`` step of the 40k-triangle procedural ``sponza_like``
  scene at 512x256 (CSM mode 3, tonemap, the entry's pinned caps, which
  overflow: ``bin_overflow`` is not 0 in either package), on the card by
  default;
- ``dryrun_multichip(n)`` renders the full flagship-featured frame as n
  horizontal strips, one per process of a gloo world, always on the CPU.

Run them with:
    python -c "from vk_renderer_tpu_torch.entry import entry; \\
        fn, a = entry(); print(fn(*a)['stats_vec'].tolist())"
    python -c "from vk_renderer_tpu_torch.entry import dryrun_multichip \\
        as d; print(d(4)['stats'])"
"""

from __future__ import annotations

import datetime
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .app.bench import bench_camera, bench_settings
from .graph import driver
from .graph.frame import FrameConfig, render_frame, stats_from_vec
from .parallel.sharded import render_frame_sharded
from .scene import procedural
from .scene.camera import Camera
from .scene.types import scene_to_torch


def entry(device="cuda"):
    """(fn, (scene, scene_data, settings)): ``fn(*args)`` renders one
    frame of the flagship scene on ``device`` and returns render_frame's
    dict.  Raises when ``device`` is CUDA and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"entry: device {device} asked for, but no CUDA "
                           f"device is available")
    scene = scene_to_torch(
        procedural.build_sponza_like(target_tris=40_000).build(), dev)
    settings = bench_settings()
    cfg = driver.config_from_settings(settings, 512, 256, shadow_size=512,
                                      shadow_cap=2048, cap_opaque=2048)
    cam = Camera(position=np.array([0.0, 1.7, 0.0], np.float32))
    sd, st = driver.frame_inputs(scene, cam, settings, cfg)

    def fn(scene, sd, st):
        return render_frame(scene, sd, st, cfg)

    return fn, (scene, sd, st)


def dryrun_inputs(n_devices: int):
    """(scene, scene_data, settings, cfg) of the dry run on the CPU: the
    12k-triangle ``sponza_like`` (masked and transparent buckets), CSM
    mode 3 with four 256^2 cascades, the classifier, the masked k-buffer
    with a continuation round, skybox and tonemap, at 256 x 16n, with the
    bench's camera and settings.  The JAX dry run's FrameConfig without
    its TPU layout fields (``raster_chunk``, ``masked_chunk``,
    ``packed_rows``, ``k_raster``), which the port does not have."""
    scene = scene_to_torch(
        procedural.build_sponza_like(target_tris=12_000).build(), "cpu")
    settings = bench_settings()
    cfg = FrameConfig(
        width=256, height=16 * n_devices, tile_w=128, tile_h=16,
        enable_shadows=True, shadow_size=256, shadow_cascades=4,
        shadow_cap=65536, cap_opaque=65536, cap_masked=32768,
        cap_transparent=8192, rec_opaque=4096, rec_masked=2048,
        rec_transparent=1024, rec_shadow=4096, masked_peels=8,
        masked_tail_rounds=1, masked_tail_peels=4)
    sd, st = driver.frame_inputs(scene, bench_camera(), settings, cfg)
    return scene, sd, st, cfg


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _dryrun_rank(rank: int, n_devices: int, tmp: str, threads: int) -> None:
    """One rank of the dry run's world: joins the gloo group through a
    FileStore in ``tmp``, renders its strip of the frame, checks the
    assembled frame; rank 0 saves it into ``tmp``."""
    torch.set_num_threads(threads)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), n_devices),
        rank=rank, world_size=n_devices,
        timeout=datetime.timedelta(seconds=600))
    try:
        scene, sd, st, cfg = dryrun_inputs(n_devices)
        _require(scene.n_masked > 0 and scene.n_transparent > 0,
                 "the flagship dry run needs masked and transparent "
                 "buckets")
        out = render_frame_sharded(scene, sd, st, cfg,
                                   group=dist.group.WORLD)
        _require(tuple(out["color"].shape) == (3, cfg.height, cfg.width),
                 f"colour of shape {tuple(out['color'].shape)}")
        stats = stats_from_vec(out["stats_vec"])
        _require(stats["triangles"] > 0, "no triangle drawn")
        for k in ("bin_overflow", "peel_overflow", "sparse_overflow"):
            _require(stats[k] == 0, f"{k} = {stats[k]}")
        if rank == 0:
            torch.save({"color_u8": out["color_u8"], "stats": stats},
                       os.path.join(tmp, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> dict:
    """Render the flagship-featured frame (dryrun_inputs) as one strip
    per process of an ``n_devices``-process gloo world on the CPU, even
    where a card is present, and check on every rank that the assembled
    colour is [3, 16n, 256], that triangles were drawn and that no bin,
    peel or sparse overflow happened.  Raises if any rank fails; returns
    rank 0's frame: {"color_u8": u8 [16n, 256, 3], "stats": dict}.

    The JAX dry run also asserts that the scene carries baked alpha
    states; those are a TPU form the port does not have."""
    threads = max(1, torch.get_num_threads() // n_devices)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_dryrun_rank, args=(n_devices, tmp, threads),
                 nprocs=n_devices, join=True)
        return torch.load(os.path.join(tmp, "rank0.pt"))
