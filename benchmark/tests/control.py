"""The control's readings: the reference rendered with its stages rounded
to bfloat16 (reference/lowp.py), put in the program's place and compared
with the float32 reference by the benchmark's own comparison
(vkbench/check.py) on the frames a run of that seed would compare.

    python benchmark/tests/control.py <cell> <seed> [<seed> ...]

prints one JSON line per seed with the worst frame's numbers, at the
cell's own size on the card (the reference's plain passes; one card).
"""

from __future__ import annotations

import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.dirname(BENCH_DIR), BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)


def control_numbers(cfg: dict, mix: dict, seeds, device,
                    n_frames: int | None = None, k: int = 3) -> list[dict]:
    """Per seed, the worst of the ``k`` compared frames' numbers."""
    import reference
    from reference.graph.driver import config_from_settings
    from reference.lowp import bf16_stages
    from vkbench import cell, check, manifest, walk
    scene = reference.load_scene(str(manifest.ROOT / cfg["scene"]["gltf"]),
                                 str(manifest.ROOT / cfg["scene"]["cubemap"]),
                                 device)
    settings = cell.settings_of(cfg, reference.RenderSettings)
    fcfg = cell.frame_config_of(cfg, settings, config_from_settings)
    keys = ("depth", "tid", "shadow_maps", "color_u8", "stats_vec")
    out = []
    for seed in seeds:
        frames = []
        n = n_frames if n_frames is not None else len(mix["poses"])
        for i in walk.sample(seed, n, k):
            cam = cell.camera_of(walk.pose(mix, seed, i), reference.Camera)
            ref = reference.render(scene, cam, settings, fcfg)
            with bf16_stages():
                low = reference.render(scene, cam, settings, fcfg)
            frames.append(check.compare({k_: low[k_] for k_ in keys}, ref))
            del ref, low
        out.append(dict(check.worst(frames), seed=seed))
    return out


def main(argv) -> int:
    import torch
    from vkbench import manifest
    man = manifest.load()
    w = manifest.workload(man, argv[0])
    cfg = manifest.config(man, w["config"])
    mix = manifest.traffic(w["traffic"])
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    for row in control_numbers(cfg, mix, [int(s) for s in argv[1:]], device):
        print(json.dumps(dict(row, cell=argv[0])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
