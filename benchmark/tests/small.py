"""Small copies of a cell's configuration and mix for CPU runs of the
harness: the glTF fixture at 64x32 with 256^2 shadow maps, and eight
poses around it."""

from __future__ import annotations

FIXTURE = "tests/fixtures/textured_box/scene.gltf"


def small_config(name: str) -> dict:
    """``benchmark/configs/<name>.json`` at the small size (the file is
    read whether or not a cell of the manifest names it)."""
    import json

    from vkbench import manifest
    with open(manifest.BENCH_DIR / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg["scene"]["gltf"] = FIXTURE
    cfg["frame"] = {"width": 64, "height": 32, "shadow_size": 256}
    return cfg


def small_mix() -> dict:
    from vkbench import manifest
    mix = dict(manifest.traffic("nave_walk"))
    mix["poses"] = [[0.0, 0.0, 3.0 + 0.08 * i, 0.05 * i, 0.0]
                    for i in range(8)]
    mix["warmup_poses"] = 2
    return mix
