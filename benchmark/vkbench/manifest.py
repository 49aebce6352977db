"""BENCHMARK.json and the files it names, found by name.

- a configuration: ``benchmark/configs/<config>.json`` (the manifest's
  ``file``),
- a traffic mix: ``benchmark/traffic/<traffic>.json``,
- a metric, end-to-end or per-layer: ``benchmark/metrics/<name>.py``, a
  reader with ``read(run) -> float | None``.

A later change adds a cell, a configuration, a mix or a metric by adding
files and manifest entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in {MANIFEST.name}")


def config(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in {MANIFEST.name}")


def traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on; a metric with a
    ``workloads`` list only in those cells."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The module ``benchmark/metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "vkbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
