"""run.py's refusals: without a card, and without the program."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from vkbench import manifest

CELL = "sponza_csm_1080p.nave_walk"


def _run(cwd, env_extra=None):
    import os
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "2147483659", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert "metrics" not in obj


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run(manifest.ROOT)
    _no_result(proc)
    assert "CUDA" in proc.stderr


def test_with_only_the_benchmark_it_exits_nonzero(tmp_path):
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path, {"CUDA_VISIBLE_DEVICES": ""}))
