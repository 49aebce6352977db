"""The benchmark harness's own tests (run with
``python -m pytest -q benchmark/tests``; the repository's ``tests/`` run
does not collect them).  Tests marked ``cuda`` need the card and skip
without one, decided inside the test."""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for path in (ROOT, BENCH_DIR, os.path.join(BENCH_DIR, "tests")):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is false")
