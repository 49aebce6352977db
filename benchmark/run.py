"""One run of one benchmark cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (BENCHMARK.json ``workloads``) names a configuration
(``benchmark/configs/``), a traffic mix (``benchmark/traffic/``) and the
cards it needs.  The run sets up the program, renders frames in a closed
loop for ``--seconds``, holds the frames picked from the seed against the
plain reference (``benchmark/reference/``), prints the compared numbers
with their limits on stderr and one JSON result line last on stdout: the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics (read
from a profiler trace of the window) with ``--trace 1``.

Exits 2 without printing a result when CUDA is absent, when fewer cards
are present than the cell asks for, when the cell asks for more than one
card (this harness runs one-card cells), or when the program is missing.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for path in (ROOT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from vkbench import cell, manifest
    from vkbench.report import emit
    cell.cache_env()
    try:
        man = manifest.load()
        chips = manifest.workload(man, args.workload)["chips"]
    except (OSError, KeyError, ValueError) as err:
        print(f"run: {err}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("run: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"run: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        import vk_renderer_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"run: the program is missing: {err}", file=sys.stderr)
        return 2
    if chips != 1:
        print(f"run: {args.workload} asks for {chips} cards; this harness "
              f"runs one-card cells", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, lines = cell.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), device="cuda:0",
                                  t_start=T_START)
    return emit(result, lines)


if __name__ == "__main__":
    sys.exit(main())
