"""The control — the reference with its stages rounded to bfloat16, in the
program's place — comes out not correct: on the CPU at the small size,
and on the card at each cell's own size on three seeds."""

import pytest
import torch

from control import control_numbers
from small import small_config, small_mix
from vkbench import check, manifest

MAN = manifest.load()


def _fails(row, limits) -> bool:
    return any(row[k] > limits[k] for k in check.NUMBERS)


def test_control_fails_at_the_small_size():
    cfg = small_config("sponza_csm_1080p")
    rows = control_numbers(cfg, small_mix(), [3, 2**31 + 1], "cpu",
                           n_frames=8)
    for row in rows:
        assert _fails(row, cfg["limits"]), row


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_control_fails_at_the_cells_size_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    w = manifest.workload(MAN, cell)
    cfg = manifest.config(MAN, w["config"])
    rows = control_numbers(cfg, manifest.traffic(w["traffic"]),
                           [101, 2**31 + 7, 3 * 10**9 + 1], "cuda:0")
    for row in rows:
        print(cell, row)
        assert _fails(row, cfg["limits"]), row
