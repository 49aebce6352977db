"""The harness, its look for a card skipped, runs the rest of a run on
the CPU at a small size; with the timed path broken underneath, the run
comes out not correct, and unbroken it comes out correct."""

import time

import pytest

import faults
from small import small_config, small_mix
from vkbench import cell

ONE = "sponza_csm_1080p.nave_walk"
SEED = 2**31 + 977


def _run(fault=None):
    stack = fault() if fault is not None else None
    if stack is not None:
        stack.__enter__()
    try:
        result, lines = cell.run_cell(
            ONE, SEED, 0.5, False, device="cpu", t_start=time.monotonic(),
            cfg=small_config("sponza_csm_1080p"), mix=small_mix())
    finally:
        if stack is not None:
            stack.__exit__(None, None, None)
    return result


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 3
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", [faults.stale_frame, faults.altered_pixel,
                                   faults.half_the_cascades],
                         ids=["state_unchanged", "answer_altered",
                              "half_the_work_left_out"])
def test_broken_run_is_not_correct(fault):
    assert not _run(fault)["correct"]

