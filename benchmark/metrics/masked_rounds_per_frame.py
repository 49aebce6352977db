"""masked_rounds_per_frame: k-buffer rounds of the masked pass that ran
(round 0 and each continuation round), a window frame: the program's
counter masked.rounds (vk_renderer_tpu_torch/utils/tracing.py)."""

from vkbench.progspans import counter_per_frame


def read(run):
    return counter_per_frame(run, "masked.rounds")
