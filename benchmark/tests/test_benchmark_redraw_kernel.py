"""The reader of ``redraw_kernel_round_share`` on hand-made recordings:
the share of the redraw rounds that took the one-launch round, and
nothing where the program has no such counter or ran no round."""

import pytest

import _paths  # noqa: F401
from harness import registry

ROUNDS = "resamplers.LiuWestResampler.redraw_rounds"
KERNEL = "resamplers.LiuWestResampler.kernel_rounds"


def _rec(**counters):
    return {"spans": {}, "counters": {"smc.steps": 10, **counters}}


@pytest.mark.parametrize("counters,want", [
    ({ROUNDS: 37, KERNEL: 37}, 100.0),
    ({ROUNDS: 40, KERNEL: 10}, 25.0),
    ({ROUNDS: 37}, None),  # a program without the round's counter
    ({KERNEL: 0, ROUNDS: 0}, None),
    ({}, None),
])
def test_redraw_kernel_round_share(counters, want):
    reader = registry.Registry().module("metrics", "redraw_kernel_round_share")
    got = reader.value(_rec(**counters))
    assert got == (None if want is None else pytest.approx(want))
