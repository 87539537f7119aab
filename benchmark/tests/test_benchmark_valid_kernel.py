"""The reader of ``valid_kernel_row_share`` on hand-made recordings: the
share of the tested rows that the validity kernel took, and nothing where
the program has no such counter or tested nothing."""

import pytest

import _paths  # noqa: F401
from harness import registry

TESTED = "resamplers.LiuWestResampler.tested_rows"
KERNEL = "ops.psd_valid.rows"


def _rec(**counters):
    return {"spans": {}, "counters": {"smc.steps": 10, **counters}}


@pytest.mark.parametrize("counters,want", [
    ({TESTED: 12000, KERNEL: 12000}, 100.0),
    ({TESTED: 12000, KERNEL: 6000}, 50.0),
    ({TESTED: 12000}, None),  # a program without the kernel
    ({KERNEL: 0, TESTED: 0}, None),
    ({}, None),
])
def test_valid_kernel_row_share(counters, want):
    reader = registry.Registry().module("metrics", "valid_kernel_row_share")
    got = reader.value(_rec(**counters))
    assert got == (None if want is None else pytest.approx(want))
