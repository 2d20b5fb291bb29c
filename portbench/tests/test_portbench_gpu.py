"""The tiny cells on the card (skipped where there is none): the program's
kernels against the plain reference, and a traced window that reads device
time."""

from __future__ import annotations

import pytest

from portbench import run

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("workload", ["shard_i32_cold", "shard_i16_deep_warm",
                                      "search_i32_b64"])
def test_tiny_cell_on_the_card(tiny, card, workload):
    bench, base = tiny
    res = run.run_cell(bench, workload, 2**31 + 5, 1.0, True, device=card,
                       root="/", base=base)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
