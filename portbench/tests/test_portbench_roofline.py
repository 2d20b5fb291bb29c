"""The roofline arithmetic against the port's kernel table (PERF.md): each
kernel's bound at the table's shapes."""

from __future__ import annotations

import pytest

from portbench import roofline as rl

TILE = 2048 * 2048


@pytest.mark.parametrize("what, got, want_ms", [
    ("APPEND 10 tiles P = 3", lambda: rl.append_bound_s(10 * TILE, 3, 2048),
     0.260),
    ("APPEND 10 tiles P = 6", lambda: rl.append_bound_s(10 * TILE, 6, 2048),
     0.521),
    ("COUNT 16 tiles P = 3", lambda: rl.count_bound_s(16 * TILE, 3, 2048),
     0.417),
    ("COUNT 16 tiles P = 6", lambda: rl.count_bound_s(16 * TILE, 6, 2048),
     0.833),
    ("SCORE 256 x 262,144 P = 3",
     lambda: rl.score_bound_s(3, 262144, 2048, 256), 0.562),
    ("K 256 x 262,144 scores", lambda: rl.select_bound_s(256, 262144),
     0.0801),
    ("G 8,192 x 16,384 chunk", lambda: rl.gram_bound_s(8192, 16384, 2080),
     0.564),
    ("P 32,768 sets x 256 hashes",
     lambda: rl.projection_bound_s(32768 * 256, 32768, 2048), 0.1765),
])
def test_bound_matches_the_kernel_table(what, got, want_ms):
    assert got() * 1e3 == pytest.approx(want_ms, rel=5e-3), what


def test_shard_pairs_count_the_triangle_and_the_rest():
    # 3 rows of a 10-row db: 6 pairs inside (with the diagonal), 21 outside
    assert rl.shard_pairs(3, 10) == 6 + 21
    # one shard of every row: the whole triangle
    assert rl.shard_pairs(10, 10) == 55


def test_share_is_none_without_a_measurement():
    assert rl.share_pct(1.0, 0.0) is None
    assert rl.share_pct(1.0, 2.0) == pytest.approx(50.0)
