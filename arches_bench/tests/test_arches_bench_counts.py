"""The frozen operation and byte counts against values worked by hand."""

import pytest

from arches_bench import counts


def test_mmse_interp_by_hand():
    # n_prb 1: 12 subcarriers, 6 pilots; 2 rows: 2 x 6 x 12 complex MACs
    flops, nbytes = counts.mmse_interp(1, 2)
    assert flops == 8 * 2 * 6 * 12
    assert nbytes == 8 * (2 * 6 + 6 * 12 + 2 * 12)


def test_ai_expert_by_hand():
    # n_prb 1 (6 pilots), 1 antenna, 1 DMRS symbol (1 in-range symbol pair),
    # 1 channel, no residual block: stem 2->1, up 1->2 on 6 pilots, head 1->2 on 12
    flops, nbytes = counts.ai_expert(1, 1, 1, 1, 0, 1)
    assert flops == 2 * 3 * 1 * (1 * 2 * 6 + 2 * 1 * 6 + 2 * 1 * 12)
    weights = (1 * 2 * 9 + 1) + (2 * 1 * 9 + 2) + (2 * 1 * 9 + 2)
    assert nbytes == 1 * 1 * (6 + 12) * 8 + weights * 4


def test_ai_expert_at_the_cells_width():
    # 32 channels x 4 blocks, n_prb 106, 4 antennas, 3 DMRS symbols: 1.115 GFLOP a UE
    flops, _ = counts.ai_expert(106, 4, 3, 32, 4, 1)
    assert flops == pytest.approx(1.115e9, rel=1e-3)


def test_bound_takes_the_slower_roof():
    assert counts.bound_s(counts.PEAK_TF32_FLOPS, 0.0) == pytest.approx(1.0)
    assert counts.bound_s(0.0, counts.PEAK_BYTES_PER_S * 2) == pytest.approx(2.0)
