"""Operation and byte counts of the hand kernels, checked by hand at tiny
shapes, and the roofline share's arithmetic."""
import pytest

from portbench.roofline import counts, peaks


def test_param_score_bytes_at_the_exact_engines_shape():
    # 256 lanes x 16 nodes x 8 GPU slots: pods 256*16, free CPU, memory
    # and GPU count 3*256*16*4, free milli 256*16*8*4, weights 256*64,
    # scores 256*64; shared totals 3*64, mask 16, capacity 512, mask 128
    assert counts.param_score_bytes(256, 16, 8) == 217_936


def test_param_score_by_hand():
    # one lane, one node, one GPU slot: pod 16, node 12, slot 4,
    # weights 64, score 4; shared totals 12, mask 1, capacity 4, mask 1
    assert counts.param_score_bytes(1, 1, 1) == 16 + 12 + 4 + 64 + 4 + 18
    assert counts.param_score_ops(2, 3) == 2 * 3 * 32


def test_fused_sim_by_hand():
    # P=1, Q=2, N=1, G=1, K=3: in 64 + 8 + 64 + 12 + 24 + 8,
    # out 8 + 12 + 4 + 64
    assert counts.fused_sim_bytes(1, 2, 1, 1, 3) == 180 + 88
    assert counts.fused_sim_ops(10, 16) == 10 * 16 * 32


def test_roofline_share():
    # 3.35e9 bytes in one second: 0.1% of the memory peak
    assert peaks.roofline_pct(0, 3.35e9, 1.0) == pytest.approx(0.1)
    # 67e9 operations in one millisecond: the float32 peak
    assert peaks.roofline_pct(67e9, 0, 1e-3) == pytest.approx(100.0)
    # the larger bound counts
    assert peaks.roofline_pct(67e9, 3.35e9, 1.0) == pytest.approx(0.1)
