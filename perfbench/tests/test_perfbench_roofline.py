"""The fused ADMM's operation and byte counts and its least time."""
import pytest

from perfbench import roofline

CANONICAL = dict(B=256, N=32, M=140, Gr=32, K=16, Imax=100)
# errorVSnt's shapes: (M, K) = (T·Nt, L·Gt) at Nt = 4, 6, 8, 12, 16
NT_SHAPES = [(140, 16), (210, 24), (280, 32), (420, 48), (400, 64)]
NT_BOUNDS_MS = [1.575, 2.618, 3.904, 7.210, 8.731]


def test_canonical_count_and_bound():
    assert roofline.admm_flops(**CANONICAL) / 1e9 == pytest.approx(105.5, abs=0.05)
    assert roofline.admm_bound_s(**CANONICAL) * 1e3 == pytest.approx(1.575, abs=5e-4)
    # bound by the operations: the bytes take far less
    assert roofline.admm_bytes(256, 32, 140, 32, 16, rank=True) / roofline.HBM_BYTES_PER_S < 1e-4


def test_bytes_count_each_input_and_output_once():
    B, N, M, Gr, K = 2, 4, 6, 8, 3
    inputs = 8 * N * M + 4 * N * M + 8 * N * Gr + 8 * K * M + 12
    assert roofline.admm_bytes(B, N, M, Gr, K) == B * (inputs + 8 * Gr * K + 8 * N * M)
    assert roofline.admm_bytes(B, N, M, Gr, K, rank=True) - roofline.admm_bytes(B, N, M, Gr, K) == B * 4 * Gr * K


@pytest.mark.parametrize("i", range(len(NT_SHAPES)))
def test_errorvsnt_bounds(i):
    M, K = NT_SHAPES[i]
    assert roofline.admm_bound_s(256, 32, M, 32, K, 100) * 1e3 == pytest.approx(NT_BOUNDS_MS[i], abs=5e-4)


def test_a_sweeps_bound_is_the_sum_over_its_shapes():
    calls = [dict(B=256, N=32, M=M, Gr=32, K=K, Imax=100, rank=r) for M, K in NT_SHAPES for r in (False, True)]
    total = roofline.sweep_bound_s(calls)
    assert total == pytest.approx(sum(roofline.admm_bound_s(**c) for c in calls))
    assert total * 1e3 == pytest.approx(2 * sum(NT_BOUNDS_MS), abs=5e-3)
    assert roofline.sweep_bound_s([]) == 0.0
