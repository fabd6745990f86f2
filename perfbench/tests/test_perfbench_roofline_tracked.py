"""The tracked ADMM's operation count and least time at any N and M
(``perfbench/roofline_tracked.py``): ``roofline.py``'s exactly where N ≤ M,
the SVT on the thin side where N > M, and the reader of its share."""
import pytest

from perfbench import bench, cells, roofline, roofline_tracked, trace

# the fused cells' shapes, N = 32 ≤ M: errorVSsnr's canonical point and errorVSnt's five (M, K)
FUSED_SHAPES = [(140, 16), (210, 24), (280, 32), (420, 48), (400, 64)]
NRF = dict(B=10000, N=32, M=20, Gr=32, K=16, Imax=100)  # errorVSnrf's point: N > M


@pytest.mark.parametrize("rank", [False, True], ids=["proposed", "proposed_angles"])
@pytest.mark.parametrize("M,K", FUSED_SHAPES, ids=[f"M{M}_K{K}" for M, K in FUSED_SHAPES])
def test_for_n_at_most_m_the_count_and_bound_are_the_fused_kernels(M, K, rank):
    shapes = dict(B=256, N=32, M=M, Gr=32, K=K, Imax=100)
    assert roofline_tracked.admm_flops(**shapes) == roofline.admm_flops(**shapes)
    assert roofline_tracked.admm_bound_s(**shapes, rank=rank) == roofline.admm_bound_s(**shapes, rank=rank)


def test_the_svt_forms_are_roofline_pys():
    """At N ≤ M the SVT term is what ``roofline.admm_flops`` counts inline:
    the rest of its count does not move with the term."""
    for N, M in [(32, 140), (20, 32), (8, 12)]:
        rest = roofline.admm_flops(1, N, M, 32, 16, 1) / 8 - roofline_tracked.svt_macs(N, M)
        assert rest == N * 32 * 16 + N * 16 * M + min(N * 16 * M + 32 * N * 16, 32 * N * M + 32 * M * 16) \
            + 2 * (32 * 32 * 16 + 32 * 16 * 16)


def test_for_n_over_m_the_svt_is_counted_on_the_thin_side():
    B, N, M, Gr, K, Imax = (NRF[k] for k in ("B", "N", "M", "Gr", "K", "Imax"))
    thin, fat = roofline_tracked.svt_macs(M, N), roofline_tracked.svt_macs(N, M)
    assert thin == 28640 < fat == 45248  # the P form on either side: 2·20²·32 + 10·(7·32 + 80) against 2·32²·20 + ...
    got = roofline_tracked.admm_flops(**NRF)
    assert got == roofline.admm_flops(**NRF) - 8.0 * Imax * B * (fat - thin)
    assert got == 8.0 * 131040 * Imax * B  # 1,048.32 GFLOP a call
    # bound by the operations, at 67 TFLOP/s: 15.65 ms a call, the bytes (297 MB) taking 0.09 ms
    assert roofline_tracked.admm_bound_s(**NRF, rank=True) * 1e3 == pytest.approx(15.6466, abs=1e-4)
    assert roofline.admm_bytes(B, N, M, Gr, K, rank=True) / roofline.HBM_BYTES_PER_S < 1e-4


def test_a_sweeps_bound_is_the_sum_over_its_calls():
    calls = [dict(NRF, rank=False), dict(NRF, rank=True), dict(NRF, N=8, M=6, Gr=8, K=4, rank=True)]
    assert roofline_tracked.sweep_bound_s(calls) == pytest.approx(sum(roofline_tracked.admm_bound_s(**c)
                                                                       for c in calls))
    assert roofline_tracked.sweep_bound_s([]) == 0.0


def test_the_share_reads_the_tracked_solves_alone():
    bound = roofline_tracked.admm_bound_s(**NRF)
    spans = [trace.Span("tracked_admm", 10 * bound, dict(NRF, rank=False)),
             trace.Span("tracked_admm", 10 * bound, dict(NRF, rank=True)),
             trace.Span("fused_admm", 1.0, dict(NRF, N=32, M=140, rank=False)),
             trace.Span("frontend", 1.0, {})]
    read = cells.reader("tracked_admm_roofline")
    assert read(bench.Record(0.0, 1.0, [], spans, None)) == pytest.approx(10.0)
    assert read(bench.Record(0.0, 1.0, [], spans[2:], None)) is None
