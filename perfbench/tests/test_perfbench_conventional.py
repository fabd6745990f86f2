"""The conventional baselines in the check: the plain reference's front end, LS, MMV-OMP and VAMP against the
port's, its factored LMMSE against a dense Φ, and whole runs of a small cell of the whole errorVSsnr figure (the
proposed pair on the fused route beside LS, VAMP and MMV-OMP): a sound run is correct, the control and each
planted fault are not, and baselines at VAMP settings the reference lacks are refused before any point runs."""
import collections
import dataclasses
import time

import pytest
import torch
from test_perfbench_run import _HostEvent

from perfbench import bench, check, reference, trace
from perfbench.reference.conventional import Kron
from perfbench.reference.frontend import Products
from perfbench.system import Control, Port
from perfbench.traffic import Schedule

SEED = 2**31 + 12345
FIGURE = ["ls", "vamp", "omp_mmv", "proposed", "proposed_angles"]  # the port's DEFAULT_METHODS
VAMP = dict(vamp_nit=100, vamp_damp=0.85, vamp_true_noise=False, vamp_normal_eq=True)
# the conventional branch's limits of the tiny figure cell, from its own readings: the program's largest over 12
# seeds and the control's (for vamp_mean_nmse_gap the half-VAMP fault's) smallest over 3 (PERF.md section 2)
TINY_FIGURE_LIMITS = dict(conv_frontend_rel_err=3e-5, baseline_s_rel_err=1e-4, vamp_s_min_rel_err=2e-5,
                          vamp_mean_nmse_gap=0.1, baseline_nmse_gap=1e-4)


def canonical(**changes):
    from jstsp19_torch.harness.pipeline import PointConfig

    pc = PointConfig(methods=tuple(FIGURE), svt_method="fused", **changes)
    return pc, {f.name: getattr(pc, f.name) for f in dataclasses.fields(pc)}


def port_problem(pc, noise_var, batch, seed=2**31 + 7, k=2):
    from jstsp19_torch.core import prng
    from jstsp19_torch.harness import pipeline

    return pipeline.conventional_problem(prng.realization_generators(seed, k, "cpu"), pc, noise_var, batch)


def rel(S, S_ref):
    """Per realization max|S − S_ref| over max|S_ref|."""
    return (S - S_ref).abs().amax(dim=(-2, -1)) / S_ref.abs().amax(dim=(-2, -1))


@pytest.mark.parametrize("beamformer", ["ZC", "fft"])
def test_the_references_conventional_front_end_agrees_with_the_ports(beamformer):
    """1e-5 of each quantity's largest entry: the same float32 products, summed in another order."""
    pc, point = canonical(beamformer=beamformer)
    seed, k, nv, batch = 2**31 + 99, 7, 10 ** -0.5, 8
    prob = port_problem(pc, nv, batch, seed, k)
    ref = reference.conventional_problem(point, nv, batch, seed, k, "cpu")
    assert prob["Y_c"].shape == (batch, pc.Nr, pc.T_hbf) and ref["B_c"].shape == (batch, pc.L * pc.Gt, pc.T_hbf)
    for key in check.CONVENTIONAL_KEYS:
        assert float((prob[key] - ref[key]).abs().max() / ref[key].abs().max()) < 1e-5, key


@pytest.mark.parametrize("method,changes", [("ls", {}), ("omp_mmv", {}), ("omp_mmv", {"num_nonzero": 12})],
                         ids=["ls", "omp_mmv_saturated", "omp_mmv_greedy"])
@pytest.mark.parametrize("snr_db", [-15, 0, 15])
def test_the_references_ls_and_mmv_omp_agree_with_the_ports(method, changes, snr_db):
    """Per realization 1e-4 of the largest entry (read ≤ 1.4e-5): both are a least-squares fit through float32
    SVDs or solves of the same well-conditioned matrices; greedy MMV-OMP picks the same atoms, whose scores are
    far apart against rounding."""
    from jstsp19_torch.harness import pipeline

    pc, point = canonical(**changes)
    prob = port_problem(pc, 10 ** (-snr_db / 10), 8)
    Y_c, A_c, B_c = prob["Y_c"], prob["A_c"], prob["B_c"]
    if method == "ls":
        S = pipeline.ls_estimate(Y_c, A_c, B_c)
    else:
        S = pipeline.omp_mmv(A_c, Y_c @ pipeline.pinv(B_c), min(pc.num_nonzero, pc.Gr)).x
    assert float(rel(S, reference.solve(prob, point, method)).max()) < 1e-4


def _vamp(prob, pc, nit):
    from jstsp19_torch.harness import pipeline

    Y_c, A_c, B_c = prob["Y_c"], prob["A_c"], prob["B_c"]
    return pipeline.vamp_mmwave(Y_c @ B_c.mH, A_c, B_c @ B_c.mH, 1.0, pc.num_nonzero, nit=nit, damp=pc.vamp_damp)


@pytest.mark.parametrize("snr_db", [0, 15])
def test_the_references_vamp_agrees_with_the_ports_over_its_first_iterations(snr_db):
    """Five iterations: per realization 1e-3 of the largest entry (read ≤ 5.3e-5): float32 rounding, which VAMP
    at the script's noise variance 1 amplifies from iteration to iteration."""
    pc, point = canonical()
    prob = port_problem(pc, 10 ** (-snr_db / 10), 8)
    S_ref = reference.solve(prob, dict(point, vamp_nit=5), "vamp")
    assert float(rel(_vamp(prob, pc, 5), S_ref).max()) < 1e-3


def test_the_references_vamp_agrees_with_the_ports_where_it_settles():
    """A hundred iterations, as the figure runs: by then rounding has decided the path on most realizations, in
    the port and in the reference alike (here up to 0.18 apart), and the check holds the smallest gap of the
    point, a realization where VAMP settled before rounding took over; 1e-4 (read 1.3e-5 on 8 realizations)."""
    pc, point = canonical()
    prob = port_problem(pc, 1.0, 8)
    assert float(rel(_vamp(prob, pc, 100), reference.solve(prob, point, "vamp")).min()) < 1e-4


@pytest.mark.parametrize("n_out,Gr,K", [(6, 6, 4), (7, 5, 3), (4, 6, 3)])
def test_the_factored_lmmse_is_the_dense_one(n_out, Gr, K):
    """The LMMSE stage in the factors' SVD bases against Φ = kron(Fᵀ, A) formed densely, in float64: x2 solves
    (ΦᴴΦ + ratio·I)·x2 = Φᴴ·p2 + ratio·r2, z2 = Φ·x2, alpha = tr(ΦᴴΦ·(ΦᴴΦ + ratio·I)⁻¹) / (Gr·K)."""
    gen = torch.Generator().manual_seed(n_out * 100 + Gr * 10 + K)
    cdt = torch.complex128

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=cdt)

    A, Bf = randn(2, n_out, Gr), randn(2, K, K)
    F = Bf @ Bf.mH
    r2, p2 = randn(2, Gr, K), randn(2, n_out, K)
    ratio = torch.tensor([0.3, 2.0], dtype=torch.float64)[:, None, None]
    phi = Kron(A, F, Products())
    x2, z2, alpha = phi.lmmse(r2, p2, ratio)
    for b in range(2):
        As, Fs = A[b] / torch.linalg.matrix_norm(A[b], 2), F[b] / torch.linalg.matrix_norm(F[b], 2)
        dense = torch.kron(Fs.mT.contiguous(), As)  # vec(A·X·F) = kron(Fᵀ, A)·vec(X), vec stacking columns

        def vec(X):
            return X.mT.reshape(-1)

        gram = dense.mH @ dense + ratio[b, 0, 0] * torch.eye(Gr * K, dtype=cdt)
        x = torch.linalg.solve(gram, dense.mH @ vec(p2[b]) + ratio[b, 0, 0] * vec(r2[b]))
        torch.testing.assert_close(vec(x2[b]), x, rtol=0, atol=1e-10)
        torch.testing.assert_close(vec(z2[b]), dense @ x, rtol=0, atol=1e-10)
        a = torch.trace(dense.mH @ dense @ torch.linalg.inv(gram)).real / (Gr * K)
        assert abs(float(alpha[b]) - float(a)) < 1e-10
    assert torch.allclose(phi.scale[:, 0, 0], torch.linalg.matrix_norm(A, 2) * torch.linalg.matrix_norm(F, 2))


@pytest.fixture
def figure_cell(tiny_cell):
    """The tiny cell with every method of the figure: the proposed pair on the fused route, LS, VAMP and
    MMV-OMP (greedy: 6 atoms of 8), two SNR points of 256 realizations, enough for VAMP's smallest gap and mean
    NMSE to settle (at 8 the program's mean gap read up to 0.17, its smallest gap up to 1.5e-5)."""
    tiny_cell.name = "tiny_figure"
    tiny_cell.config["point"].update(num_nonzero=6, **VAMP)
    tiny_cell.config["sweep"] = {"snr_db": [0, 6]}
    tiny_cell.traffic = dict(tiny_cell.traffic, methods=FIGURE, n_mc=256)
    tiny_cell.limits = dict(tiny_cell.limits, **TINY_FIGURE_LIMITS)
    return tiny_cell


def run(cell, system_cls, device="cpu", seconds=0.3, traced=False):
    return bench.run_cell(cell, system_cls(device, SEED), SEED, seconds, traced, time.time())


def test_a_sound_run_of_the_figure_is_correct(figure_cell):
    result = run(figure_cell, Port)
    assert result["correct"], result["checks"]
    assert list(result["checks"]) == list(check.NUMBERS + check.BASELINE_NUMBERS)
    assert result["failed"] == 0 and result["attempted"] % figure_cell.traffic["n_mc"] == 0


def test_a_cell_of_the_proposed_pair_compares_the_six_numbers_alone(tiny_cell):
    assert list(run(tiny_cell, Port)["checks"]) == list(check.NUMBERS)


def test_the_control_of_the_figure_is_not_correct_on_the_conventional_branch(figure_cell):
    """The reference with TF32 products in the program's place."""
    checks = run(figure_cell, Control)["checks"]
    assert any(checks[key]["value"] > checks[key]["limit"] for key in check.BASELINE_NUMBERS), checks


def _vamp_unchanged(monkeypatch):
    """VAMP returns its starting state, r1 = 1e-7j."""
    from jstsp19_torch.harness import pipeline

    def vamp(Y_hbf, A, B, *args, **kwargs):
        return torch.full((Y_hbf.shape[0], A.shape[-1], B.shape[-2]), 1e-7j, dtype=Y_hbf.dtype)

    monkeypatch.setattr(pipeline, "vamp_mmwave", vamp)


def _vamp_half_the_batch(monkeypatch):
    """VAMP solves the first half of the batch and leaves the rest at its starting state."""
    from jstsp19_torch.harness import pipeline

    exact = pipeline.vamp_mmwave

    def half(*args, **kwargs):
        x = exact(*args, **kwargs).clone()
        x[x.shape[0] // 2:] = 1e-7j
        return x

    monkeypatch.setattr(pipeline, "vamp_mmwave", half)


def _ls_half_missing(monkeypatch):
    """The point answers LS for half of its realizations only."""
    from jstsp19_torch.harness import runner

    whole = runner.realization_errors

    def half(*args, **kwargs):
        out = whole(*args, **kwargs)
        if "ls" in out:
            out["ls"] = out["ls"][: out["ls"].shape[0] // 2]
        return out

    monkeypatch.setattr(runner, "realization_errors", half)


def _omp_answer_scaled(monkeypatch):
    """One realization's MMV-OMP estimate is scaled by 1.01 where it is made."""
    from jstsp19_torch.harness import pipeline

    exact = pipeline.omp_mmv

    def scaled(*args, **kwargs):
        res = exact(*args, **kwargs)
        x = res.x.clone()
        x[-1] = x[-1] * 1.01
        return res._replace(x=x)

    monkeypatch.setattr(pipeline, "omp_mmv", scaled)


@pytest.mark.parametrize("fault", [_vamp_unchanged, _vamp_half_the_batch, _ls_half_missing, _omp_answer_scaled])
def test_a_fault_in_a_baseline_makes_the_figure_not_correct(figure_cell, monkeypatch, fault):
    fault(monkeypatch)
    result = run(figure_cell, Port)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("change,named", [
    ({"vamp_nit": None}, "vamp_nit"), ({"vamp_damp": None}, "vamp_damp"),
    ({"vamp_true_noise": True}, "vamp_true_noise True"), ({"vamp_normal_eq": False}, "vamp_normal_eq False"),
])
def test_baselines_at_vamp_settings_the_reference_lacks_are_refused(figure_cell, change, named):
    point = figure_cell.config["point"]
    for key, value in change.items():
        if value is None:
            del point[key]
        else:
            point[key] = value
    with pytest.raises(ValueError, match=named):
        run(figure_cell, Port)


def test_the_figures_spans_time_each_baseline_and_restore_the_program(figure_cell, monkeypatch):
    from jstsp19_torch.harness import pipeline

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    names = ("ls_estimate", "vamp_mmwave", "omp_mmv")
    before = [getattr(pipeline, name) for name in names]
    schedule = Schedule(figure_cell.config, figure_cell.traffic)
    port, spans = Port("cpu", SEED), []
    with trace.spans(spans):
        for pt, _ in zip(schedule.window(), range(2)):
            port.run_point(pt)
    assert [getattr(pipeline, name) for name in names] == before
    counts = collections.Counter(s.name for s in spans)
    # the conventional branch's draws (``realization_errors``' ``point_draws``) are a ``draws`` span
    assert counts == {"frontend": 2, "fused_admm": 4, "draws": 2, "ls_estimate": 2, "vamp_mmwave": 2, "omp_mmv": 2}
    assert all(s.attrs == {"B": figure_cell.traffic["n_mc"]} for s in spans if s.name in names)


@pytest.mark.cuda
def test_the_figure_on_the_card(figure_cell):
    """Correct and traced on the card, and the control not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = run(figure_cell, Port, "cuda", traced=True)
    assert result["correct"], result["checks"]
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert not run(figure_cell, Control, "cuda")["correct"]
