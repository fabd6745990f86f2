"""The modules behind the specialized recipes against the JAX package: the
capacity, rate and power metrics, taps to subcarriers, channels from taps,
the NYU-Wireless loader, the 4-QAM slicer and the quantizer on the same
numpy inputs; the Gaussian training and the communication-system front end
by construction and by moments."""
import math

import numpy as np
import pytest
import scipy.io
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.channel import nyu as jnyu  # noqa: E402
from jstsp19_tpu.channel import widemmwave as jwm  # noqa: E402
from jstsp19_tpu.core import metrics as jmet  # noqa: E402
from jstsp19_tpu.frontend import modulation as jmod  # noqa: E402
from jstsp19_tpu.frontend import quantizer as jq  # noqa: E402
from jstsp19_torch import interop  # noqa: E402
from jstsp19_torch.channel import nyu, widemmwave as wm  # noqa: E402
from jstsp19_torch.core import metrics, prng  # noqa: E402
from jstsp19_torch.frontend import measurement as ms  # noqa: E402
from jstsp19_torch.frontend import modulation as mod  # noqa: E402
from jstsp19_torch.frontend import quantizer as q  # noqa: E402
from jstsp19_torch.frontend import training as tr  # noqa: E402
from jstsp19_torch.frontend.beamformers import create_beamformer  # noqa: E402


def _c(rng, *s):
    return (rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)


def _low_rank(rng, batch, n, m, r):
    return np.einsum("bnr,brm->bnm", _c(rng, batch, n, r), _c(rng, batch, r, m)).astype(np.complex64)


@pytest.mark.parametrize("shared_w", [True, False])
def test_spectral_efficiency_matches_jax(shared_w):
    """The capacity driver's log-det over a batch of noiseless frames, with a
    shared combiner (31 kept columns, the last 10 zeroed as the Mr mask does)
    and one per realization: rtol 1e-4 (float32 slogdet)."""
    rng = np.random.default_rng(0)
    Y = _c(rng, 6, 32, 5)
    W = _c(rng, 32, 31) if shared_w else _c(rng, 6, 32, 31)
    W[..., 21:] = 0
    nv = 10 ** (-1.5)
    got = metrics.spectral_efficiency(torch.from_numpy(Y), torch.from_numpy(W), nv, 16).numpy()
    want = np.asarray(jmet.spectral_efficiency(jnp.asarray(Y), jnp.asarray(W), nv, 16))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    G = np.swapaxes(W.conj(), -2, -1) @ Y
    np.testing.assert_allclose(metrics.combined_spectral_efficiency(torch.from_numpy(G), nv, 16).numpy(),
                               want, rtol=1e-4)


def test_achievable_rate_matches_jax_and_clamps_the_gram():
    """The rate proxy per realization: at Nr=32 and K=32 with a rank-6 Z̄ the
    Gram's small eigenvalues come out a little negative in float32; both
    packages clamp them at 0, so the rate is finite: rtol 1e-4."""
    rng = np.random.default_rng(1)
    for shape, rank in (((5, 32, 32), 6), ((5, 32, 64), 32)):
        Z = _low_rank(rng, shape[0], shape[1], shape[2], rank)
        e = rng.uniform(0.0, 2.0, shape[0]).astype(np.float32)
        got = metrics.achievable_rate(torch.from_numpy(Z), torch.from_numpy(e), 10 ** (-1.5), 32).numpy()
        want = np.asarray(jax.vmap(lambda z, x: jmet.achievable_rate(z, x, 10 ** (-1.5), 32))(
            jnp.asarray(Z), jnp.asarray(e)))
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_power_model_and_energy_efficiency_match_jax():
    """The power model exactly; EE at rtol 1e-4."""
    for name in ("P_LNA", "P_PS", "P_ZC", "P_SW"):
        assert getattr(metrics, name) == getattr(jmet, name)
    for Nr in (32, 64, 128):
        for Mr in (1, 4, 16, 31):
            assert metrics.power_conventional_hbf(Nr, Mr) == jmet.power_conventional_hbf(Nr, Mr)
            assert metrics.power_conventional_hbf(Nr, Mr, zc=True) == jmet.power_conventional_hbf(Nr, Mr, zc=True)
            assert metrics.power_proposed(Nr, Mr) == jmet.power_proposed(Nr, Mr)
        assert metrics.power_digital_bf(Nr) == jmet.power_digital_bf(Nr)
    cap = np.random.default_rng(2).uniform(0, 40, 11).astype(np.float32)
    np.testing.assert_allclose(metrics.energy_efficiency(torch.from_numpy(cap), metrics.power_proposed(64, 32)).numpy(),
                               np.asarray(jmet.energy_efficiency(cap, jmet.power_proposed(64, 32))), rtol=1e-4)


@pytest.mark.parametrize("K", [4, 6, 9])
def test_taps_to_subcarriers_matches_jax(K):
    """K < L (taps folded modulo K), K = L and K > L (zero-padded), batched
    over two leading dimensions: 1e-5 of the largest entry."""
    rng = np.random.default_rng(K)
    H = _c(rng, 2, 3, 6, 4, 3)
    got = wm.taps_to_subcarriers(torch.from_numpy(H), K).numpy()
    assert got.shape == (2, 3, K, 4, 3)
    for idx in np.ndindex(2, 3):
        want = np.asarray(jwm.taps_to_subcarriers(jnp.asarray(H[idx]), K))
        np.testing.assert_allclose(got[idx], want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # every tap counts: the DC subcarrier is the sum of all L taps
    np.testing.assert_allclose(got[..., 0, :, :], H.sum(axis=-3), rtol=1e-5, atol=1e-5)


def test_channel_from_taps_matches_jax():
    """Z̄ at 1e-5 of the largest entry; empty steering fields (L, 0, Mr) and
    (L, 0, Mt) per realization; the dictionaries as JAX's."""
    rng = np.random.default_rng(3)
    H = _c(rng, 3, 4, 32, 4)
    ch = wm.channel_from_taps(interop.taps_to_torch(H), 32, 8)
    assert ch.Zbar.shape == (3, 32, 32) and ch.Ar.shape == (3, 4, 0, 32) and ch.At.shape == (3, 4, 0, 4)
    for b in range(3):
        want = jwm.channel_from_taps(jnp.asarray(H[b]), 32, 8)
        np.testing.assert_allclose(ch.Zbar[b].numpy(), np.asarray(want.Zbar), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(want.Zbar)).max())
        assert np.asarray(want.Ar).shape == tuple(ch.Ar.shape[1:])
    np.testing.assert_allclose(ch.Dr.numpy(), np.asarray(want.Dr), rtol=1e-5, atol=1e-6)


def test_normalize_taps_matches_jax():
    """Each tap's Frobenius norm becomes sqrt(Nr·Nt): rtol 1e-5 against JAX."""
    H = _c(np.random.default_rng(4), 5, 4, 32, 4) * 3.0
    got = nyu.normalize_taps(torch.from_numpy(H)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnyu.normalize_taps(jnp.asarray(H))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=(-2, -1)), math.sqrt(32 * 4), rtol=1e-5)


def test_load_nyu_taps_reads_what_jax_reads(tmp_path):
    """A ``Hf`` cell array of 3 realizations × 2 taps written with savemat
    loads to the same (3, 2, 8, 4) complex64 array in both packages; no path
    or a missing file gives None; a file without ``Hf`` raises."""
    rng = np.random.default_rng(5)
    cells = np.empty((3, 2), dtype=object)
    for idx in np.ndindex(3, 2):
        cells[idx] = _c(rng, 8, 4).astype(np.complex128)
    path = tmp_path / "nyu.mat"
    scipy.io.savemat(path, {"Hf": cells})
    got = nyu.load_nyu_taps(str(path))
    want = np.asarray(jnyu.load_nyu_taps(str(path)))
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape == (3, 2, 8, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[1, 0].numpy(), cells[1, 0].astype(np.complex64))
    assert nyu.load_nyu_taps(None) is None and nyu.load_nyu_taps(str(tmp_path / "absent.mat")) is None
    scipy.io.savemat(tmp_path / "other.mat", {"H": np.ones(2)})
    with pytest.raises(ValueError, match="no 'Hf'"):
        nyu.load_nyu_taps(str(tmp_path / "other.mat"))


def test_taps_to_torch_checks_its_input():
    H = _c(np.random.default_rng(6), 2, 4, 8, 4)
    t = interop.taps_to_torch(H.astype(np.complex128))
    assert t.dtype == torch.complex64 and tuple(t.shape) == (2, 4, 8, 4)
    with pytest.raises(ValueError, match="complex"):
        interop.taps_to_torch(np.ones((2, 4, 8, 4), np.float32))


def test_qam4_demod_matches_jax_exactly():
    y = _c(np.random.default_rng(7), 4, 50)
    y[0, :4] = [0.0, -0.0, 1j * 0.0, -1.0]  # the quadrant boundaries
    got = mod.qam4_demod(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmod.qam4_demod(jnp.asarray(y))))
    assert got.dtype == np.complex64


@pytest.mark.parametrize("bits", list(range(1, 10)))
def test_quantizer_matches_jax(bits):
    """Quantized value and both cell edges at 1e-6 of the largest entry, the
    step from the RMS over the whole array, bits 1 to 9 (9 takes the
    fallback step)."""
    x = _c(np.random.default_rng(bits), 3, 16, 20) * np.float32(0.7)
    got = q.optimum_uniform_quantizer(torch.from_numpy(x), bits)
    want = jq.optimum_uniform_quantizer(jnp.asarray(x), bits)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())
    np.testing.assert_array_equal(q.OPTIMUM_STEPSIZE, jq.OPTIMUM_STEPSIZE)


def test_quantizer_rejects_bad_bit_counts():
    x = torch.ones(4, dtype=torch.complex64)
    for bits in (0, -1, 2.0):
        with pytest.raises(ValueError, match="positive integer"):
            q.optimum_uniform_quantizer(x, bits)


def test_gaussian_training_frames_by_construction():
    """(batch, L, Nt, T) rows of a Hermitian Toeplitz matrix per antenna:
    constant along diagonals, row 0 the conjugate of column 0; CN(0, 1)
    symbols (mean power within 5% over 16·4·70 draws)."""
    g = prng.role_generator(0, 0, prng.ROLE_TRAINING, "cpu")
    Psi = tr.gaussian_training_frames(g, 4, 70, 6, batch=(16,))
    assert Psi.shape == (16, 6, 4, 70) and Psi.dtype == torch.complex64
    P = Psi.transpose(-3, -2)  # (16, 4, L, T): the first L rows per antenna
    torch.testing.assert_close(P[..., 1:, 1:], P[..., :-1, :-1], rtol=0, atol=0)
    torch.testing.assert_close(P[..., 0, 1:6], P[..., 1:6, 0].conj(), rtol=0, atol=0)
    assert abs(float((P[..., 0, :].abs() ** 2).mean()) - 1.0) < 0.05


def test_comm_system_training_by_construction():
    """Exactly Lr = round(0.75·32) = 24 ones per column of Ω; Y_p = Ω∘Y_conv;
    W the FFT combiner; Psi the Gaussian frames of the training role; and
    Y_conv − Wᴴ·ΣH_lΨ_l = Wᴴ·N is CN(0, σ²) (W is unitary): mean within
    0.02·σ, each part's variance within 5% of σ²/2, over 32·32·70 samples."""
    gens = prng.realization_generators(3, 0, "cpu")
    H = torch.from_numpy(_c(np.random.default_rng(8), 32, 4, 32, 4))
    nv = 0.3
    Yp, Yc, W, Omega, Lr, Psi = ms.comm_system_training(gens, H, 70, nv, 0.75)
    assert Lr == 24 and Yp.shape == Yc.shape == Omega.shape == (32, 32, 70) and Psi.shape == (32, 4, 4, 70)
    assert bool((Omega.sum(dim=-2) == Lr).all()) and set(Omega.unique().tolist()) == {0.0, 1.0}
    torch.testing.assert_close(Yp, Omega * Yc, rtol=0, atol=0)
    torch.testing.assert_close(W, create_beamformer(32, "fft"))
    again = tr.gaussian_training_frames(prng.realization_generators(3, 0, "cpu")[prng.ROLE_TRAINING], 4, 70, 4,
                                        batch=(32,))
    torch.testing.assert_close(Psi, again, rtol=0, atol=0)
    noise = (Yc - W.mH @ torch.einsum("...lmn,...lnt->...mt", H, Psi)).flatten()
    assert abs(complex(noise.mean())) < 0.02 * math.sqrt(nv)
    for part in (noise.real, noise.imag):
        assert abs(float(part.var()) / (nv / 2) - 1.0) < 0.05
