"""The port's frontend/ (modulation, training, beamformers, measurement)
against the JAX package: deterministic functions on the same numpy inputs,
random ones by construction and by moments."""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.frontend import beamformers as jbf  # noqa: E402
from jstsp19_tpu.frontend import measurement as jms  # noqa: E402
from jstsp19_tpu.frontend import training as jtr  # noqa: E402
from jstsp19_torch.core import prng  # noqa: E402
from jstsp19_torch.frontend import beamformers as bf  # noqa: E402
from jstsp19_torch.frontend import measurement as ms  # noqa: E402
from jstsp19_torch.frontend import modulation as mod  # noqa: E402
from jstsp19_torch.frontend import training as tr  # noqa: E402


def _c(rng, *s):
    return (rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)


@pytest.mark.parametrize("kind", ["ZC", "fft", "ps", "quantized_4", "quantized"])
@pytest.mark.parametrize("N", [32, 128])
def test_deterministic_beamformers_match_jax(kind, N):
    got = bf.create_beamformer(N, kind).numpy()
    np.testing.assert_allclose(got, np.asarray(jbf.create_beamformer(N, kind)), rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=0), 1.0, rtol=1e-5)


def test_random_beamformers_by_construction():
    g = prng.role_generator(0, 0, prng.ROLE_BEAMFORMER, "cpu")
    W = bf.create_beamformer(16, "rand", gen=g) * math.sqrt(16)
    assert set(np.round(W.numpy().ravel(), 5).tolist()) <= {1, -1, 1j, -1j}
    Wp = bf.create_beamformer(16, "rand_ps", gen=g).numpy()
    np.testing.assert_allclose(np.abs(Wp), 1 / 4, rtol=1e-5)
    with pytest.raises(ValueError):
        bf.create_beamformer(16, "rand")
    with pytest.raises(ValueError):
        bf.create_beamformer(16, "nope")


def test_toeplitz_rows_match_jax():
    s = _c(np.random.default_rng(0), 3, 4, 140)
    got = tr._toeplitz_rows(torch.from_numpy(s), 4).numpy()
    np.testing.assert_allclose(got, np.asarray(jtr._toeplitz_rows(jnp.asarray(s), 4)), rtol=1e-5)


def test_qam4_training_frames_by_construction():
    """Unit-energy 4-QAM symbols, uniform over the alphabet, in Hermitian
    Toeplitz rows: Psi[l, k, t] = s_k[l−t] (l ≥ t) or conj(s_k[t−l])."""
    g = prng.role_generator(0, 0, prng.ROLE_TRAINING, "cpu")
    Psi = tr.qam4_training_frames(g, 4, 140, 4, batch=(64,))
    assert Psi.shape == (64, 4, 4, 140) and Psi.dtype == torch.complex64
    np.testing.assert_allclose(Psi.abs().numpy(), 1.0, rtol=1e-6)
    s = Psi[:, 0]  # row 0 holds conj(s[t]) for t ≥ 0; row l>0 shifts it
    torch.testing.assert_close(Psi[:, 1, :, 1:], s[..., :-1])
    syms = torch.from_numpy(mod.QAM4_ALPHABET)
    counts = torch.stack([(s == a).sum() for a in syms]).double()
    n = float(counts.sum())
    assert torch.all((counts / n - 0.25).abs() < 5 * math.sqrt(0.25 * 0.75 / n))


def test_awgn_moments():
    g = prng.role_generator(0, 0, prng.ROLE_NOISE, "cpu")
    nv = 0.1
    z = tr.awgn(g, 32, 140, nv, batch=(64,)).to(torch.complex128)
    assert z.shape == (64, 32, 140)
    assert abs(float((z.abs() ** 2).mean()) - nv) < 5 * nv / math.sqrt(z.numel())


def test_received_frame_and_hbf_match_jax():
    rng = np.random.default_rng(2)
    H, Psi, N = _c(rng, 2, 4, 32, 4), _c(rng, 2, 4, 4, 60), _c(rng, 2, 32, 60)
    W = np.asarray(jbf.create_beamformer(32, "ZC"))
    got = ms.received_frame(*map(torch.from_numpy, (H, Psi, N))).numpy()
    want = np.asarray(jax.vmap(jms.received_frame)(H, Psi, N))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    Y, Wc = ms.hbf(torch.from_numpy(H), torch.from_numpy(N), torch.from_numpy(Psi), 4, torch.from_numpy(W.copy()))
    Yj = np.asarray(jax.vmap(lambda h, n, p: jms.hbf(h, n, p, 4, W)[0])(H, N, Psi))
    np.testing.assert_allclose(Y.numpy(), Yj, rtol=1e-5)
    assert Wc.shape == (32, 4)


def test_sample_omega_keeps_exactly_mr_per_column():
    g = prng.role_generator(0, 0, prng.ROLE_MASK, "cpu")
    Om = ms.sample_omega(g, 32, 4, 140, batch=(16,))
    assert Om.shape == (16, 32, 140) and Om.dtype == torch.float32
    assert torch.all(Om.sum(dim=-2) == 4)
    assert set(Om.unique().tolist()) <= {0.0, 1.0}
    # every output is observed with probability Mr/Mr_e
    rate = Om.double().mean(dim=(0, 2))
    assert torch.all((rate - 4 / 32).abs() < 5 * math.sqrt((4 / 32) * (28 / 32) / (16 * 140)))
    # same as JAX's construction: the mask of a stable double argsort
    scores = torch.rand(140, 32, generator=prng.role_generator(9, 0, 3, "cpu"))
    ranks = np.argsort(np.argsort(scores.numpy(), axis=-1, kind="stable"), axis=-1, kind="stable")
    mine = ms.sample_omega(prng.role_generator(9, 0, 3, "cpu"), 32, 4, 140).numpy()
    np.testing.assert_array_equal(mine, (ranks < 4).astype(np.float32).T)


def test_proposed_hbf_is_masked_combined_frame():
    rng = np.random.default_rng(3)
    H, Psi, N = (torch.from_numpy(x) for x in (_c(rng, 2, 4, 32, 4), _c(rng, 2, 4, 4, 140), _c(rng, 2, 32, 140)))
    W = bf.create_beamformer(32, "ZC")
    obs = ms.proposed_hbf(prng.role_generator(0, 0, prng.ROLE_MASK, "cpu"), H, N, Psi, 32, 4, W)
    torch.testing.assert_close(obs.Y_full, W.mH @ ms.received_frame(H, Psi, N))
    torch.testing.assert_close(obs.Y, obs.Omega * obs.Y_full)
    assert torch.all(obs.Omega.sum(dim=-2) == 4)
