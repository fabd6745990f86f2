"""The port's channel/widemmwave.py against the JAX package.

Deterministic functions take the same numpy inputs in both packages; the
random generator is held by construction and by ensemble moments (the
port's torch generators draw other numbers than JAX's keys).
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.channel import widemmwave as jch  # noqa: E402
from jstsp19_tpu.core import prng as jprng  # noqa: E402
from jstsp19_torch import interop  # noqa: E402
from jstsp19_torch.channel import widemmwave as ch  # noqa: E402
from jstsp19_torch.core import prng  # noqa: E402

CANON = dict(L=4, Mr=32, Mt=4, n_clusters=2, n_rays=3, Gr=32, Gt=4)


@pytest.mark.parametrize("M,G", [(32, 32), (4, 4), (16, 8)])
def test_dft_dictionary_matches_jax(M, G):
    np.testing.assert_allclose(
        ch.dft_dictionary(M, G).numpy(), np.asarray(jch.dft_dictionary(M, G)), rtol=1e-5)


def test_ula_steering_matches_jax_on_same_angles():
    phi = np.random.default_rng(0).uniform(-math.pi, math.pi, (3, 6)).astype(np.float32)
    got = ch.ula_steering(torch.from_numpy(phi), 32).numpy()
    np.testing.assert_allclose(got, np.asarray(jch.ula_steering(jnp.asarray(phi), 32)), rtol=1e-5)
    # the +j sign: phase of element 1 is +pi·sin(phi)
    np.testing.assert_allclose(np.angle(got[0, 0, 1]), np.angle(np.exp(1j * math.pi * np.sin(phi[0, 0]))), atol=1e-5)


def test_beamspace_matches_jax():
    rng = np.random.default_rng(1)
    H = (rng.standard_normal((2, 4, 32, 4)) + 1j * rng.standard_normal((2, 4, 32, 4))).astype(np.complex64)
    Dr, Dt = np.array(jch.dft_dictionary(32, 32)), np.array(jch.dft_dictionary(4, 4))
    want = np.asarray(jax.vmap(lambda h: jch.beamspace(h, Dr, Dt))(H))
    got = ch.beamspace(torch.from_numpy(H), torch.from_numpy(Dr), torch.from_numpy(Dt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_channel_construction_and_interop():
    """Batched shapes; Zbar is the beamspace of H; a JAX channel carried
    across with interop gives the same Zbar through the port's beamspace."""
    c = ch.wideband_mmwave_channel(prng.role_generator(0, 0, prng.ROLE_CHANNEL, "cpu"), **CANON, batch=(3,))
    assert c.H.shape == (3, 4, 32, 4) and c.Zbar.shape == (3, 32, 16)
    assert c.Ar.shape == (3, 4, 6, 32) and c.At.shape == (3, 4, 6, 4)
    assert c.H.dtype == torch.complex64
    torch.testing.assert_close(c.Zbar, ch.beamspace(c.H, c.Dr, c.Dt))
    jc = jch.wideband_mmwave_channel(jprng.experiment_key(42), 4, 32, 4, 2, 3, 32, 4)
    tc = interop.channel_to_torch(jc)
    np.testing.assert_allclose(
        ch.beamspace(tc.H, tc.Dr, tc.Dt).numpy(), np.asarray(jc.Zbar), rtol=1e-5)
    back = interop.channel_to_numpy(tc)
    np.testing.assert_array_equal(back["H"], np.asarray(jc.H))


@pytest.mark.parametrize("quirks", [False, True])
def test_channel_energy_moments_match_jax_ensemble(quirks):
    """E‖Zbar‖²_F over the ensemble: the port's mean and JAX's mean (n=256
    each) agree within 5 combined standard errors; in the paper model both
    sit at the analytic L·Mr·Mt = 512 (unitary dictionaries)."""
    n = 256
    c = ch.wideband_mmwave_channel(
        prng.role_generator(1, 0, prng.ROLE_CHANNEL, "cpu"), **CANON, quirks=quirks, batch=(n,))
    e_port = (c.Zbar.abs() ** 2).sum(dim=(-2, -1)).double().numpy()
    keys = jax.random.split(jprng.experiment_key(7), n)
    Zj = jax.vmap(lambda k: jch.wideband_mmwave_channel(k, 4, 32, 4, 2, 3, 32, 4, quirks=quirks).Zbar)(keys)
    e_jax = np.sum(np.abs(np.asarray(Zj)) ** 2, axis=(-2, -1)).astype(np.float64)
    se = math.sqrt(e_port.var(ddof=1) / n + e_jax.var(ddof=1) / n)
    assert abs(e_port.mean() - e_jax.mean()) < 5 * se
    if not quirks:
        assert abs(e_port.mean() - 512.0) < 5 * e_port.std(ddof=1) / math.sqrt(n)


def test_truncated_laplacian_moments():
    """Support within [-pi, pi], symmetric, and the truncated-Laplacian
    second moment (closed form for the scale b = sigma/sqrt(2))."""
    g = prng.role_generator(2, 0, prng.ROLE_CHANNEL, "cpu")
    x = ch.truncated_laplacian(g, (200_000,)).double()
    assert float(x.abs().max()) <= math.pi + 1e-5
    b = ch.DEFAULT_SIGMA_PHI_RAD / math.sqrt(2.0)
    a = math.pi
    # E[x²] of a Laplace(0, b) truncated to [-a, a]
    m2 = (2 * b**2 - math.exp(-a / b) * (a**2 + 2 * a * b + 2 * b**2)) / (1 - math.exp(-a / b))
    se = float(x.pow(2).std()) / math.sqrt(x.numel())
    assert abs(float(x.pow(2).mean()) - m2) < 5 * se
    assert abs(float(x.mean())) < 5 * float(x.std()) / math.sqrt(x.numel())


def test_quirk_laplacian_range_matches_jax():
    """The reference's cosh sampler is confined to beta·(c − cosh([0,1]));
    port and JAX draws span the same interval and agree in mean."""
    g = prng.role_generator(3, 0, prng.ROLE_CHANNEL, "cpu")
    x = ch.quirk_laplacian(g, (100_000,)).double().numpy()
    xj = np.asarray(jch.quirk_laplacian(jprng.experiment_key(3), (100_000,))).astype(np.float64)
    c = math.exp(-math.sqrt(2.0) * math.pi / 50.0)
    beta = 1 / (1 - c)
    lo, hi = beta * (c - math.cosh(1.0)), beta * (c - 1.0)
    assert x.min() >= lo - 1e-4 and x.max() <= hi + 1e-4
    se = math.sqrt(x.var() / x.size + xj.var() / xj.size)
    assert abs(x.mean() - xj.mean()) < 5 * se


def test_quirks_channel_reuses_tap1_steering():
    """quirks=True builds every tap from tap-1 steering vectors, with
    cluster c rays weighted n_clusters − c."""
    c = ch.wideband_mmwave_channel(
        prng.role_generator(4, 0, prng.ROLE_CHANNEL, "cpu"), **CANON, quirks=True, batch=(2,))
    g = prng.role_generator(4, 0, prng.ROLE_CHANNEL, "cpu")
    alpha = prng.complex_normal(g, (2, 4, 6))
    w = torch.tensor([2, 2, 2, 1, 1, 1], dtype=torch.complex64)
    H = torch.einsum("blp,bpm,bpn->blmn", alpha * w, c.Ar[:, 0], c.At[:, 0].conj()) / math.sqrt(6)
    torch.testing.assert_close(c.H, H)
