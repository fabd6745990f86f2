"""The port's core/ (config, prng, metrics) against the JAX package.

Inputs come from a numpy seed and go through both packages as numpy.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.core import config as jconfig  # noqa: E402
from jstsp19_tpu.core import metrics as jmetrics  # noqa: E402
from jstsp19_torch.core import config, metrics, prng  # noqa: E402


def _c(rng, *s):
    return (rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)


@pytest.mark.parametrize("x", [2.5, -2.5, 0.5, -0.5, 1.49, 3.5, 7.0, -7.5, 0.0])
def test_matlab_round_matches_jax(x):
    assert config.matlab_round(x) == jconfig.matlab_round(x)


def test_system_config_matches_jax():
    for kw in ({}, {"Nr": 32, "Mr": 16, "T": 5}, {"T": 25, "L": 10}):
        a, b = config.SystemConfig(**kw), jconfig.SystemConfig(**kw)
        assert (a.T_prop, a.T_hbf, a.Np, a.beamspace_shape) == (
            b.T_prop, b.T_hbf, b.Np, b.beamspace_shape)
    assert config.canonical_system() == config.SystemConfig()
    assert config.COMPLEX_DTYPE == torch.complex64 and config.REAL_DTYPE == torch.float32


def test_snr_db_to_noise_var_matches_jax():
    snr = np.array([-15.0, 0.0, 3.0, 15.0])
    np.testing.assert_allclose(
        config.snr_db_to_noise_var(snr).numpy(),
        np.asarray(jconfig.snr_db_to_noise_var(jnp.asarray(snr))), rtol=1e-6)


def test_use_full_fp32_pins_both_flags():
    torch.backends.cudnn.allow_tf32 = True
    config.use_full_fp32()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_role_generators_are_deterministic_and_distinct():
    a = prng.realization_generators(3, 1, "cpu")
    b = prng.realization_generators(3, 1, "cpu")
    draws_a = {r: torch.randn(8, generator=g) for r, g in a.items()}
    draws_b = {r: torch.randn(8, generator=g) for r, g in b.items()}
    for r in prng.ROLES:
        assert torch.equal(draws_a[r], draws_b[r])
    seeds = {prng.role_seed(s, i, r) for s in (0, 1) for i in (0, 1) for r in prng.ROLES}
    assert len(seeds) == 2 * 2 * len(prng.ROLES)
    assert not torch.equal(draws_a[prng.ROLE_CHANNEL], draws_a[prng.ROLE_NOISE])


def test_complex_normal_moments():
    """CN(0, var): E|z|² = var, E z = 0, E z² = 0 (circular), Re/Im split
    evenly — each within 5 standard errors at n = 200k."""
    g = prng.role_generator(0, 0, prng.ROLE_NOISE, "cpu")
    var = 0.3
    z = prng.complex_normal(g, (200_000,), var=var).to(torch.complex128)
    se = var / np.sqrt(z.numel())
    assert abs(float((z.abs() ** 2).mean()) - var) < 5 * se
    assert abs(complex(z.mean())) < 5 * np.sqrt(var / z.numel())
    assert abs(complex((z * z).mean())) < 5 * se
    assert abs(float((z.real**2).mean()) - var / 2) < 5 * se
    assert prng.complex_normal(g, (3, 4)).dtype == torch.complex64


@pytest.mark.parametrize("kind", ["fro", "spectral"])
@pytest.mark.parametrize("shape", [(32, 16), (16, 40)])
def test_nmse_matches_jax(kind, shape):
    """Frobenius: sums only, rtol 1e-5.  Spectral: the largest eigenvalue
    of the thin-side Gram from two float32 eigensolvers (LAPACK through
    PyTorch and through XLA), which agree to ~1e-6 relative; rtol 1e-4."""
    rng = np.random.default_rng(1)
    est, ref = _c(rng, 3, *shape), _c(rng, 3, *shape)
    rtol = 1e-5 if kind == "fro" else 1e-4
    got = metrics.nmse(torch.from_numpy(est), torch.from_numpy(ref), kind).numpy()
    want = np.asarray(jax.vmap(lambda e, r: jmetrics.nmse(e, r, kind))(est, ref))
    np.testing.assert_allclose(got, want, rtol=rtol)
    got_c = metrics.clamped_nmse(torch.from_numpy(est), torch.from_numpy(ref), kind).numpy()
    want_c = np.asarray(jax.vmap(lambda e, r: jmetrics.clamped_nmse(e, r, kind))(est, ref))
    np.testing.assert_allclose(got_c, want_c, rtol=rtol)
    assert np.all(got_c <= 1.0)


def test_sq_norm_rejects_unknown_kind():
    with pytest.raises(ValueError):
        metrics.nmse(torch.ones(2, 2, dtype=torch.complex64), torch.ones(2, 2, dtype=torch.complex64), "nuc")
