"""JAX reference of the worked examples, for the port's example tests and
``chip_smoke.py`` [22]: rewrites ``results/torch_examples_jax.json``.

Runs each of the 21 scripts of ``examples/`` in this process (``runpy`` with
``--cpu``, as ``tests/test_examples.py`` does) and records its stdout lines
and the numbers on them by label (``jstsp19_torch/examples/_common.py::parse``:
the line's position, its text with the numbers taken out, the number's
place on the line).  The JSON holds printed numbers only, no arrays.

``draws(name)`` gives a script's problem as numpy arrays under the keys of
the port's ``build`` (``jstsp19_torch/examples/<name>.py``), computed by the
script's own draw lines, copied here with their file:line.  The tool proves
the copies faithful: it runs each script again with its solver entry points
wrapped to record their array arguments, and requires every array that
``passed(name, d)`` says the script hands its solvers to be among them, bit
for bit; the JSON records the check.  ``keys(name)`` gives the JAX keys the
scripts hand their solvers (BiG-AMP's initializations and the like), under
the port's problem keys.

Where a script's own printout is NaN or diverged, it is recorded as printed.

Run: python tools/torch_examples_reference.py [name ...]   (~8 min for all 21)
"""
import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:  # large_array_sharded's 8-device mesh
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402
import runpy  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from jstsp19_torch.examples import NAMES  # noqa: E402
from jstsp19_torch.examples._common import mismatches, parse, tokens  # noqa: E402
from jstsp19_tpu.core import prng  # noqa: E402

OUT = ROOT / "results" / "torch_examples_jax.json"
EXAMPLES = ROOT / "examples"
NUMPY_DRAWN = ("cs_mri", "dictionary_learning", "em_learning", "gamp_options", "impulsive_noise", "s_amp",
               "structured_sparsity")


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


# -- the scripts' draws ---------------------------------------------------------------------------


def _channel_estimation():
    from jstsp19_tpu.harness import pipeline as jpipe

    # examples/channel_estimation.py:27-33 (the draws inside realization_errors:
    # harness/pipeline.py::_system_realization and _proposed_frontend)
    pc = jpipe.PointConfig(methods=("ls", "vamp", "omp_mmv", "proposed", "proposed_angles"))
    key = prng.experiment_key(0)
    nv = jnp.asarray(10 ** (-10.0 / 10), jnp.float32)
    ch, Psi, N, W = jpipe._system_realization(key, pc, nv)
    _, obs, *_ = jpipe._proposed_frontend(key, pc, nv)
    return _np(dict(ch._asdict(), Psi=Psi, N=N, W=W, Omega=obs.Omega))


def _large_array_sharded():
    from jstsp19_tpu.channel import wideband_mmwave_channel

    # examples/large_array_sharded.py:38-64,74
    Nt, Nr, Mr_e, L = 16, 128, 64, 8
    keys = prng.realization_keys(prng.experiment_key(0), 0, 8)
    H = [wideband_mmwave_channel(prng.role_key(k, prng.ROLE_CHANNEL), L, Nr, Nt, 2, 3, Nr, Nt).H for k in keys]
    u = [jax.random.uniform(prng.role_key(k, prng.ROLE_BEAMFORMER), (Nr, Mr_e)) for k in keys]
    return _np(dict(H=jnp.stack(H), u=jnp.stack(u)))


def _large_array_combiners(u):
    """The script's Wm.conj() from its uniforms (examples/large_array_sharded.py:54-65)."""
    out = []
    for ui in u:
        W = jnp.exp(2j * jnp.pi * jnp.round(jnp.asarray(ui) * 64) / 64) / np.sqrt(128)
        out.append(np.asarray(W[:, :16].conj()))
    return out


def _sparse_recovery():
    # examples/sparse_recovery.py:32-43
    key = prng.experiment_key(0)
    m, n, k, snr_db = 128, 256, 12, 30.0
    kA, kx, ki, kn = jax.random.split(key, 4)
    A = prng.complex_normal(kA, (m, n)) / np.sqrt(m)
    idx = jax.random.choice(ki, n, (k,), replace=False)
    beta = k / n
    x = jnp.zeros((n,), jnp.complex64).at[idx].set(prng.complex_normal(kx, (k,), var=1 / beta))
    y_clean = A @ x
    nv = float(jnp.mean(jnp.abs(y_clean) ** 2)) * 10 ** (-snr_db / 10)
    y = y_clean + prng.complex_normal(kn, (m,), var=nv)
    return _np(dict(A=A, x=x, y=y))


def _basic_gamp():
    # examples/basic_gamp.py:45-53,67-70
    m, n, wvar = 300, 100, 0.01
    ka, kx, kw = jax.random.split(jax.random.PRNGKey(0), 3)
    A = jax.random.normal(ka, (m, n)) / jnp.sqrt(m)
    x = jax.random.normal(kx, (n,))
    y = A @ x + jnp.sqrt(wvar) * jax.random.normal(kw, (m,))
    k = jax.random.PRNGKey(1)
    Ac = prng.complex_normal(jax.random.fold_in(k, 0), (m, n), var=1.0 / m)
    xc = prng.complex_normal(jax.random.fold_in(k, 1), (n,))
    yc = Ac @ xc + prng.complex_normal(jax.random.fold_in(k, 2), (m,), var=wvar)
    return _np(dict(A=A, x=x, y=y, Ac=Ac, xc=xc, yc=yc))


def _trials(seeds, m, n, p1, var0, wvar, channel=None):
    """A, x, y of examples/state_evolution.py:52-57, snipe.py:41-45 and
    probit_classification.py:53-57, one trial a seed, stacked."""
    from jstsp19_tpu.solvers import bg_sampler

    A, x, y = [], [], []
    for s in seeds:
        ka, kx, kw = jax.random.split(jax.random.PRNGKey(s), 3)
        A.append(jax.random.normal(ka, (m, n)) / jnp.sqrt(m))
        x.append(bg_sampler(p1, var0)(kx, n))
        y.append(A[-1] @ x[-1] + jnp.sqrt(wvar) * jax.random.normal(kw, (m,)) if channel is None
                 else channel(kw, A[-1] @ x[-1]))
    return jnp.stack(A), jnp.stack(x), jnp.stack(y)


def _state_evolution():
    from jstsp19_tpu.solvers import AwgnPrior, SparsePrior, bg_sampler, estim_in_avg

    # examples/state_evolution.py:39-47,51-57
    p1, var0, wvar, m, n = 0.1, 1.0, 1e-4, 512, 1024
    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=var0), p1=p1)
    in_avg = estim_in_avg(prior, jax.random.PRNGKey(0), n_samp=65536, sampler=bg_sampler(p1, var0))
    A, x, y = _trials(range(10, 14), m, n, p1, var0, wvar)
    return _np(dict(se_x=in_avg.x, se_w=in_avg.w, A=A, x=x, y=y))


def _snipe():
    # examples/snipe.py:37-45,52
    A, x, y = _trials(range(40, 44), 300, 512, 0.08, 1.0, 1e-4)
    return _np(dict(A=A, x=x, y=y))


def _probit_classification():
    from jstsp19_tpu.solvers import AwgnPrior, SparsePrior, bg_sampler, estim_in_avg

    # examples/probit_classification.py:42-49,52-57,66-70,80-86
    P1, VAR0, WVAR, n = 0.1, 1.0, 1e-2, 512

    def channel(key, z):
        return (z + jnp.sqrt(WVAR) * jax.random.normal(key, z.shape) > 0).astype(jnp.float32)

    out = {}
    for ratio in (2.0, 4.0, 6.0):
        m = int(ratio * n)
        out[f"A{m}"], out[f"x{m}"], out[f"y{m}"] = _trials(range(30, 34), m, n, P1, VAR0, WVAR, channel)
    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=VAR0), p1=P1)
    in_avg = estim_in_avg(prior, jax.random.PRNGKey(2), n_samp=65536, sampler=bg_sampler(P1, VAR0))
    return _np(dict(out, se_x=in_avg.x, se_w=in_avg.w))


def _nonlinear_channels():
    from scipy.special import erfinv

    from jstsp19_tpu.solvers import bg_sampler

    # examples/nonlinear_channels.py:51-66,87-102
    m, n, p1, snr_db = 500, 1000, 0.1, 20
    wvar = 10 ** (-0.1 * snr_db)
    ascale = 1.0 / np.sqrt(2 * p1 * 1.0) / 0.5 / erfinv(1 - 0.3)

    def out_fn(z):
        return 2.0 / (1.0 + jnp.exp(-ascale * z)) - 1.0

    ka, kx, kw = jax.random.split(jax.random.PRNGKey(7), 3)
    A = jax.random.normal(ka, (m, n)) / jnp.sqrt(m)
    x = bg_sampler(p1, 1.0)(kx, n)
    y = out_fn(A @ x) + jnp.sqrt(wvar) * jax.random.normal(kw, (m,))
    mp, np_, scale = 800, 200, 8.0
    ka, kx, kp = jax.random.split(jax.random.PRNGKey(8), 3)
    act = jax.random.uniform(jax.random.fold_in(kx, 0), (np_,)) < p1
    mag = jax.random.exponential(jax.random.fold_in(kx, 1), (np_,))
    x_nn = jnp.where(act, mag, 0.0)
    A_nn = ((jax.random.uniform(ka, (mp, np_)) < 0.25).astype(jnp.float32)
            * jax.random.uniform(jax.random.fold_in(ka, 1), (mp, np_)) * (8.0 / np_))
    y_cnt = jax.random.poisson(kp, scale * (A_nn @ x_nn)).astype(jnp.float32)
    return _np(dict(A=A, x=x, y=y, x_nn=x_nn, A_nn=A_nn, y_cnt=y_cnt))


def _robust_classification():
    # examples/robust_classification.py:38-46
    n, m, k, p_flip = 64, 256, 8, 0.08
    kA, kf = jax.random.split(jax.random.key(7))
    A = jax.random.normal(kA, (m, n)) / np.sqrt(n)
    x0 = jnp.where(jnp.arange(n) < k, 2.0, 0.0)
    y_clean = (A @ x0 > 0).astype(jnp.float32)
    flip = jax.random.bernoulli(kf, p_flip, (m,))
    return _np(dict(A=A, y=jnp.where(flip, 1.0 - y_clean, y_clean)))


def _matrix_completion():
    # examples/matrix_completion.py:22-30
    key = prng.experiment_key(0)
    L, M, R, obs_frac, nv = 48, 64, 3, 0.5, 1e-3
    Af = prng.complex_normal(jax.random.fold_in(key, 0), (L, R))
    Xf = prng.complex_normal(jax.random.fold_in(key, 1), (R, M))
    Z = Af @ Xf
    mask = (jax.random.uniform(jax.random.fold_in(key, 2), (L, M)) < obs_frac).astype(jnp.float32)
    Y = mask * (Z + prng.complex_normal(jax.random.fold_in(key, 3), (L, M), var=nv))
    return _np(dict(Z=Z, mask=mask, Y=Y))


def _rank_one_priors():
    from jstsp19_tpu.solvers import AwgnPrior, DiscretePrior

    # examples/rank_one_factorization.py:37-45
    nx = 100
    x = np.linspace(1 / nx, 2, nx)
    px = np.exp(-x)
    px = 0.1 * px / px.sum()
    return (AwgnPrior(jnp.asarray(0.0), jnp.asarray(1.0)),
            DiscretePrior(jnp.asarray(np.concatenate([[0.0], x]), jnp.float32),
                          jnp.asarray(np.concatenate([[0.9], px]), jnp.float32)))


def _rank_one_factorization():
    # examples/rank_one_factorization.py:51-55,60 (one unit noise draw, scaled per SNR)
    m, n = 1000, 500
    _, estimv = _rank_one_priors()
    ku, kv, kw = jax.random.split(jax.random.key(0), 3)
    u0 = jax.random.normal(ku, (m,))
    w = estimv.weights / jnp.sum(estimv.weights)
    v0 = estimv.atoms[jax.random.choice(kv, estimv.atoms.shape[0], (n,), p=w)]
    return _np(dict(u0=u0, v0=v0, noise=jax.random.normal(kw, (m, n))))


def _rank_one_matrices(d):
    """The script's A at each SNR (examples/rank_one_factorization.py:46-49,58-60)."""
    from jstsp19_tpu.solvers import prior_moments

    estimu, estimv = _rank_one_priors()
    um, uv = prior_moments(estimu)
    vm, vv = prior_moments(estimv)
    usq0, vsq0 = float(um**2 + uv), float(vm**2 + vv)
    kw = jax.random.split(jax.random.key(0), 3)[2]
    out = []
    for snr_db in (0.0, 5.0, 10.0):
        wvar = usq0 * vsq0 * 10 ** (-0.1 * snr_db)
        out.append(np.asarray(jnp.outer(jnp.asarray(d["u0"]), jnp.asarray(d["v0"]))
                              + jnp.sqrt(1000 * wvar) * jax.random.normal(kw, (1000, 500))))
    return out


def _calibration(key):
    # examples/self_calibration.py:33-49 (applications.py:83-94 draws the same)
    M, Nc, k = 96, 128, 8
    Phi = prng.complex_normal(jax.random.fold_in(key, 0), (M, Nc)) / np.sqrt(M)
    beta = k / Nc
    act = jax.random.uniform(jax.random.fold_in(key, 1), (Nc,)) < beta
    c_true = jnp.where(act, prng.complex_normal(jax.random.fold_in(key, 2), (Nc,), var=1 / beta), 0.0)
    b_true = 1.0 + prng.complex_normal(jax.random.fold_in(key, 3), (M,), var=0.05)
    z_true = b_true * (Phi @ c_true)
    nv = 1e-4 * float(jnp.mean(jnp.abs(z_true) ** 2))
    y = z_true + prng.complex_normal(jax.random.fold_in(key, 4), (M,), var=nv)
    return _np(dict(Phi=Phi, c_true=c_true, b_true=b_true, y=y))


def _calibration_tensor(Phi):
    """The script's measurement tensor (examples/self_calibration.py:51-52)."""
    M = Phi.shape[0]
    return np.asarray(jnp.zeros((M, M, Phi.shape[1]), jnp.complex64).at[jnp.arange(M), jnp.arange(M), :].set(Phi))


def _self_calibration():
    return _calibration(jax.random.key(11))


def _scene(key, N, pure):
    # examples/hyperspectral_unmixing.py:29-48 (applications.py:112-126 without
    # the pure pixels)
    T, R = 48, 3
    t = np.linspace(0, 1, T)
    A_true = np.stack([0.2 + np.exp(-0.5 * ((t - 0.25) / 0.08) ** 2),
                       0.3 + 0.8 * np.exp(-0.5 * ((t - 0.6) / 0.15) ** 2),
                       0.1 + 0.5 * t + 0.4 * np.exp(-0.5 * ((t - 0.9) / 0.1) ** 2)]).astype(np.float32)
    e = jax.random.exponential(jax.random.fold_in(key, 0), (N, R))
    if pure:
        S_true = np.array(e / jnp.sum(e, axis=1, keepdims=True))
        for r in range(R):
            S_true[r * 5:r * 5 + 5] = np.eye(R)[r]
        S_true = jnp.asarray(S_true)
    else:
        S_true = e / jnp.sum(e, axis=1, keepdims=True)
    Z = S_true @ jnp.asarray(A_true)
    nv = 1e-4 * float(jnp.mean(Z**2))
    Y = Z + jnp.sqrt(nv) * jax.random.normal(jax.random.fold_in(key, 1), (N, T))
    return _np(dict(S_true=S_true, Y=Y))


def _hyperspectral_unmixing():
    return _scene(jax.random.key(5), 600, True)


def _applications():
    out = {}
    # examples/applications.py:39-46 (phase retrieval)
    key = jax.random.key(5)
    n, m = 64, 384
    A = prng.complex_normal(jax.random.fold_in(key, 0), (m, n)) / np.sqrt(n)
    x = prng.complex_normal(jax.random.fold_in(key, 1), (n,))
    wvar = 1e-4 * float(jnp.mean(jnp.abs(A @ x) ** 2))
    y = jnp.abs(A @ x + prng.complex_normal(jax.random.fold_in(key, 2), (m,), var=wvar))
    out.update(pr_A=A, pr_x=x, pr_y=y)
    # examples/applications.py:59-69 (classification)
    key = jax.random.key(7)
    n, p, k, scale = 128, 800, 8, 3.0
    X = jax.random.normal(jax.random.fold_in(key, 0), (p, n)) / np.sqrt(k)
    idx = jax.random.choice(jax.random.fold_in(key, 1), n, (k,), replace=False)
    w = jnp.zeros((n,), jnp.float32).at[idx].set(jax.random.normal(jax.random.fold_in(key, 2), (k,)))
    y = (jax.random.uniform(jax.random.fold_in(key, 3), (p,)) < jax.nn.sigmoid(scale * (X @ w))).astype(jnp.float32)
    out.update(cl_X=X, cl_w=w, cl_y=y)
    out.update({f"sc_{k}": v for k, v in _calibration(jax.random.key(11)).items()})
    out.update({f"hu_{k}": v for k, v in _scene(jax.random.key(9), 400, False).items()})
    return _np(out)


def _gamp_options():
    # examples/gamp_options.py:42-47
    rng = np.random.default_rng(0)
    n, m, k, wvar = 512, 256, 32, 1e-4
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x = np.zeros(n)
    x[rng.choice(n, k, False)] = rng.standard_normal(k)
    y = A @ x + np.sqrt(wvar) * rng.standard_normal(m)
    return dict(A=A.astype(np.float32), x=x, y=y.astype(np.float32))


def _s_amp():
    # examples/s_amp.py:34-49
    rng = np.random.default_rng(0)
    n, m, k, wvar, cond = 256, 128, 12, 1e-5, 10.0
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(cond), m)
    A = U @ np.diag(s) @ V[:, :m].T
    A *= np.sqrt(n / np.sum(s**2))
    evals = np.asarray(jnp.asarray((s * np.sqrt(n / np.sum(s**2))) ** 2, jnp.float32))
    x = np.zeros(n)
    idx = rng.choice(n, k, False)
    x[idx] = rng.standard_normal(k)
    y = np.asarray(jnp.asarray(A @ x + np.sqrt(wvar) * rng.standard_normal(m), jnp.float32))
    return dict(A=A.astype(np.float32), evals=evals, x=x, y=y)


def _cs_mri():
    # examples/cs_mri.py:31-59
    rng = np.random.default_rng(2)
    ny = nx = 32
    n, frac = ny * nx, 0.35
    img = np.zeros((ny, nx))
    for _ in range(6):
        y0, x0 = rng.integers(0, ny - 8, 2)
        h, w = rng.integers(4, ny // 3, 2)
        img[y0:y0 + h, x0:x0 + w] += rng.uniform(0.3, 1.0)
    keep = set()
    for i in range(ny):
        for j in range(nx):
            if min(i, ny - i) <= 2 and min(j, nx - j) <= 2:
                keep.add(i * nx + j)
    rest = [k for k in range(n) if k not in keep]
    keep |= set(rng.choice(rest, int(frac * n) - len(keep), False).tolist())
    return dict(img=img, idx=np.asarray(sorted(keep), np.int64))


def _em_learning():
    # examples/em_learning.py:27-66
    rng = np.random.default_rng(0)
    n, m, wvar, k = 512, 300, 1e-3, 40
    x = np.zeros(n, complex)
    idx = rng.choice(n, k, False)
    x[idx] = (rng.standard_normal(k) + 1j * rng.standard_normal(k)) / np.sqrt(2)
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(2 * m)
    y = A @ x + np.sqrt(wvar / 2) * (rng.standard_normal(m) + 1j * rng.standard_normal(m))
    act = rng.random(n) < 0.08
    big = rng.random(n) < 0.5
    amp = np.where(big, 3.0, 0.5)
    x2 = np.where(act, amp * (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2), 0)
    A2 = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(2 * m)
    nv2 = 1e-3 * float(np.mean(np.abs(x2) ** 2)) * n / m
    y2 = A2 @ x2 + np.sqrt(nv2 / 2) * (rng.standard_normal(m) + 1j * rng.standard_normal(m))
    c64 = np.complex64
    return dict(x=x, A=A.astype(c64), y=y.astype(c64), x2=x2, A2=A2.astype(c64), y2=y2.astype(c64),
                nv2=np.asarray(nv2))


def _impulsive_noise():
    # examples/impulsive_noise.py:36-46
    rng = np.random.default_rng(7)
    n, m, k, lam, wvar = 400, 240, 24, 0.1, 9.0
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x = np.zeros(n)
    x[rng.choice(n, k, False)] = rng.standard_normal(k)
    impulses = (rng.uniform(size=m) < lam) * (np.sqrt(wvar) * rng.standard_normal(m))
    f32 = np.float32
    return dict(A=A.astype(f32), x=x.astype(f32), impulses=impulses.astype(f32))


def _structured_sparsity():
    # examples/structured_sparsity.py:41-64
    rng = np.random.default_rng(2)
    n, m, wvar = 256, 110, 1e-3
    p01, lam = 0.05, 0.25
    p10 = p01 * lam / (1 - lam)
    while True:
        s = np.zeros(n, bool)
        st = rng.random() < lam
        for i in range(n):
            st = (rng.random() < (1 - p01)) if st else (rng.random() < p10)
            s[i] = st
        if abs(s.mean() - lam) < 0.02:
            break
    x = np.where(s, (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2), 0)
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(2 * m)
    y = A @ x + np.sqrt(wvar / 2) * (rng.standard_normal(m) + 1j * rng.standard_normal(m))
    return dict(s=s, x=x, A=A.astype(np.complex64), y=y.astype(np.complex64))


def _dictionary_learning():
    # examples/dictionary_learning.py:33-72
    rng = np.random.default_rng(0)
    L, M, R, nv = 64, 64, 4, 1e-4
    A0 = (rng.standard_normal((L, R)) + 1j * rng.standard_normal((L, R))) / np.sqrt(2)
    X0 = (rng.standard_normal((R, M)) + 1j * rng.standard_normal((R, M))) / np.sqrt(2)
    Z0 = A0 @ X0
    mask = (rng.random((L, M)) < 0.5).astype(float)
    Y = (Z0 + np.sqrt(nv / 2) * (rng.standard_normal((L, M)) + 1j * rng.standard_normal((L, M)))) * mask
    L, R, M, lam_true = 24, 5, 400, 0.15
    D0 = (rng.standard_normal((L, R)) + 1j * rng.standard_normal((L, R))) / np.sqrt(2)
    support = rng.random((R, M)) < lam_true
    C0 = support * (rng.standard_normal((R, M)) + 1j * rng.standard_normal((R, M))) / np.sqrt(2)
    Zd = D0 @ C0
    nvd = 1e-4 * float(np.mean(np.abs(Zd) ** 2))
    Yd = Zd + np.sqrt(nvd / 2) * (rng.standard_normal((L, M)) + 1j * rng.standard_normal((L, M)))
    return dict(Z0=Z0, mask=mask.astype(np.float32), Y=Y.astype(np.complex64), Zd=Zd, Yd=Yd.astype(np.complex64))


DRAWS = {
    "applications": _applications, "basic_gamp": _basic_gamp, "channel_estimation": _channel_estimation,
    "hyperspectral_unmixing": _hyperspectral_unmixing, "large_array_sharded": _large_array_sharded,
    "matrix_completion": _matrix_completion, "nonlinear_channels": _nonlinear_channels,
    "probit_classification": _probit_classification, "rank_one_factorization": _rank_one_factorization,
    "robust_classification": _robust_classification, "self_calibration": _self_calibration, "snipe": _snipe,
    "sparse_recovery": _sparse_recovery, "state_evolution": _state_evolution, "cs_mri": _cs_mri,
    "dictionary_learning": _dictionary_learning, "em_learning": _em_learning, "gamp_options": _gamp_options,
    "impulsive_noise": _impulsive_noise, "s_amp": _s_amp, "structured_sparsity": _structured_sparsity,
}


def draws(name):
    """The script's problem as numpy arrays, under the port's problem keys."""
    return DRAWS[name]()


def keys(name):
    """The JAX keys the script hands its solvers, under the port's problem
    keys (the port's are ``torch.Generator`` objects)."""
    e = prng.experiment_key(0)
    return {
        "matrix_completion": {"key": jax.random.fold_in(e, 4)},  # matrix_completion.py:37
        "dictionary_learning": {"key0": jax.random.PRNGKey(0), "key1": jax.random.PRNGKey(1)},  # :45,53,73
        "rank_one_factorization": {"fit_key": prng.experiment_key(0)},  # rank_one_fit's default key
        "self_calibration": {"key": jax.random.fold_in(jax.random.key(11), 5)},  # self_calibration.py:60
        "hyperspectral_unmixing": {"key": jax.random.fold_in(jax.random.key(5), 2)},  # :50
        "applications": {"sc_key": jax.random.fold_in(jax.random.key(11), 5),  # applications.py:105,127
                         "hu_key": jax.random.fold_in(jax.random.key(9), 2)},
    }.get(name, {})


# -- the check that the copies are the scripts' own draws ----------------------------------------


def passed(name, d):
    """The arrays the script hands its solver entry points, from its draws."""
    if name == "channel_estimation":
        return [d[k] for k in ("H", "N", "Psi", "W", "Omega", "Zbar")]
    if name == "large_array_sharded":
        return list(d["H"]) + _large_array_combiners(d["u"])
    if name in ("state_evolution", "snipe", "probit_classification"):
        trials = [a for k, v in d.items() if k in ("A", "y") or (k[0] in "Ay" and k[1:].isdigit()) for a in v]
        return trials + ([d["se_x"], d["se_w"]] if "se_x" in d else [])
    if name == "rank_one_factorization":
        return _rank_one_matrices(d)
    if name == "self_calibration":
        return [d["y"], _calibration_tensor(d["Phi"])]
    if name == "applications":
        return [d[k] for k in ("pr_A", "pr_y", "cl_X", "cl_y", "sc_y", "hu_Y")] + [_calibration_tensor(d["sc_Phi"])]
    if name == "cs_mri":
        from jstsp19_tpu.ops import MedImageOp

        op = MedImageOp(32, 32, 3, tuple(int(i) for i in d["idx"]))
        return [np.asarray(op.mv(op._analysis(jnp.asarray(d["img"], jnp.complex64)).reshape(-1)))]
    if name == "impulsive_noise":
        return [d["A"], np.asarray(jnp.asarray(d["A"]) @ jnp.asarray(d["x"]) + jnp.asarray(d["impulses"]))]
    if name == "dictionary_learning":
        return [d["Y"], d["mask"], d["Yd"]]
    if name == "nonlinear_channels":
        return [d[k] for k in ("A", "y", "A_nn", "y_cnt")]
    if name == "s_amp":
        return [d[k] for k in ("A", "y", "evals")]
    keep = {"sparse_recovery": ("A", "y"), "basic_gamp": ("A", "y", "Ac", "yc"), "robust_classification": ("A", "y"),
            "matrix_completion": ("Z", "Y", "mask"), "hyperspectral_unmixing": ("Y",),
            "em_learning": ("A", "y", "A2", "y2"), "gamp_options": ("A", "y"), "structured_sparsity": ("A", "y")}
    return [d[k] for k in keep[name]]


ENTRY_POINTS = ("gamp_est", "gamp", "gamp_se", "amp", "amp_est", "omp", "em_bg_vamp", "em_gm_vamp", "vamp_slm",
                "mc_svt", "mc_admm", "em_bigamp_mc", "em_bigamp_dl", "rank_one_fit", "pbigamp", "hutamp", "hbf",
                "proposed_hbf", "proposed_admm", "clamped_nmse", "taps_to_subcarriers")
JITTED = ("channel_estimation", "large_array_sharded")  # jit (and vmap) at the script's level


class _Enough(Exception):
    """Every array looked for has been seen."""


def _leaves(obj, out, depth=0):
    if isinstance(obj, (jax.Array, np.ndarray)):
        if not jnp.issubdtype(obj.dtype, jax.dtypes.prng_key):
            out.append(np.asarray(obj))
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _leaves(o, out, depth + 1)
    elif isinstance(obj, dict):
        for o in obj.values():
            _leaves(o, out, depth + 1)
    elif depth < 4 and dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _leaves(getattr(obj, f.name), out, depth + 1)
    elif depth < 4 and hasattr(obj, "__dict__") and not callable(obj):
        for o in vars(obj).values():
            _leaves(o, out, depth + 1)


@contextlib.contextmanager
def _recording(want, found, jitted, extra=()):
    """Every jstsp19_tpu module's entry point of ENTRY_POINTS (and ``extra``
    of ``jnp``) compares its array arguments with ``want`` and adds the
    indices it matches bit for bit to ``found``; once all are found it
    raises :class:`_Enough`.  For a script that jits (and vmaps) at its own
    level, jit is off and ``jax.vmap`` runs a Python loop, so that the entry
    points see arrays, not tracers."""
    def look(args):
        seen = []
        _leaves(args, seen)
        for s in seen:
            for i, w in enumerate(want):
                if i not in found and s.shape == w.shape and s.dtype == w.dtype and np.array_equal(s, w,
                                                                                                  equal_nan=True):
                    found.add(i)
        if len(found) == len(want):
            raise _Enough

    patched = []
    targets = [(m, ENTRY_POINTS) for k, m in list(sys.modules.items()) if k.startswith("jstsp19_tpu") and m]
    for mod, names in targets + [(jnp, extra)]:
        for name in names:
            fn = getattr(mod, name, None)
            if fn is None or not callable(fn) or isinstance(fn, type):
                continue

            def wrapper(*a, _f=fn, **kw):
                look((a, kw))
                return _f(*a, **kw)

            patched.append((mod, name, fn))
            setattr(mod, name, wrapper)
    vmap = jax.vmap
    if jitted:
        jax.vmap = lambda f, *a, **kw: (lambda xs: jax.tree_util.tree_map(lambda *r: jnp.stack(r),
                                                                           *[f(x) for x in xs]))
    try:
        with jax.disable_jit() if jitted else contextlib.nullcontext():
            yield
    finally:
        jax.vmap = vmap
        for mod, name, fn in reversed(patched):
            setattr(mod, name, fn)


def _run(name, recording=None):
    path = EXAMPLES / f"{name}.py"
    argv, sys.argv = sys.argv, [str(path), "--cpu"]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), recording or contextlib.nullcontext():
            runpy.run_path(str(path), run_name="__main__")
    except _Enough:
        pass
    finally:
        sys.argv = argv
    return out.getvalue().splitlines()


def check_draws(name):
    """(ok, how many of the arrays the script hands its solvers were found
    bit-equal to the copies', how many)."""
    import jstsp19_tpu.channel  # noqa: F401  (so that their names are patched too)
    import jstsp19_tpu.harness.pipeline  # noqa: F401
    import jstsp19_tpu.solvers  # noqa: F401

    want, found = passed(name, draws(name)), set()
    extra = ("einsum",) if name == "large_array_sharded" else ()
    _run(name, _recording(want, found, name in JITTED, extra))
    return len(found) == len(want), len(found), len(want)


def reference(name):
    t0 = time.perf_counter()
    lines = _run(name)
    seconds = time.perf_counter() - t0
    ok, found, total = check_draws(name)
    return {"lines": lines, "numbers": parse(lines), "seconds": seconds,
            "draws": "numpy" if name in NUMPY_DRAWN else "jax.random",
            "draws_bit_equal": ok, "draws_checked": f"{found} of {total} solver inputs bit-equal"}


# -- holding the port to the reference ---------------------------------------------------------


def load():
    return json.loads(OUT.read_text())["examples"]


def _half_unit(tok: str) -> float:
    """Half of the last printed digit's place of a printed number."""
    m = re.fullmatch(r"[-+]?\d*\.?(\d*)(?:[eE]([-+]?\d+))?", tok)
    if m is None:  # nan, inf, True, False
        return 0.0
    return 0.5 * 10.0 ** (int(m.group(2) or 0) - len(m.group(1)))


class JaxKeys:
    """JAX keys, one a realization, standing in for a port generator."""

    def __init__(self, keys):
        self.keys = list(keys)


def patch_port_prng(monkeypatch):
    """The port's key derivations (``jstsp19_torch/core/prng.py``: ``fold_in``,
    ``split``, ``normal``) act on :class:`JaxKeys` as JAX's do on each key;
    a ``torch.Generator`` takes the port's own."""
    import torch

    from jstsp19_torch.core import prng as tprng

    fold_in, split, normal = tprng.fold_in, tprng.split, tprng.normal

    def fold_in_(k, data):
        return JaxKeys(jax.random.fold_in(kk, data) for kk in k.keys) if isinstance(k, JaxKeys) else fold_in(k, data)

    def split_(k, n):
        if not isinstance(k, JaxKeys):
            return split(k, n)
        parts = [jax.random.split(kk, n) for kk in k.keys]
        return tuple(JaxKeys(p[i] for p in parts) for i in range(n))

    def normal_(k, shape, dtype, device):
        if not isinstance(k, JaxKeys):
            return normal(k, shape, dtype, device)
        draws = np.stack([np.asarray(jax.random.normal(kk, tuple(shape[1:]))) for kk in k.keys])
        return torch.from_numpy(draws).to(dtype).to(device)

    monkeypatch.setattr(tprng, "fold_in", fold_in_)
    monkeypatch.setattr(tprng, "split", split_)
    monkeypatch.setattr(tprng, "normal", normal_)


def port_problem(name, device=None):
    """The port's problem dict on the script's own draws: :func:`draws`
    through ``interop``, :func:`keys` as :class:`JaxKeys` (the port's prng
    patched by :func:`patch_port_prng`), and the port's own generator for a
    key the script does not hand over (probit's output average)."""
    import importlib

    from jstsp19_torch import interop
    from jstsp19_torch.core import prng as tprng

    p = {k: interop.to_torch(v, device) for k, v in draws(name).items()}
    p.update({k: JaxKeys([v]) for k, v in keys(name).items()})
    if name == "probit_classification":
        mod = importlib.import_module(f"jstsp19_torch.examples.{name}")
        p["out_key"] = tprng.fold_in(__import__("torch").Generator().manual_seed(mod.SEED), mod.SE_OUT)
    return p


def held(name, got, skip_lines=()):
    """The labels at which the port's unrounded numbers ``got`` (its
    ``solve``) miss the script's printed ones under the example's
    ``TOLERANCE`` (``_common.mismatches``), each bound widened by half the
    printed last digit; [] where all agree.  The lines of ``skip_lines`` are
    left out."""
    import importlib

    table = importlib.import_module(f"jstsp19_torch.examples.{name}").TOLERANCE
    ref = load()[name]
    toks = {k: v for k, v in tokens(ref["lines"]).items() if int(k[:2]) not in skip_lines}
    want = {k: ref["numbers"][k] for k in toks}
    got = {k: v for k, v in got.items() if int(k[:2]) not in skip_lines}
    return mismatches(got, want, table, slack=lambda label: _half_unit(toks[label]))


def main(argv=None):
    names = list(argv if argv is not None else sys.argv[1:]) or list(NAMES)
    doc = json.loads(OUT.read_text()) if OUT.exists() else {}
    doc.setdefault("examples", {})
    doc["note"] = ("Each example script of examples/ run in-process on the CPU (jax " + jax.__version__ + "), by "
                   "tools/torch_examples_reference.py: its stdout lines and the numbers on them by label "
                   "(jstsp19_torch/examples/_common.py::parse); draws_bit_equal: the tool's copies of the "
                   "script's draws equal, bit for bit, the arrays the script hands its solvers.")
    for name in names:
        rec = reference(name)
        doc["examples"][name] = rec
        print(f"{name:24s} {rec['seconds']:7.1f} s  draws bit-equal: {rec['draws_bit_equal']} "
              f"({rec['draws_checked']})", flush=True)
    doc["examples"] = dict(sorted(doc["examples"].items()))
    OUT.write_text(json.dumps(doc, indent=1) + "\n")
    bad = [n for n, r in doc["examples"].items() if not r["draws_bit_equal"]]
    print(f"wrote {OUT.relative_to(ROOT)}; draws not bit-equal: {bad or 'none'}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
