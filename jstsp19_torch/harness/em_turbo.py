"""The problems and settings of the EM and turbo checks.

Each problem is made as numpy from a seed, so that the JAX reference tool
(``tools/torch_em_turbo_reference.py``), the tests and ``chip_smoke.py``
solve the same inputs:

* the canonical point's VAMP problem (``harness/amp_sparse.py::
  vamp_slm_problem``: B=256, 0 dB, a ``KronDictOp`` on per-realization A and
  B) under the two EM solvers and the five turbo solvers at their JAX
  defaults, the turbo chains along the Gr = 32 angle axis, ``slab_var`` =
  ``sigma2`` = 1/beta and ``gamw`` per realization;
* :func:`clustered_3d_problems`: the JAX test's one-blob 3-D support on an
  (8, 8, 4) lattice, n = 256, m = 128 (``tests/test_turbo_em.py::
  _clustered_3d_problem``), one problem per numpy seed, for
  ``turbo_mrf3d_vamp``;
* :func:`markov_support_problems`: the JAX test's Markov-chain support
  (``tests/test_turbo_em.py::_markov_support_problem``), n = 256, one
  problem per numpy seed, for ``turbo_mrf_arb_vamp`` on the ring
  :func:`ring_adjacency` (p01 0.08, λ 0.2, m 120, coupling 0.8, field −1.2,
  as ``test_mrf_arb_ring_adjacency`` sets them);
* the partial-Hadamard problems of ``harness/hadamard_cs.py`` with the
  non-negative signal |x| (``nonneg=True``) for ``em_nngm_gamp``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

# the EM solvers on the VAMP problem: name -> (keyword arguments, rounds), the
# JAX defaults; each inner vamp_slm takes A^H y through dict_correlation once
EM_SOLVERS = {
    "em_bg_vamp": (dict(n_em=8, nit=30), 8 + 1),
    "em_gm_vamp": (dict(n_components=3, n_em=10, nit=30), 10 + 1),
}
# the turbo solvers on the VAMP problem: name -> (keyword arguments, rounds)
TURBO_SOLVERS = {
    "turbo_markov_vamp": (dict(p01=0.05, p10=0.3, n_turbo=5, nit=30), 5),
    "turbo_mrf_vamp": (dict(p01=0.05, p10=0.3, n_turbo=5, nit=30), 5),
    "em_turbo_markov_vamp": (dict(p01_init=0.2, lam_init=0.2, n_em=8, nit=30), 8),
    "turbo_gauss_markov_vamp": (dict(alpha=0.1, p1=1.0, n_turbo=6, nit=30), 6),
    "em_turbo_gauss_markov_vamp": (dict(alpha_init=0.5, n_em=10, nit=30), 10),
}
NNGM_KW = dict(n_components=3, n_em=10, nit=40)  # em_nngm_gamp's JAX defaults

MRF_BATCH, MRF_SLAB_VAR, MRF_GAMW = 256, 1.0, 1e3
SHAPE3D, M3D = (8, 8, 4), 128
ARB_N, ARB_M, ARB_P01, ARB_LAM, ARB_COUPLING, ARB_FIELD = 256, 120, 0.08, 0.2, 0.8, -1.2


def turbo_arguments(name: str, beta, gamw):
    """The positional arguments after (y, op) of a turbo solver on the VAMP
    problem, and its keyword arguments: ``slab_var`` = 1/beta for the
    support solvers, ``sigma2`` (``sigma2_init``) = 1/beta for the two
    Gauss–Markov solvers, ``gamw`` as given (one per realization)."""
    kw = dict(TURBO_SOLVERS[name][0])
    if name == "turbo_gauss_markov_vamp":
        return (1.0 / beta, gamw), kw
    if name == "em_turbo_gauss_markov_vamp":
        return (gamw,), dict(kw, sigma2_init=1.0 / beta)
    return (1.0 / beta, gamw), kw


def _cplx(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)


def clustered_3d_problem(seed: int, shape=SHAPE3D, m: int = M3D, wvar: float = 1e-3) -> Dict[str, np.ndarray]:
    """One active 3-D blob, as ``tests/test_turbo_em.py::_clustered_3d_problem``
    draws it: A (m, n) and y (m,) complex64, x (n,) complex128."""
    rng = np.random.default_rng(seed)
    d0, d1, d2 = shape
    n = d0 * d1 * d2
    s = np.zeros(shape, bool)
    c = (rng.integers(2, d0 - 2), rng.integers(2, d1 - 2), rng.integers(1, d2 - 1))
    s[c[0] - 2: c[0] + 2, c[1] - 2: c[1] + 2, c[2] - 1: c[2] + 1] = True
    x = np.where(s.reshape(-1), _cplx(rng, n), 0)
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(2 * m)
    y = A @ x + np.sqrt(wvar / 2) * (rng.standard_normal(m) + 1j * rng.standard_normal(m))
    return dict(A=A.astype(np.complex64), y=y.astype(np.complex64), x=x)


def markov_support_problem(seed: int, n: int = ARB_N, m: int = ARB_M, p01: float = ARB_P01, lam: float = ARB_LAM,
                           wvar: float = 1e-3) -> Dict[str, np.ndarray]:
    """A Markov-chain support (p01 = P(on→off), stationary at lam), as
    ``tests/test_turbo_em.py::_markov_support_problem`` draws it: A (m, n)
    and y (m,) complex64, x (n,) complex128, s (n,) bool."""
    rng = np.random.default_rng(seed)
    p10 = p01 * lam / (1 - lam)
    s = np.zeros(n, bool)
    st = rng.random() < lam
    for i in range(n):
        st = (rng.random() < (1 - p01)) if st else (rng.random() < p10)
        s[i] = st
    x = np.where(s, _cplx(rng, n), 0)
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(2 * m)
    y = A @ x + np.sqrt(wvar / 2) * (rng.standard_normal(m) + 1j * rng.standard_normal(m))
    return dict(A=A.astype(np.complex64), y=y.astype(np.complex64), x=x, s=s)


def _stack(probs):
    return {k: np.stack([p[k] for p in probs]) for k in probs[0]}


def clustered_3d_problems(batch: int = MRF_BATCH) -> Dict[str, np.ndarray]:
    """:func:`clustered_3d_problem` for numpy seeds 0 … batch−1, stacked."""
    return _stack([clustered_3d_problem(s) for s in range(batch)])


def markov_support_problems(batch: int = MRF_BATCH) -> Dict[str, np.ndarray]:
    """:func:`markov_support_problem` for the first ``batch`` numpy seeds from
    0 up whose support is not empty (an empty one, x = 0, has no NMSE; below
    300 that is seeds 22 and 101), stacked, with the seeds under ``seed``."""
    probs = []
    seed = 0
    while len(probs) < batch:
        p = markov_support_problem(seed)
        if p["s"].any():
            probs.append(dict(p, seed=np.int64(seed)))
        seed += 1
    return _stack(probs)


def ring_adjacency(n: int = ARB_N) -> np.ndarray:
    """The ring graph of ``test_mrf_arb_ring_adjacency``, (n, n) float32."""
    adj = np.zeros((n, n), np.float32)
    i = np.arange(n)
    adj[i, (i + 1) % n] = 1
    adj[i, (i - 1) % n] = 1
    return adj
