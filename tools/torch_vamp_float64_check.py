"""Holds the port's VAMP to the JAX package's in float64 at the corner where
their float32 runs part: errorVSframelength's T=5 point
(``PointConfig(Nt=8, Gt=8, T=5, num_nonzero=50, beamformer='fft')``, noise
variance 10^(-15/10)), on the JAX realizations of ``experiment_key(3)``.

JAX draws the conventional-branch inputs (normal-equations form, as the
pipeline calls VAMP).  Both packages then run ``vamp_glm`` for 100
iterations on the same numpy operator, prior and likelihood, first in
float32 and then in float64 (``jax_enable_x64``).  A third float64 run of
JAX with the observation moved by one float32 ulp measures how far the
iteration itself carries a rounding-sized change.  Prints, per dtype, the
largest per-realization max|Δx|/max|x| and |ΔNMSE| between the packages,
both batch means and the share at the NMSE clamp; then each package's
float32 run against the float64 JAX run.

Usage: ``python tools/torch_vamp_float64_check.py [N_REALIZATIONS]`` (CPU only).
"""
from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO) if REPO not in sys.path else None

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from jstsp19_tpu.core import prng as jprng  # noqa: E402
from jstsp19_tpu.frontend import hbf as jhbf  # noqa: E402
from jstsp19_tpu.harness import pipeline as jpipe  # noqa: E402
from jstsp19_tpu.ops.kron import KronDictOp as JKron  # noqa: E402
from jstsp19_tpu.solvers import estim as jestim  # noqa: E402
from jstsp19_tpu.solvers.vamp import vamp_glm as jvamp_glm  # noqa: E402
from jstsp19_torch.ops.kron import KronDictOp  # noqa: E402
from jstsp19_torch.solvers import estim  # noqa: E402
from jstsp19_torch.solvers.vamp import vamp_glm  # noqa: E402

NIT = 100
NOISE_VAR = 10 ** (-15 / 10)


def inputs(n: int):
    """The normal-equations VAMP problem of each realization, scaled as
    ``vamp_mmwave`` scales it, in float64: A, B, y, wvar, beta, Zbar."""
    pc = jpipe.PointConfig(Nt=8, Gt=8, T=5, num_nonzero=50, beamformer="fft")
    keys = jprng.realization_keys(jprng.experiment_key(3), 0, n)

    def one(key):
        ch, Psi, N, W = jpipe._system_realization(key, pc, NOISE_VAR)
        Th = pc.T_hbf
        Y_c, W_c = jhbf(ch.H, N[:, :Th], Psi[:, :, :Th], pc.Nr, W)
        A_c, B_c = jpipe._dictionaries(ch, W_c, Psi[:, :, :Th])
        return Y_c @ B_c.conj().T, A_c, B_c @ B_c.conj().T, ch.Zbar

    Yn, A, Bn, Zbar = (np.asarray(v).astype(np.complex128) for v in jax.vmap(one)(keys))
    sa = np.sqrt(np.linalg.eigvalsh(A.conj().transpose(0, 2, 1) @ A)[:, -1])[:, None, None]
    sb = np.sqrt(np.linalg.eigvalsh(Bn @ Bn.conj().transpose(0, 2, 1))[:, -1])[:, None, None]
    s = sa * sb
    Gr, K = A.shape[-1], Bn.shape[-2]
    return dict(A=A / sa, B=Bn / sb, y=Yn / s, wvar=1.0 / s**2, beta=pc.num_nonzero / (2 * Gr * K),
                Zbar=Zbar)


def run_jax(d, cdt, rdt, y=None):
    y = d["y"] if y is None else y

    def one(a, b, yy, w):
        prior = jestim.SparsePrior(jestim.CAwgnPrior(jnp.asarray(0.0, cdt), jnp.asarray(1.0 / d["beta"], rdt)),
                                   jnp.asarray(d["beta"], rdt))
        like = jestim.CAwgnLikelihood(yy, w)
        return jvamp_glm(prior, like, JKron(a, b), nit=NIT).x

    args = (d["A"].astype(cdt), d["B"].astype(cdt), y.astype(cdt), d["wvar"][:, 0, 0].astype(rdt))
    return np.asarray(jax.vmap(one)(*args))


def run_port(d, cdt, rdt):
    t = {k: torch.from_numpy(np.ascontiguousarray(d[k].astype(cdt))) for k in ("A", "B", "y")}
    wvar = torch.from_numpy(d["wvar"].astype(rdt))
    beta = torch.tensor(d["beta"], dtype=getattr(torch, np.dtype(rdt).name))
    prior = estim.SparsePrior(estim.CAwgnPrior(0.0, 1.0 / beta), beta)
    return vamp_glm(prior, estim.CAwgnLikelihood(t["y"], wvar), KronDictOp(t["A"], t["B"]), nit=NIT).x.numpy()


def clamped_nmse(x, Zbar):
    e = np.sum(np.abs(x - Zbar) ** 2, axis=(-2, -1)) / np.sum(np.abs(Zbar) ** 2, axis=(-2, -1))
    return np.minimum(e, 1.0)


def compare(label, got, want, Zbar):
    rel = np.abs(got - want).max(axis=(-2, -1)) / np.abs(want).max(axis=(-2, -1))
    eg, ew = clamped_nmse(got, Zbar), clamped_nmse(want, Zbar)
    print(f"{label}: max per-realization max|dx|/max|x| = {rel.max():.3e} (median {np.median(rel):.3e}); "
          f"max |dNMSE| = {np.abs(eg - ew).max():.3e}; batch mean NMSE {eg.mean():.6f} vs {ew.mean():.6f}; "
          f"at the clamp {np.mean(eg >= 1.0):.3f} vs {np.mean(ew >= 1.0):.3f}", flush=True)
    return rel


def main(argv) -> int:
    n = int(argv[0]) if argv else 64
    d = inputs(n)
    print(f"errorVSframelength T=5, experiment_key(3), sweep index 0, {n} realizations, "
          f"VAMP-GLM {NIT} iterations, normal-equations form; x {d['A'].shape[-1]}x{d['B'].shape[-2]}")
    Z = d["Zbar"]
    x32_j = run_jax(d, np.complex64, np.float32)
    x32_p = run_port(d, np.complex64, np.float32)
    compare("float32  port vs JAX", x32_p, x32_j, Z)
    jax.config.update("jax_enable_x64", True)
    x64_j = run_jax(d, np.complex128, np.float64)
    x64_p = run_port(d, np.complex128, np.float64)
    compare("float64  port vs JAX", x64_p, x64_j, Z)
    y_ulp = d["y"] * (1 + np.finfo(np.float32).eps)
    x64_u = run_jax(d, np.complex128, np.float64, y=y_ulp)
    compare("float64  JAX, y moved by one float32 ulp, vs JAX", x64_u, x64_j, Z)
    compare("float32 JAX vs float64 JAX", x32_j.astype(np.complex128), x64_j, Z)
    compare("float32 port vs float64 JAX", x32_p.astype(np.complex128), x64_j, Z)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
