"""The port's operators of the GAMP path against the JAX package on the same
numpy inputs: ``mv``, ``rmv``, ``sq_mv`` and ``sq_rmv`` of every ported
operator (each JAX operator carried over by ``interop.op_to_torch``), the
adjoint identity ⟨Ax, y⟩ = ⟨x, Aᴴy⟩, batches of realizations, and the
round trip through ``interop.op_to_numpy``."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jstsp19_tpu.ops import base as jbase  # noqa: E402
from jstsp19_tpu.ops import fourier as jfourier  # noqa: E402
from jstsp19_tpu.ops import masked as jmasked  # noqa: E402
from jstsp19_tpu.ops import structured as jstructured  # noqa: E402
from jstsp19_torch import interop  # noqa: E402
from jstsp19_torch.ops.fourier import FWHTOp  # noqa: E402
from jstsp19_torch.ops.structured import SubsetOp  # noqa: E402

RNG = np.random.default_rng(0)  # the operators' own tensors, drawn once at collection


def _r(*s, rng=RNG):
    return rng.standard_normal(s).astype(np.float32)


def _c(*s, rng=RNG):
    return ((rng.standard_normal(s) + 1j * rng.standard_normal(s)) / np.sqrt(2)).astype(np.complex64)


def _cases():
    """(name, JAX operator, input is complex) for every ported operator."""
    A = _c(24, 32)
    idx = tuple(int(i) for i in RNG.choice(64, 20, replace=False))
    return [
        ("MatrixOp real", jbase.MatrixOp(jnp.asarray(_r(24, 32))), False),
        ("MatrixOp complex", jbase.MatrixOp(jnp.asarray(A)), True),
        ("AdjointOp", jbase.AdjointOp(jbase.MatrixOp(jnp.asarray(A))), True),
        ("ScaledOp", jbase.ScaledOp(jbase.MatrixOp(jnp.asarray(A)), jnp.asarray(0.5 - 2.0j, jnp.complex64)), True),
        ("ComposedOp", jbase.ComposedOp(jbase.MatrixOp(jnp.asarray(_c(16, 24))), jbase.MatrixOp(jnp.asarray(A))),
         True),
        ("MaskOp", jmasked.MaskOp(jnp.asarray((RNG.random((8, 12)) < 0.5).astype(np.float32))), True),
        ("DiagOp", jmasked.DiagOp(jnp.asarray(_c(32))), True),
        ("IdentityOp", jstructured.IdentityOp(32), True),
        ("SubsetOp of FWHTOp", jstructured.SubsetOp(jfourier.FWHTOp(64), idx), False),
        ("SubsetOp, repeated rows", jstructured.SubsetOp(jfourier.FWHTOp(64), (3, 7, 3, 60, 7, 3)), False),
        ("UnifVarOp", jstructured.UnifVarOp(jbase.MatrixOp(jnp.asarray(A))), True),
        ("UnifVarOp, partial", jstructured.UnifVarOp(jbase.MatrixOp(jnp.asarray(A)), in_avg=20, out_avg=10), True),
        ("FWHTOp sequency", jfourier.FWHTOp(64), False),
        ("FWHTOp natural, complex", jfourier.FWHTOp(64, "natural"), True),
        ("DFTOp", jfourier.DFTOp(32), True),
        ("ToeplitzOp", jfourier.ToeplitzOp(jnp.asarray(_c(20)), jnp.asarray(np.r_[0, _c(31)].astype(np.complex64))),
         True),
        ("DCTOp", jfourier.DCTOp(32), False),
    ]


CASES = _cases()


def _inputs(jop, cplx, batch=()):
    rng = np.random.default_rng(len(batch))
    shape_in, shape_out = tuple(jop.in_shape), tuple(jop.out_shape)
    mk = _c if cplx else _r
    return mk(*batch, *shape_in, rng=rng), mk(*batch, *shape_out, rng=rng)


def _close(got, want, rtol):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("name,jop,cplx", CASES, ids=[c[0] for c in CASES])
def test_operator_matches_jax(name, jop, cplx):
    """mv/rmv/sq_mv/sq_rmv at max|Δ| ≤ 1e-5·max|ref|: float32 products and
    FFTs summed in another order (measured ≤ 3.4e-7)."""
    if name.startswith("ToeplitzOp"):  # row[0] must equal col[0]
        jop = jfourier.ToeplitzOp(jop.col, jop.row.at[0].set(jop.col[0]))
    op = interop.op_to_torch(jop)
    x, y = _inputs(jop, cplx)
    _close(op.mv(torch.from_numpy(x)).numpy(), jop.mv(x), 1e-5)
    _close(op.rmv(torch.from_numpy(y)).numpy(), jop.rmv(y), 1e-5)
    vx, vy = np.abs(x).astype(np.float32), np.abs(y).astype(np.float32)
    _close(op.sq_mv(torch.from_numpy(vx)).numpy(), jop.sq_mv(vx), 1e-5)
    _close(op.sq_rmv(torch.from_numpy(vy)).numpy(), jop.sq_rmv(vy), 1e-5)
    # the adjoint identity <A x, y> = <x, Aᴴ y>, to 1e-5 of |A x|·|y|
    xt, yt = torch.from_numpy(x).to(torch.complex128), torch.from_numpy(y).to(torch.complex128)
    lhs = torch.vdot(op.mv(torch.from_numpy(x)).to(torch.complex128).flatten(), yt.flatten())
    rhs = torch.vdot(xt.flatten(), op.rmv(torch.from_numpy(y)).to(torch.complex128).flatten())
    scale = float(op.mv(torch.from_numpy(x)).abs().norm() * yt.abs().norm())
    assert abs(complex(lhs - rhs)) <= 1e-5 * scale
    # the round trip through numpy gives the same operator
    again = interop.op_to_torch(interop.op_to_numpy(op))
    assert torch.equal(again.mv(torch.from_numpy(x)), op.mv(torch.from_numpy(x)))


@pytest.mark.parametrize("name,jop,cplx", [c for c in CASES if c[0] != "MaskOp"],
                         ids=[c[0] for c in CASES if c[0] != "MaskOp"])
def test_operator_on_a_batch(name, jop, cplx):
    """A leading batch of 3 realizations through one shared operator equals
    three JAX calls (same tolerance as above)."""
    if name.startswith("ToeplitzOp"):
        jop = jfourier.ToeplitzOp(jop.col, jop.row.at[0].set(jop.col[0]))
    op = interop.op_to_torch(jop)
    x, y = _inputs(jop, cplx, batch=(3,))
    _close(op.mv(torch.from_numpy(x)).numpy(), np.stack([jop.mv(v) for v in x]), 1e-5)
    _close(op.rmv(torch.from_numpy(y)).numpy(), np.stack([jop.rmv(v) for v in y]), 1e-5)


def test_subset_op_with_one_row_set_per_realization():
    """SubsetOp with (B, m) rows equals B JAX SubsetOps with static tuples;
    the adjoint accumulates repeated rows (max|Δ| ≤ 1e-6·max|ref|: the FWHT
    is bit-equal, the scatter-add sums at most three terms)."""
    n, rng = 128, np.random.default_rng(1)
    rows = np.stack([rng.choice(n, 40), rng.choice(n, 40)])  # with repeats
    op = SubsetOp(FWHTOp(n), torch.from_numpy(rows))
    x, y = _r(2, n, rng=rng), _r(2, 40, rng=rng)
    jops = [jstructured.SubsetOp(jfourier.FWHTOp(n), tuple(int(i) for i in r)) for r in rows]
    for fn in ("mv", "sq_mv"):
        _close(getattr(op, fn)(torch.from_numpy(np.abs(x) if fn == "sq_mv" else x)).numpy(),
               np.stack([getattr(j, fn)(np.abs(v) if fn == "sq_mv" else v) for j, v in zip(jops, x)]), 1e-6)
    for fn in ("rmv", "sq_rmv"):
        _close(getattr(op, fn)(torch.from_numpy(np.abs(y) if fn == "sq_rmv" else y)).numpy(),
               np.stack([getattr(j, fn)(np.abs(v) if fn == "sq_rmv" else v) for j, v in zip(jops, y)]), 1e-6)
    # <A x, y> = <x, Aᴴ y> per realization with repeated rows
    lhs = (op.mv(torch.from_numpy(x)).double() * torch.from_numpy(y).double()).sum(-1)
    rhs = (torch.from_numpy(x).double() * op.rmv(torch.from_numpy(y)).double()).sum(-1)
    torch.testing.assert_close(lhs, rhs, rtol=1e-5, atol=1e-5)


def test_matrix_op_with_one_matrix_per_realization():
    """MatrixOp with a (B, m, n) A: one product per realization, and the
    Gram eigenbasis reproduces AᴴA (1e-5 of its largest entry)."""
    rng = np.random.default_rng(2)
    A, x = _c(2, 12, 16, rng=rng), _c(2, 16, rng=rng)
    op = interop.op_to_torch({"type": "MatrixOp", "A": A})
    want = np.stack([np.asarray(jbase.MatrixOp(jnp.asarray(a)).mv(v)) for a, v in zip(A, x)])
    _close(op.mv(torch.from_numpy(x)).numpy(), want, 1e-5)
    V, _, d = op.gram_in_eig()
    gram = torch.from_numpy(A).mH @ torch.from_numpy(A)
    _close((V @ torch.diag_embed(d.to(V.dtype)) @ V.mH).numpy(), gram.numpy(), 1e-5)
    assert op.H.mv(torch.from_numpy(_c(2, 12, rng=rng))).shape == (2, 16)
