"""The tracked route's N > M ADMM solve as one fused-kernel launch on the transpose.

``kernels/admm_fused.py::fused_tracked_admm`` runs the whole tracked-SVT
ADMM of a realization in one thread block, but only for N ≤ M.  An N > M
problem is the N ≤ M problem on the transpose, term by term: Yᵀ = Bᵀ·Sᵀ·Aᵀ,
so the solve on (subYᵀ, Ωᵀ, A′ = Bᵀ, B′ = Aᵀ, support_rankᵀ) has N′ = M,
M′ = N, Gr′ = K and K′ = Gr; the SVT commutes with transposition (the
tracked chain itself runs N > M on the transpose, its basis on the thin
side M with the same round-robin schedule as the kernel's N′ × N′ basis);
the X-update, soft threshold, duals and norms are elementwise; and
Aᴴ·K·Bᴴ and (AᴴA)·v·(BBᴴ) are the transposes of A′ᴴ·Kᵀ·B′ᴴ and
(A′ᴴA′)·vᵀ·(B′B′ᴴ).  The kernel computes in float32 with no TF32, as the
chain does at every ``track_precision`` that ``ops/tracked.py::PRODUCTS``
maps to 'fp32'; the two differ in summation order and in the rotation
angle's form (the kernel's is trig-free).

:func:`takes` decides from what a ``proposed_admm`` call carries (shapes,
dtypes, device, options), and :func:`solve` answers it.  An answer carries
no convergence log and no state.  ``solve.calls`` counts the calls
answered.
"""
from __future__ import annotations

import numbers

import torch

from jstsp19_torch.kernels import admm_fused
from jstsp19_torch.ops.tracked import PRODUCTS


def _batched(t, batch: int, shape, dtype) -> bool:
    """Whether ``t`` is a ``dtype`` tensor of ``shape``, alone or with one
    leading dimension of ``batch``."""
    return (isinstance(t, torch.Tensor) and t.dtype == dtype and tuple(t.shape[-2:]) == tuple(shape)
            and (t.dim() == 2 or (t.dim() == 3 and t.shape[0] == batch)))


def _per_realization(x, batch: int, device) -> bool:
    """Whether a scalar hyper-parameter is a real number, or a real tensor
    on ``device`` of one value or of one a realization."""
    if isinstance(x, numbers.Real):
        return True
    return (isinstance(x, torch.Tensor) and not x.is_complex() and x.device == device
            and tuple(x.shape) in ((), (1,), (batch,)))


def takes(inputs: dict, options: dict) -> bool:
    """Whether :func:`solve` may answer this ``proposed_admm`` call: one
    that :func:`call_takes`, on a CUDA device, outside any CUDA-graph
    capture.  Every other call keeps the tracked chain."""
    y = inputs["subY"]
    return (isinstance(y, torch.Tensor) and y.is_cuda and call_takes(inputs, options)
            and not torch.cuda.is_current_stream_capturing())


def call_takes(inputs: dict, options: dict) -> bool:
    """The rule of :func:`takes` but for the device: a complex64 ``subY``
    with one leading batch dimension, ``Omega`` float32 and ``A``, ``B``
    complex64 of that batch or shared, ``support_rank`` (if given) an
    integer tensor of the same kind, all on one device; ``tau_Y``, ``tau_S``
    and ``rho`` per realization or one value; the tracked SVT in approximate
    mode with the kernels, no convergence log, no warm start, and a
    ``track_precision`` the chain runs in full float32; N > M with M even,
    and transposed shapes the kernel's shared memory holds."""
    if not (options["svt_method"] == "tracked" and options["mode"] == "approximate" and options["use_kernels"]
            and not options["track_convergence"] and options["init_state"] is None
            and PRODUCTS.get(options["track_precision"]) == "fp32"):
        return False
    y = inputs["subY"]
    if not (isinstance(y, torch.Tensor) and y.dtype == torch.complex64 and y.dim() == 3):
        return False
    batch, N, M = y.shape
    A, B, rank = inputs["A"], inputs["B"], inputs["support_rank"]
    if not (_batched(inputs["Omega"], batch, (N, M), torch.float32) and isinstance(A, torch.Tensor)
            and isinstance(B, torch.Tensor) and A.dim() >= 2 and B.dim() >= 2):
        return False
    Gr, K = A.shape[-1], B.shape[-2]
    if not (_batched(A, batch, (N, Gr), torch.complex64) and _batched(B, batch, (K, M), torch.complex64)):
        return False
    if rank is not None and not (_batched(rank, batch, (Gr, K), rank.dtype)
                                 and not rank.is_floating_point() and not rank.is_complex()):
        return False
    tensors = [inputs["Omega"], A, B] + ([rank] if rank is not None else [])
    if not all(t.device == y.device for t in tensors):
        return False
    if not all(_per_realization(inputs[k], batch, y.device) for k in ("tau_Y", "tau_S", "rho")):
        return False
    return N > M and M % 2 == 0 and admm_fused.fits(M, N, K, Gr)


def operands(inputs: dict) -> dict:
    """The transposed problem's operands, as ``fused_tracked_admm`` takes
    them: contiguous subYᵀ, Ωᵀ, A′ = Bᵀ, B′ = Aᵀ and int32 support_rankᵀ
    (or None), and float32 τ_Y, τ_S and ρ of one a realization."""
    y = inputs["subY"]
    batch, N, M = y.shape

    def t(x, *shape):
        return x.resolve_conj().expand(batch, *shape).transpose(-2, -1).contiguous()

    A, B, rank = inputs["A"], inputs["B"], inputs["support_rank"]
    Gr, K = A.shape[-1], B.shape[-2]
    out = dict(subY=t(y, N, M), Omega=t(inputs["Omega"], N, M), A=t(B, K, M), B=t(A, N, Gr),
               support_rank=None if rank is None else t(rank.to(torch.int32), Gr, K))
    for k in ("tau_Y", "tau_S", "rho"):
        out[k] = torch.as_tensor(inputs[k], dtype=torch.float32, device=y.device).expand(batch).contiguous()
    return out


def solve(inputs: dict, options: dict):
    """``proposed_admm``'s answer to a call :func:`takes`: one
    ``fused_tracked_admm`` launch on :func:`operands`, its S′ and Y′
    transposed back; no convergence log and no state."""
    from jstsp19_torch.solvers.admm import AdmmResult  # solvers.admm imports this module

    S, Y = admm_fused.fused_tracked_admm(
        **operands(inputs), Imax=options["Imax"], track_rounds=options["track_rounds"],
        support_base=options["support_base"], support_step=options["support_step"])
    solve.calls += 1
    return AdmmResult(S=S.transpose(-2, -1).contiguous(), Y=Y.transpose(-2, -1).contiguous(), convergence=None,
                      state=None)


solve.calls = 0
