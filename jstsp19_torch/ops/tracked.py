"""Warm-started tracked singular-value thresholding
(counterpart of ``jstsp19_tpu/ops/tracked.py:31-104``).

The Gram eigenbasis U is carried across solver iterations and refreshed
with ``track_rounds`` parallel-ordering Jacobi rounds per call.  The rounds
act on ``P = Uᴴ·W`` directly (P-form): pair sums of P's rows give the
rotated Gram's entries, each round's rotation has two nonzeros per row and
column so ``U·G`` and ``Gᴴ·P`` are pair gathers, the singular values are
P's row norms after the rounds, and the result is ``U·(f∘P)``.
N > M inputs run on the transpose (``SVT(Xᵀ)ᵀ == SVT(X)``).

The chain's two products run at the ``precision`` the caller names, as
JAX's ``default_matmul_precision`` sets them around the same two products
(``jstsp19_tpu/ops/tracked.py:80-92``); :data:`PRODUCTS` maps each setting
to how the card computes them.  On the CPU every setting is full float32,
as JAX's are there.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from jstsp19_torch.ops.jacobi import _round_robin_schedule, _schedule_gather_tables


# track_precision → how the card computes P = Uᴴ·W and U·(f∘P):
#   'fp32'    one complex64 product in full float32, TF32 off;
#   '3xtf32'  three TF32 products over a hi/lo split of each operand (the
#             counterpart of the TPU's 3-pass bf16 'high'), which no setting
#             maps to any more;
#   'tf32'    one TF32 product ('tensorfloat32' is JAX's name for it).
# The TF32 forms run as real GEMMs of the [Re −Im; Im Re] block form, so
# that TF32 applies whatever cuBLAS does with a complex GEMM.  'default' is
# float32: one TF32 pass failed the eigh-oracle rule of
# tools/torch_precision_shapes.py on an H100 (mc_admm at the canonical
# point, max |ΔNMSE| to eigh 2.7e-3 against a 1e-3 limit; PERF.md §6).
# 'high' is float32 too: the truncating split drops lo·lo and biased the
# mean NMSE by about 1e-6 (paired |z| up to 16 against 'highest'), and its
# 31 kernels took 192 µs a product pair against float32's 29 µs in 3.
PRODUCTS = {"highest": "fp32", "high": "fp32", "default": "fp32", "tensorfloat32": "tf32"}


def split_tf32(x: torch.Tensor):
    """(hi, lo) with ``hi + lo == x`` exactly: hi keeps the sign, exponent
    and the 10 mantissa bits a TF32 operand holds (the low 13 bits
    cleared), lo is the remainder, itself exact in float32."""
    hi = torch.bitwise_and(x.view(torch.int32), -8192).view(torch.float32)
    return hi, x - hi


def tf32_product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """The complex product a·b as real products of the [Re −Im; Im Re]
    block form: one (``passes=1``) or three (``passes=3``: hi·hi + hi·lo +
    lo·hi over :func:`split_tf32`, the lo·lo term dropped) real products.
    TF32 applies where the caller turned it on for CUDA float32 products;
    elsewhere each product is float32."""
    a, b = a.resolve_conj(), b.resolve_conj()
    n = a.shape[-2]
    ar, ai = a.real, a.imag
    A = torch.cat((torch.cat((ar, -ai), -1), torch.cat((ai, ar), -1)), -2)
    Bm = torch.cat((b.real, b.imag), -2)
    if passes == 1:
        C = A @ Bm
    else:
        A_hi, A_lo = split_tf32(A)
        B_hi, B_lo = split_tf32(Bm)
        C = A_hi @ B_hi + (A_hi @ B_lo + A_lo @ B_hi)
    return torch.complex(C[..., :n, :], C[..., n:, :])


@contextlib.contextmanager
def _tf32_products():
    """TF32 on for CUDA float32 products inside the block, then back to
    what it was (``core/config.py::use_full_fp32`` keeps it off elsewhere)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def chain_product(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a·b as the tracked chain computes it in ``mode`` (a value of
    :data:`PRODUCTS`); full float32 on the CPU whatever the mode."""
    if mode == "fp32" or not a.is_cuda:
        return a @ b
    with _tf32_products():
        return tf32_product(a, b, 1 if mode == "tf32" else 3)


@functools.lru_cache(maxsize=None)
def _tables(Ns: int, device: torch.device):
    """The round-robin schedule and its gather tables on ``device``, made
    once a size and device: a step then copies nothing to the device, so a
    CUDA graph can capture the solve that builds it."""
    sched = torch.as_tensor(_round_robin_schedule(Ns), dtype=torch.long, device=device)
    part_t, slot_t, isp_t = (torch.as_tensor(t, device=device) for t in _schedule_gather_tables(Ns))
    return sched, part_t.long(), slot_t.long(), isp_t


def make_tracked_svt(
    N: int, M: int, cdt=torch.complex64, track_rounds: int = 1,
    precision: str = "highest", device=None,
):
    """Build the tracked-SVT step for (..., N, M) inputs.

    Returns ``(U0, step)``: the initial basis (identity, thin side) and
    ``step(W, tau, U, i) -> (X, U2)``, the shrunk matrix and the refreshed
    basis; ``i`` is the solver iteration, which picks the round-robin
    rounds ``(i·track_rounds + j) mod (Ns−1)``.  ``tau`` broadcasts over
    the batch.  ``precision`` ('highest', 'high', 'default' or JAX's
    'tensorfloat32') sets the two products P = Uᴴ·W and U·(f∘P) on the card
    as :data:`PRODUCTS` maps it; the rotations and the shrink run in float32
    at every setting, and the CPU runs everything in float32.
    """
    if precision not in PRODUCTS:
        raise ValueError(f"unknown precision {precision!r}; one of {', '.join(PRODUCTS)}")
    mode = PRODUCTS[precision]
    flip = N > M
    Ns = M if flip else N  # thin side = tracked-basis dimension
    if Ns % 2:
        raise ValueError("tracked SVT needs an even thin dimension")

    sched, part_t, slot_t, isp_t = _tables(Ns, torch.device(device if device is not None else "cpu"))

    def _rounds(U, P, start):
        for j in range(track_rounds):
            ridx = (start + j) % (Ns - 1)
            p, q = sched[ridx, 0], sched[ridx, 1]
            Pp = P[..., p, :]
            Pq = P[..., q, :]
            app = torch.sum(Pp.real**2 + Pp.imag**2, dim=-1)
            aqq = torch.sum(Pq.real**2 + Pq.imag**2, dim=-1)
            apq = torch.sum(Pp * Pq.conj(), dim=-1)
            mag = apq.abs()
            pos = mag > 0
            phase = torch.where(pos, apq / torch.where(pos, mag, torch.ones_like(mag)), 1.0 + 0.0j)
            theta = 0.5 * torch.atan2(2.0 * mag, app - aqq)
            c = torch.cos(theta)
            s = (torch.sin(theta) * phase).to(cdt)
            part, slot, isp = part_t[ridx], slot_t[ridx], isp_t[ridx]
            cf = c[..., slot]
            sf = s[..., slot]
            # G[p,p]=G[q,q]=c, G[p,q]=−s, G[q,p]=s̄ ⇒ elementwise combinations
            bR = torch.where(isp, sf.conj(), -sf)
            bL = torch.where(isp, sf, -sf.conj())
            U = U * cf[..., None, :] + U[..., :, part] * bR[..., None, :]
            P = P * cf[..., :, None] + P[..., part, :] * bL[..., :, None]
        return U, P

    def _step_thin(W, tau, U, i):
        # svt.m's matrix-level NaN reset, as in solvers/lowrank.svt
        ok = torch.all(
            torch.isfinite(W.real) & torch.isfinite(W.imag), dim=-1, keepdim=True
        ).all(dim=-2, keepdim=True)
        Wc = torch.where(ok, W, torch.zeros_like(W))
        P = chain_product(U.mH, Wc, mode)
        U2, P2 = _rounds(U, P, (i * track_rounds) % (Ns - 1))
        sig = torch.sqrt(torch.sum(P2.real**2 + P2.imag**2, dim=-1))
        tau = torch.as_tensor(tau, dtype=sig.dtype, device=sig.device)[..., None]
        pos = sig > 0
        f = torch.where(
            pos, torch.clamp(sig - tau, min=0.0) / torch.where(pos, sig, torch.ones_like(sig)), 0.0
        )
        return chain_product(U2, f[..., :, None] * P2, mode), U2

    if flip:
        def step(W, tau, U, i):
            X, U2 = _step_thin(W.transpose(-2, -1), tau, U, i)
            return X.transpose(-2, -1), U2
    else:
        step = _step_thin

    return torch.eye(Ns, dtype=cdt, device=device), step
