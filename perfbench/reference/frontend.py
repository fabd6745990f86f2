"""The front end of one Monte-Carlo point, written out plainly from the scripts.

``plot_errorVSsnr.m:48-146`` for a batch of realizations: the wideband
channel (``wideband_mmwave_channel.m:13-36``) and its beamspace, the 4-QAM
Toeplitz training (``hbf.m:12-20``), white noise, the analog combiner
(``createBeamformer.m``), random spatial sampling (``proposed_hbf.m:36-41``),
the dictionaries A and B and the hyper-parameters (``plot_errorVSsnr.m:127-130``).

The random numbers are the point's inputs.  They come from one
``torch.Generator`` per role on the run's device, seeded from
(seed, sweep index, role) through ``numpy.random.SeedSequence``, and each role
draws its numbers in one call per quantity, in the order listed in
:func:`draw`.  That is the stream layout the measured program documents for a
point, so both sides see the same realizations; everything computed from the
numbers is computed here again, with every matrix product through
:class:`Products`.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

ROLE_CHANNEL, ROLE_NOISE, ROLE_TRAINING, ROLE_MASK = 0, 1, 2, 3
SIGMA_PHI = 50.0 * math.pi / 180.0  # Laplacian angular spread, wideband_mmwave_channel.m:15
ZC_ROOT = 11  # createBeamformer.m:16


class Products:
    """Every matrix product of the reference.  ``tf32`` rounds both operands
    to TF32 (10 stored mantissa bits, round to nearest even) before a float32
    product, as a tensor core in TF32 mode takes them: the control's
    precision, one step below the float32 that the configuration states."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = to_tf32(a), to_tf32(b)
        return a @ b


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32 or complex64) with each float rounded to TF32."""
    x = x.resolve_conj()
    real = torch.view_as_real(x) if x.is_complex() else x
    bits = real.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    out = bits.view(torch.float32)
    return torch.view_as_complex(out) if x.is_complex() else out


def role_generator(seed: int, sweep_index: int, role: int, device) -> torch.Generator:
    state = np.random.SeedSequence([seed, sweep_index, role]).generate_state(1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state))
    return g


def draw(point: Mapping, noise_var: float, batch: int, seed: int, sweep_index: int, device) -> Dict[str, torch.Tensor]:
    """The raw random numbers of a point, role by role and in order:
    channel (path gains, receive angles, transmit angles), training symbols,
    noise, mask scores."""
    L, Nr, Nt = point["L"], point["Nr"], point["Nt"]
    Np = point["n_clusters"] * point["n_rays"]
    T = point["T"] * Nt  # the proposed receiver's training length, T·Nt
    f32 = torch.float32
    g = role_generator(seed, sweep_index, ROLE_CHANNEL, device)
    gains = torch.randn((2, batch, L, Np), generator=g, dtype=f32, device=device)
    u_r = torch.rand((batch, L, Np), generator=g, dtype=f32, device=device)
    u_t = torch.rand((batch, L, Np), generator=g, dtype=f32, device=device)
    g = role_generator(seed, sweep_index, ROLE_TRAINING, device)
    symbols = torch.randint(0, 4, (batch, Nt, T), generator=g, device=device)
    g = role_generator(seed, sweep_index, ROLE_NOISE, device)
    noise = torch.randn((2, batch, Nr, T), generator=g, dtype=f32, device=device)
    g = role_generator(seed, sweep_index, ROLE_MASK, device)
    scores = torch.rand((batch, T, point["Mr_e"]), generator=g, dtype=f32, device=device)
    return dict(gains=gains, u_r=u_r, u_t=u_t, symbols=symbols, noise=noise, scores=scores,
                noise_var=torch.tensor(noise_var, dtype=f32, device=device))


def laplacian_angles(u: torch.Tensor) -> torch.Tensor:
    """Inverse CDF of the Laplacian of spread ``SIGMA_PHI`` truncated to
    [-pi, pi], at u - 1/2 for u uniform on [0, 1)."""
    u = u - 0.5
    b = SIGMA_PHI / math.sqrt(2.0)
    return -b * torch.sign(u) * torch.log1p(-2.0 * u.abs() * (1.0 - math.exp(-math.pi / b)))


def steering(phi: torch.Tensor, n: int) -> torch.Tensor:
    """ULA response exp(j·pi·sin(phi)·m), m = 0..n-1 (half-wavelength spacing)."""
    m = torch.arange(n, dtype=torch.float32, device=phi.device)
    return torch.exp(1j * (math.pi * torch.sin(phi)[..., None] * m))


def dft(n: int, g: int, device) -> torch.Tensor:
    """Beamspace dictionary exp(-j·2pi·m·k/g)/sqrt(n), (n, g)."""
    m = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    k = torch.arange(g, dtype=torch.float32, device=device)[None, :]
    return torch.exp(-2j * math.pi * m * k / g) / math.sqrt(n)


def combiner(kind: str, n: int, device) -> torch.Tensor:
    """The deterministic analog combiners of ``createBeamformer.m``: column c
    has phases n·omega_c, unit norm."""
    if kind == "ZC":
        omega = ZC_ROOT * math.pi * torch.arange(1, n + 1, dtype=torch.float32, device=device) / n
    elif kind in ("fft", "ps"):
        omega = 2.0 * math.pi * torch.arange(n, dtype=torch.float32, device=device) / n
    else:
        raise ValueError(f"the reference has no combiner {kind!r}")
    rows = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    return torch.exp(-1j * rows * omega[None, :]) / math.sqrt(n)


def received(point: Mapping, d: Mapping[str, torch.Tensor], mm: Products) -> Dict[str, torch.Tensor]:
    """What both receivers share, from the raw draws: the true beamspace
    channel Zbar (B, Gr, L·Gt), the training Psi (B, L, Nt, T), the received
    frame R = Σ_l H_l·Psi_l + noise (B, Nr, T) before any combiner, T the
    proposed receiver's training length, and the dictionaries Dr (Nr, Gr)
    and Dt (Nt, Gt)."""
    L, Nr, Nt, Gr, Gt = point["L"], point["Nr"], point["Nt"], point["Gr"], point["Gt"]
    Np = point["n_clusters"] * point["n_rays"]
    dev = d["gains"].device
    batch = d["gains"].shape[1]
    T = d["noise"].shape[-1]

    # channel: H_l = sqrt(1/Np)·Σ_p alpha_p a_r(phi_r,p) a_t(phi_t,p)^H per tap
    alpha = torch.complex(d["gains"][0], d["gains"][1]) * math.sqrt(0.5)
    a_r = steering(laplacian_angles(d["u_r"]), Nr)  # (B, L, Np, Nr)
    a_t = steering(laplacian_angles(d["u_t"]), Nt)
    H = mm((a_r * alpha[..., None]).transpose(-2, -1), a_t.conj()) / math.sqrt(Np)  # (B, L, Nr, Nt)
    Dr, Dt = dft(Nr, Gr, dev), dft(Nt, Gt, dev)
    Z = mm(mm(Dr.mH, H), Dt)  # (B, L, Gr, Gt)
    Zbar = Z.permute(0, 2, 1, 3).reshape(batch, Gr, L * Gt)

    # training: antenna k sends toeplitz(s_k); tap l sees its row l
    qam = torch.tensor([1 + 1j, -1 + 1j, 1 - 1j, -1 - 1j], dtype=torch.complex64, device=dev) / math.sqrt(2.0)
    s = qam[d["symbols"]]  # (B, Nt, T)
    lag = torch.arange(L, device=dev)[:, None] - torch.arange(T, device=dev)[None, :]
    rows = s[..., lag.abs()]  # (B, Nt, L, T)
    rows = torch.where(lag >= 0, rows, rows.conj())
    Psi = rows.transpose(1, 2)  # (B, L, Nt, T)

    # received frame R = Σ_l H_l·Psi_l + noise
    noise = torch.complex(d["noise"][0], d["noise"][1]) * torch.sqrt(d["noise_var"] / 2)
    R = mm(H.permute(0, 2, 1, 3).reshape(batch, Nr, L * Nt), Psi.reshape(batch, L * Nt, T)) + noise
    return dict(Zbar=Zbar, Psi=Psi, R=R, Dr=Dr, Dt=Dt)


def frontend(point: Mapping, d: Mapping[str, torch.Tensor], mm: Products) -> Dict[str, torch.Tensor]:
    """The solver's problem and the true beamspace channel from the raw draws:
    Zbar (B, Gr, L·Gt), subY and Omega (B, Mr_e, T·Nt), A (B, Mr_e, Gr),
    B (B, L·Gt, T·Nt), tau_Y, tau_S, rho (B,) and the oracle rank of each
    entry of Zbar (B, Gr, L·Gt), int32."""
    L, Nr, Gr, Gt = point["L"], point["Nr"], point["Gr"], point["Gt"]
    Mr_e, Mr = point["Mr_e"], point["Mr"]
    rx = received(point, d, mm)
    Zbar, Psi, R, Dr, Dt = rx["Zbar"], rx["Psi"], rx["R"], rx["Dr"], rx["Dt"]
    dev = R.device
    batch, _, T = R.shape

    # the wide combiner and the mask
    W_e = combiner(point["beamformer"], Nr, dev)[:, :Mr_e]
    Y_full = mm(W_e.mH, R)  # (B, Mr_e, T)
    order = torch.argsort(d["scores"], dim=-1, stable=True)
    slot = torch.argsort(order, dim=-1, stable=True)  # each output's place in a random permutation
    Omega = (slot < Mr).to(torch.float32).transpose(-2, -1)  # Mr outputs of Mr_e at each instant
    subY = Omega * Y_full

    # dictionaries and hyper-parameters
    A = mm(W_e.mH, Dr).expand(batch, Mr_e, Gr)
    Bd = mm(Dt.mH, Psi).reshape(batch, L * Gt, T)  # block l of rows: Dt^H·Psi_l
    tau_Y = 1.0 / (subY.abs() ** 2).sum(dim=(-2, -1))
    tau_S = 1.0 / (2.0 * (Zbar.abs() ** 2).sum(dim=(-2, -1)))
    gram = mm(subY, subY.mH) if Mr_e <= T else mm(subY.mH, subY)
    top = min(6, Mr_e, T)  # the sixth largest eigenvalue, as MATLAB's eigs(., 6)
    lam = torch.linalg.eigvalsh(gram)[..., -top]
    rho = torch.sqrt(torch.clamp(lam, min=0.0) * tau_Y)

    return dict(Zbar=Zbar, subY=subY, Omega=Omega, A=A.contiguous(), B=Bd, tau_Y=tau_Y, tau_S=tau_S, rho=rho,
                rank=oracle_rank(Zbar))


def oracle_rank(Zbar: torch.Tensor) -> torch.Tensor:
    """Algorithm 3's oracle: the place of each entry of each (Gr, K) Zbar when
    |Zbar| is sorted downwards, ties in index order; int32, Zbar's shape."""
    flat = Zbar.abs().reshape(Zbar.shape[0], -1)
    idx = torch.sort(-flat, dim=-1, stable=True).indices
    place = torch.empty_like(idx)
    place.scatter_(-1, idx, torch.arange(flat.shape[-1], device=Zbar.device).expand_as(idx))
    return place.reshape(Zbar.shape).to(torch.int32)
