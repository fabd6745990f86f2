"""Where the time goes in the port's specialized recipes on a GPU.

The approximate front end (``plot_errorVSsnr_approx.m``) at its 0 dB point,
B=256: the front end (channel and ``comm_system_training``), the
hyper-parameters, each (mode, Imax) solve with its LS de-mixing, each the
best, median and spread of ``bench.REPS`` CUDA-event reps; then
``torch.profiler`` over one approximate and one exact solve at Imax=10
(wall time, device self time, busy share, device events an iteration and
the largest device items).  Then one capacity point at n_mc=10000 and
Nr=128: channel synthesis and each front end's ``slogdet`` batch.

Usage: ``python tools/torch_specialized_profile.py`` (needs a CUDA device).
"""
from __future__ import annotations

import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO) if REPO not in sys.path else None

from jstsp19_torch.bench import REPS, card_line, cuda_event_times  # noqa: E402
from jstsp19_torch.channel import wideband_mmwave_channel  # noqa: E402
from jstsp19_torch.core import prng  # noqa: E402
from jstsp19_torch.core.metrics import combined_spectral_efficiency, spectral_efficiency  # noqa: E402
from jstsp19_torch.frontend import create_beamformer, qam4_training_frames  # noqa: E402
from jstsp19_torch.harness import experiments as ex  # noqa: E402
from jstsp19_torch.kernels import dictionary, softthresh  # noqa: E402
from jstsp19_torch.kernels.build import KERNELS, build_all  # noqa: E402
from jstsp19_torch.solvers.admm import proposed_admm  # noqa: E402
from jstsp19_torch.solvers.lsq import ls_estimate  # noqa: E402

B = 256


def _report(label, fn, card):
    t, _ = cuda_event_times(fn, REPS)
    best, median = min(t), sorted(t)[len(t) // 2]
    print(f"{label}: best {best * 1e3:.3f} ms, median {median * 1e3:.3f} ms, spread {(max(t) - best) * 1e3:.3f} ms "
          f"({REPS} reps; {card})", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    build_all(KERNELS)
    dictionary._library()
    softthresh._library()
    dev, card = torch.device("cuda"), card_line()
    ex._start(dev)

    def problem(r):
        return ex._approx_problem(prng.realization_generators(r, 3, dev), 1.0, B, T=70, sub_ratio=0.75)

    prob = problem(0)
    Yp, Omega, A, Bm, Zbar = prob
    hp = ex._approx_hyperparams(Yp)
    _report("approx front end (channel + comm_system_training + dictionaries)", problem, card)
    _report("approx hyper-parameters", lambda r: ex._approx_hyperparams(Yp), card)
    for mode in ("exact", "approximate"):
        for Imax in (10, 30, 50):
            _report(f"approx {mode} Imax={Imax} solve + LS", lambda r: ls_estimate(
                proposed_admm(Yp, Omega, A, Bm, Imax, *hp, mode=mode).Y, A, Bm), card)

    from torch.profiler import ProfilerActivity, profile

    for mode in ("approximate", "exact"):
        def solve():
            return proposed_admm(Yp, Omega, A, Bm, 10, *hp, mode=mode).Y

        solve()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            solve()
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
        kern = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
        dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
        events = sum(e.count for e in kern)
        print(f"profile, one {mode} solve at Imax=10, B={B}: wall {wall_ms:.3f} ms, device self time {dev_ms:.3f} ms, "
              f"busy share {dev_ms / wall_ms:.3f}, {events / 10:.1f} device events an iteration ({card})")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"  {e.key[:90]:90s} count {e.count:5d} device {e.self_device_time_total / 1e3:8.3f} ms")

    n, (Nt, Nr, Mr_e) = 10000, (16, 128, 64)
    gens = prng.realization_generators(0, 5, dev)

    def frame(r):
        ch = wideband_mmwave_channel(gens[prng.ROLE_CHANNEL], 4, Nr, Nt, 2, 3, Nr, Nt, batch=(n,))
        Psi = qam4_training_frames(gens[prng.ROLE_TRAINING], Nt, 5, 4, batch=(n,))
        return torch.einsum("...lmn,...lnt->...mt", ch.H, Psi)

    Y = frame(0)
    W_zc = create_beamformer(Nr, "ZC", device=dev)
    G = W_zc[:, :31].mH @ Y
    _report(f"capacity Nr={Nr}, n_mc={n}: channel + training + noiseless frame", frame, card)
    _report(f"capacity Nr={Nr}, n_mc={n}: digital front end, slogdet of {Nr}x{Nr}",
            lambda r: spectral_efficiency(Y, W_zc, 10 ** -1.5, Nt), card)
    _report(f"capacity Nr={Nr}, n_mc={n}: one HBF front end, slogdet of 31x31",
            lambda r: combined_spectral_efficiency(G, 10 ** -1.5, Nt), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
