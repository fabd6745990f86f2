"""Result artifacts: the JSON curve file and a best-effort matplotlib figure
(counterpart of ``jstsp19_tpu/harness/artifacts.py``; the same JSON)."""
from __future__ import annotations

import os

from jstsp19_torch.harness.runner import SweepResult

_LOG_EXPERIMENTS = {
    "error_vs_snr",
    "error_vs_framelength",
    "error_vs_paths",
    "error_vs_delays",
    "error_vs_nt",
    "error_vs_nrf",
    "error_vs_snr_approx",
    "error_vs_admmiters",
    "error_vs_snr_nyuwireless",
}

# linear-scale y-axis labels for non-NMSE experiments
_YLABELS = {
    "rate_vs_framelength": "ASE (bits/s/Hz)",
    "capacity": "ASE (bits/s/Hz)",
    "energy_efficiency": "EE (bits/Joule)",
}


def save_result(res: SweepResult, out_dir: str = "results", plot: bool = True) -> str:
    os.makedirs(out_dir, exist_ok=True)
    json_path = os.path.join(out_dir, f"{res.name}.json")
    with open(json_path, "w") as f:
        f.write(res.to_json())
    if plot:
        try:
            _plot(res, os.path.join(out_dir, f"{res.name}.png"))
        except Exception as e:  # plotting is best-effort (headless, no matplotlib)
            print(f"[artifacts] plot skipped: {e}")
    return json_path


def _plot(res: SweepResult, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    logy = res.name in _LOG_EXPERIMENTS
    for method, ys in sorted(res.curves.items()):
        if len(ys) != len(res.sweep_values):
            continue
        (ax.semilogy if logy else ax.plot)(res.sweep_values, ys, marker="o", label=method)
    ax.set_xlabel(res.sweep_name)
    ax.set_ylabel("NMSE" if logy else _YLABELS.get(res.name, "value"))
    ax.set_title(f"{res.name} (n_mc={res.n_mc})")
    ax.grid(True, which="both", alpha=0.4)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
