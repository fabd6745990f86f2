"""Phase [23] of ``chip_smoke.py`` alone: the FWHT kernel against the float64
host library, the float64 and complex128 routes on the card against the CPU
with no kernel launched, and the soft threshold at one τ against
``F.softshrink``, after building the four kernels from the checkout.

Run: python tools/torch_routes_card.py    (needs a CUDA device)
"""
import json
import multiprocessing
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_routes_card: no CUDA device", file=sys.stderr)
        return 1
    from jstsp19_torch.bench import card_line
    from jstsp19_torch.kernels import admm_fused, dictionary, softthresh, wht
    from jstsp19_torch.kernels.build import KERNELS, build_all

    card = card_line()
    print(f"[0] device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=chip_smoke._routes_cpu_half, args=(queue, 3), daemon=True)
    proc.start()
    print(f"[1] built {', '.join(KERNELS)} in {build_all(KERNELS)}")
    for module in (admm_fused, dictionary, softthresh, wht):
        module._library()
    kernels = [{"name": name} for name in ("fused_tracked_admm", "dict_correlation", "soft_threshold", "fwht")]
    dev = torch.device("cuda")
    try:
        kernels[3]["native_oracle_max_abs_err"] = chip_smoke._routes_checks(dev, queue)
        chip_smoke._softshrink_times(dev, card, kernels)
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.terminate()
    print(json.dumps({"kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
