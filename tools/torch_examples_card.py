"""Phase [22] of ``chip_smoke.py`` alone: the 21 worked examples on the card
(the launcher's processes, card against CPU, ``KronDictOp.rmv``'s routes, 2
ranks sharing the card, best-of-3 solve times), after building the four
kernels from the checkout.

Run: python tools/torch_examples_card.py    (needs a CUDA device)
"""
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_examples_card: no CUDA device", file=sys.stderr)
        return 1
    from jstsp19_torch.bench import card_line
    from jstsp19_torch.kernels import admm_fused, dictionary, softthresh, wht
    from jstsp19_torch.kernels.build import KERNELS, build_all

    card = card_line()
    print(f"[0] device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    print(f"[1] built {', '.join(KERNELS)} in {build_all(KERNELS)}")
    for module in (admm_fused, dictionary, softthresh, wht):
        module._library()
    chip_smoke._examples(ROOT, torch.device("cuda"), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
