"""4-QAM (QPSK) modulation (counterpart of ``jstsp19_tpu/frontend/modulation.py``)."""
from __future__ import annotations

import numpy as np
import torch

_S = float(1.0 / np.sqrt(2.0))
QAM4_ALPHABET = np.asarray(
    [_S + 1j * _S, -_S + 1j * _S, _S - 1j * _S, -_S - 1j * _S], "complex64"
)


def qam4_mod(gen: torch.Generator, shape) -> torch.Tensor:
    """Unit-energy 4-QAM symbols drawn uniformly (``qam4mod.m:7-8``)."""
    idx = torch.randint(0, 4, tuple(shape), generator=gen, device=gen.device)
    return torch.from_numpy(QAM4_ALPHABET).to(gen.device)[idx]
