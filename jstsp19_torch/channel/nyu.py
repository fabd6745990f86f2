"""NYU-Wireless ray-traced channel ingestion (counterpart of
``jstsp19_tpu/channel/nyu.py``).

The reference loads ``basic_system_functions/nywireless_channel.mat``, a cell
array ``Hf{...}`` of per-tap channel matrices (``plot_errorVSsnr_nyuwireless.m:6``),
and scales each tap to a Frobenius norm of sqrt(Nr·Nt) (``:59-70``).  The file
is not part of the reference repository: the loader reads it when a path to
it is given and returns None otherwise.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from jstsp19_torch.core.config import COMPLEX_DTYPE


def load_nyu_taps(mat_path: Optional[str], device=None) -> Optional[torch.Tensor]:
    """The ``Hf`` cell array as an (n_realizations, L, Nr, Nt) complex64
    tensor on ``device`` (the CPU unless named), or None when no path is
    given or the file does not exist."""
    if not mat_path or not os.path.exists(mat_path):
        return None
    import scipy.io

    Hf = scipy.io.loadmat(mat_path, squeeze_me=True).get("Hf")
    if Hf is None:
        raise ValueError(f"{mat_path} has no 'Hf' variable")
    taps = np.stack([np.stack(list(row), axis=0) for row in np.atleast_1d(Hf)], axis=0)
    return torch.from_numpy(taps.astype(np.complex64)).to(device=device, dtype=COMPLEX_DTYPE)


def normalize_taps(H: torch.Tensor) -> torch.Tensor:
    """Each tap of H (..., L, Nr, Nt) scaled to a Frobenius norm of
    sqrt(Nr·Nt) (``plot_errorVSsnr_nyuwireless.m:59-70``)."""
    Nr, Nt = H.shape[-2:]
    norms = torch.sqrt(torch.sum(H.abs() ** 2, dim=(-2, -1), keepdim=True))
    return H / torch.clamp(norms, min=1e-30) * math.sqrt(Nr * Nt * 1.0)
