"""Role-keyed random streams.

Counterpart of ``jstsp19_tpu/core/prng.py``.  JAX folds one key per
(sweep point, realization, role); here each (seed, sweep_index, role) gets
its own ``torch.Generator``, seeded through ``numpy.random.SeedSequence``,
and a whole batch of realizations draws from it in one call on the target
device.  Consequences:

- the numbers differ from JAX's for the same seed (tests hand both
  packages the same numpy inputs, or compare distributions);
- a realization's draws depend on the batch layout: realization ``b`` of a
  batch of 8 is not realization ``b`` of a batch of 16, and a CUDA
  generator (Philox) gives other numbers than a CPU one (Mersenne twister).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# Stable role tags for independent sub-streams inside one realization.
ROLE_CHANNEL = 0
ROLE_NOISE = 1
ROLE_TRAINING = 2
ROLE_MASK = 3
ROLE_BEAMFORMER = 4
ROLES = (ROLE_CHANNEL, ROLE_NOISE, ROLE_TRAINING, ROLE_MASK, ROLE_BEAMFORMER)


def role_seed(seed: int, sweep_index: int, role: int) -> int:
    """A 64-bit generator seed derived from (seed, sweep_index, role)."""
    ss = np.random.SeedSequence([seed, sweep_index, role])
    return int(ss.generate_state(1, np.uint64)[0])


def role_generator(seed: int, sweep_index: int, role: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(role_seed(seed, sweep_index, role))
    return g


def realization_generators(seed: int, sweep_index: int, device) -> Dict[int, torch.Generator]:
    """One generator per role for one sweep point — the counterpart of
    ``realization_keys`` + ``role_key``; the batch size is given where the
    draws are made."""
    return {r: role_generator(seed, sweep_index, r, device) for r in ROLES}


def complex_normal(
    gen: torch.Generator, shape, dtype=torch.complex64, var=1.0
) -> torch.Tensor:
    """Circularly-symmetric complex Gaussian CN(0, var) on ``gen``'s device.

    Matches the reference construction ``sqrt(v/2)*(randn + 1j*randn)``
    (``plot_errorVSsnr.m:60``).  ``var`` may be a tensor that broadcasts
    against ``shape``.
    """
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    x = torch.randn((2, *shape), generator=gen, dtype=rdt, device=gen.device)
    scale = torch.sqrt(torch.as_tensor(var, dtype=rdt, device=gen.device) / 2)
    return torch.complex(x[0], x[1]) * scale


# -- JAX's key derivations for the solvers that take a key ----------------------
#
# A solver that takes a JAX key takes a ``torch.Generator`` in its place and
# derives sub-streams with these three helpers, so that every draw a solver
# makes goes through ``normal``.  ``fold_in`` and ``split`` leave their
# argument's state alone, as JAX's do: they seed new generators on the same
# device from the argument's seed.


def fold_in(gen: torch.Generator, data: int) -> torch.Generator:
    """A generator derived from ``gen``'s seed and ``data`` (``jax.random.fold_in``)."""
    g = torch.Generator(device=gen.device)
    g.manual_seed(int(np.random.SeedSequence([gen.initial_seed(), 1, data]).generate_state(1, np.uint64)[0]))
    return g


def split(gen, n: int):
    """``n`` generators derived from ``gen`` (``jax.random.split``); a key of
    None, which a solver given explicit initial values never reads, splits
    into Nones."""
    if gen is None:
        return (None,) * n
    out = []
    for i in range(n):
        g = torch.Generator(device=gen.device)
        g.manual_seed(int(np.random.SeedSequence([gen.initial_seed(), 2, i]).generate_state(1, np.uint64)[0]))
        out.append(g)
    return tuple(out)


def normal(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """Standard normal draws of ``shape`` (its leading axis the batch) in the
    real ``dtype``, made on ``gen``'s device and moved to ``device``: a CPU
    generator gives a card run the CPU's numbers."""
    return torch.randn(tuple(shape), generator=gen, dtype=dtype, device=gen.device).to(device)
