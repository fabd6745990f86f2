"""jstsp19_torch — the PyTorch and CUDA port of ``jstsp19_tpu`` for one NVIDIA
Hopper GPU (H100).

Wideband mmWave MIMO channel estimation via random spatial sampling
(Vlachos, Alexandropoulos, Thompson, IEEE JSTSP 13(5), 2019).  The layout
mirrors the JAX package, which stays the reference:

  core/      configs, role-keyed torch.Generator streams, metrics, dtypes
  channel/   wideband frequency-selective mmWave channel generator
  frontend/  beamformers, 4-QAM, training frames, HBF measurement
  ops/       Jacobi schedules, warm-started tracked SVT, the implicit
             Kronecker dictionary operator, the dense, Fourier and
             structured operators of the GAMP path
  solvers/   soft threshold and the l1 ADMM, SVT, the proposed ADMM, the LS,
             OMP and VAMP baselines, the estimators, GAMP, AMP (S-AMP),
             VAMP-SLM and the state evolutions
  utils/     the discrete-distribution helpers
  kernels/   hand-written CUDA kernels (sm_90a) with their plain versions
  harness/   the batched pipeline, the sweep runner, the experiment
             registry and artifacts (``python -m jstsp19_torch``)
  parallel/  torch.distributed: ranks sharing each sweep point, the launcher,
             the sharded ADMM step, ring collectives, the dryrun
  interop    numpy bridge from the JAX package's arrays and artifacts

Plain functions on tensors; a batch of realizations is a leading dimension.
This package imports neither ``jax`` nor ``jstsp19_tpu``.
"""

__version__ = "0.1.0"

from jstsp19_torch.core.config import SystemConfig, canonical_system  # noqa: F401
