"""Utilities: the discrete-distribution helpers ``DisDist`` and
``weibull_grid`` (``jstsp19_tpu/utils``' native host library is not ported)."""
from jstsp19_torch.utils.distributions import DisDist, weibull_grid  # noqa: F401
