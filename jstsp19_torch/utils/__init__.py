"""Utilities: the host library's float64 oracles (``native_available``,
``native_fwht``, ``native_sparse_conj_mult``, built with g++ at first use)
and the discrete-distribution helpers ``DisDist`` and ``weibull_grid``."""
from jstsp19_torch.utils.native import (  # noqa: F401
    native_available,
    native_fwht,
    native_sparse_conj_mult,
)
from jstsp19_torch.utils.distributions import DisDist, weibull_grid  # noqa: F401
