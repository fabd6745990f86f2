"""Linear operators: the names the JAX package's ``ops`` exports, under the
same names, and the tracked SVT's ``make_tracked_svt``, each imported on first
use (``kernels/admm_fused.py`` imports ``ops.jacobi``)."""
import importlib

_EXPORTS = {
    **dict.fromkeys(("LinOp", "MatrixOp", "ScaledOp", "ComposedOp", "ConcatOp", "BlockDiagOp"), "base"),
    "KronDictOp": "kron",
    **dict.fromkeys(("MaskOp", "DiagOp"), "masked"),
    **dict.fromkeys(("DFTOp", "FWHTOp", "fwht", "ToeplitzOp", "DCTOp", "dct", "idct"), "fourier"),
    **dict.fromkeys(("IdentityOp", "SubsetOp", "CenterOp", "TVOp", "HaarOp", "MedImageOp", "random_unitary_op",
                     "expander_graph_op", "rbf_kernel_op", "sparse_signed_op", "genie_normal_matvec"), "structured"),
    "make_tracked_svt": "tracked",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
