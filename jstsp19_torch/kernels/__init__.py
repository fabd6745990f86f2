"""Hand-written CUDA kernels (sm_90a) with their plain PyTorch versions:
``admm_fused``, ``dictionary``, ``softthresh`` and ``wht``, built by ``build``."""
