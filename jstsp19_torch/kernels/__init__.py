"""Hand-written CUDA kernels (sm_90a) with their plain PyTorch versions:
``admm_fused``, ``dictionary``, ``softthresh`` and ``wht``, built by ``build``."""


def launch_counts():
    """{kernel: launches} of each kernel wrapper in this process."""
    from jstsp19_torch.kernels import admm_fused, dictionary, softthresh, wht

    return {"fused_tracked_admm": admm_fused.fused_tracked_admm.launches,
            "fused_tracked_admm_512": admm_fused.fused_tracked_admm.wide_launches,
            "dict_correlation": dictionary.dict_correlation.launches,
            "soft_threshold": softthresh.fused_soft_threshold.launches, "fwht": wht.fwht_kernel.launches}
