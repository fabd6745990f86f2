"""Hand-written CUDA kernels (sm_90a) with their plain PyTorch versions:
``admm_fused``, ``dictionary``, ``softthresh`` and ``wht``, built by ``build``."""


def _wrappers():
    """{kernel: the wrapper whose ``launches`` counts its launches}."""
    from jstsp19_torch.kernels import admm_fused, dictionary, softthresh, wht

    return {"fused_tracked_admm": admm_fused.fused_tracked_admm, "dict_correlation": dictionary.dict_correlation,
            "soft_threshold": softthresh.fused_soft_threshold, "fwht": wht.fwht_kernel}


def launch_counts():
    """{kernel: launches} of each kernel wrapper in this process."""
    return {k: f.launches for k, f in _wrappers().items()}


def add_launches(counts):
    """Add ``{kernel: n}`` to the wrappers' counts: the launches a CUDA
    graph's replay makes, or (negative) those its capture recorded and did
    not run."""
    wrappers = _wrappers()
    for k, n in counts.items():
        wrappers[k].launches += n
