from jstsp19_torch.kernels.admm_fused import fused_tracked_admm  # noqa: F401
