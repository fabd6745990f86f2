from jstsp19_torch.ops.tracked import make_tracked_svt  # noqa: F401
