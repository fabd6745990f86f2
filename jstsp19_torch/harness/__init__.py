from jstsp19_torch.harness.pipeline import (  # noqa: F401
    PointConfig,
    fused_point_errors,
    proposed_problem,
    realization_errors,
)
