from jstsp19_torch.harness.experiments import EXPERIMENTS, get_experiment  # noqa: F401
from jstsp19_torch.harness.pipeline import (  # noqa: F401
    PointConfig,
    fused_point_errors,
    proposed_problem,
    realization_errors,
)
from jstsp19_torch.harness.runner import SweepResult, run_point, run_sweep  # noqa: F401
