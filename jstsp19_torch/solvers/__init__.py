from jstsp19_torch.solvers.lowrank import svt  # noqa: F401
from jstsp19_torch.solvers.sparse import soft_threshold  # noqa: F401
from jstsp19_torch.solvers.admm import (  # noqa: F401
    AdmmResult,
    AdmmState,
    admm_hyperparams,
    proposed_admm,
    proposed_admm_angles,
    support_rank_from_order,
)
