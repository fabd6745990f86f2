from jstsp19_torch.core.config import SystemConfig, canonical_system  # noqa: F401
from jstsp19_torch.core.metrics import nmse, clamped_nmse  # noqa: F401
