from jstsp19_torch.frontend.beamformers import create_beamformer  # noqa: F401
from jstsp19_torch.frontend.modulation import qam4_mod  # noqa: F401
from jstsp19_torch.frontend.training import qam4_training_frames, awgn  # noqa: F401
from jstsp19_torch.frontend.measurement import (  # noqa: F401
    ProposedObservation,
    hbf,
    proposed_hbf,
    received_frame,
    sample_omega,
)
