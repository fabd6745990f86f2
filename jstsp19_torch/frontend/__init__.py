from jstsp19_torch.frontend.beamformers import create_beamformer  # noqa: F401
from jstsp19_torch.frontend.modulation import qam4_demod, qam4_mod  # noqa: F401
from jstsp19_torch.frontend.quantizer import optimum_uniform_quantizer  # noqa: F401
from jstsp19_torch.frontend.training import awgn, gaussian_training_frames, qam4_training_frames  # noqa: F401
from jstsp19_torch.frontend.measurement import (  # noqa: F401
    ProposedObservation,
    comm_system_training,
    hbf,
    proposed_hbf,
    received_frame,
    sample_omega,
)
