from jstsp19_torch.channel.widemmwave import (  # noqa: F401
    Channel,
    beamspace,
    dft_dictionary,
    quirk_laplacian,
    truncated_laplacian,
    ula_steering,
    wideband_mmwave_channel,
)
