from jstsp19_torch.channel.widemmwave import (  # noqa: F401
    Channel,
    beamspace,
    channel_from_taps,
    dft_dictionary,
    quirk_laplacian,
    taps_to_subcarriers,
    truncated_laplacian,
    ula_steering,
    wideband_mmwave_channel,
)
