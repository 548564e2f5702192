from mudiff_torch.diffusion.sampling import (
    extract,
    q_sample,
    q_sample_pairs,
    sample_from_model,
    sample_posterior,
    sample_posterior_combine,
    uncer_loss,
)
from mudiff_torch.diffusion.schedule import (
    DiffusionCoefficients,
    PosteriorCoefficients,
    get_sigma_schedule,
    get_time_schedule,
)
