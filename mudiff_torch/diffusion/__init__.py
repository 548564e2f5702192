from mudiff_torch.diffusion.sampling import (
    extract,
    sample_from_model,
    sample_posterior_combine,
)
from mudiff_torch.diffusion.schedule import PosteriorCoefficients, get_sigma_schedule
