from mudiff_torch.models.critic import (
    DiscriminatorImgLarge,
    DiscriminatorLarge,
    DiscriminatorSmall,
)
from mudiff_torch.models.generator import NCSNppGenerator

__all__ = ["DiscriminatorImgLarge", "DiscriminatorLarge", "DiscriminatorSmall",
           "NCSNppGenerator"]
