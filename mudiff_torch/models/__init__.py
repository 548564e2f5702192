from mudiff_torch.models.critic import DiscriminatorLarge
from mudiff_torch.models.generator import NCSNppGenerator

__all__ = ["DiscriminatorLarge", "NCSNppGenerator"]
