from mudiff_torch.models.generator import NCSNppGenerator

__all__ = ["NCSNppGenerator"]
