"""Inference engines of the port: whole-volume prediction and the
generators' checkpoints."""

from mudiff_torch.infer.generators import load_generators, save_generators
from mudiff_torch.infer.volume import predict_volume

__all__ = ["load_generators", "save_generators", "predict_volume"]
