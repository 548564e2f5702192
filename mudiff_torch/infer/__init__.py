"""Inference engines of the port: whole-volume prediction, the
slice-level test and the generators' checkpoints."""

from mudiff_torch.infer.generators import load_generators, save_generators
from mudiff_torch.infer.slice_test import export_png_pairs, sample_and_test
from mudiff_torch.infer.volume import predict_volume

__all__ = ["load_generators", "save_generators", "predict_volume", "sample_and_test",
           "export_png_pairs"]
