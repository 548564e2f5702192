"""Slice data of the port: the datasets, the device loader, the native
gather and the NIfTI preprocessing (``python -m mudiff_torch.data.preprocess``)."""

from mudiff_torch.data.datasets import BRATS_ORDERS, ISLES_ORDERS, SliceDataset
from mudiff_torch.data.loader import DeviceLoader

__all__ = ["BRATS_ORDERS", "ISLES_ORDERS", "SliceDataset", "DeviceLoader"]
