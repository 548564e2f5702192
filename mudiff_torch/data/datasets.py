"""Slice datasets over preprocessed .npy stacks.

The port's copy of ``mudiff_tpu/data/datasets.py`` (parity source:
dataset/dataset_brats.py; ORDERS :29-34, loading :53-66, normalisation
clamp(+-3 sigma)/3 :83,91), plus the ISLES orders of the reference
README (:81).  Pure numpy.  Slices are stored z-scored
(``preprocess.py``); a batch is clamped to +-3 sigma and divided by 3,
giving [-1, 1] images in NHWC.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mudiff_torch.data import _native

BRATS_ORDERS: Dict[str, List[str]] = {
    "T1CE": ["FLAIR", "T2", "T1", "T1CE"],
    "FLAIR": ["T1CE", "T1", "T2", "FLAIR"],
    "T2": ["T1CE", "T1", "FLAIR", "T2"],
    "T1": ["FLAIR", "T1CE", "T2", "T1"],
}

# ISLES2015: conditions -> target (reference README.md:81)
ISLES_ORDERS: Dict[str, List[str]] = {
    "FLAIR": ["T1", "T2", "DWI", "FLAIR"],
    "T1": ["T2", "DWI", "FLAIR", "T1"],
}


class SliceDataset:
    """Multi-contrast slice dataset: three condition slices and the target.

    ``orders`` selects the family (``BRATS_ORDERS`` / ``ISLES_ORDERS``);
    ``use_mmap`` memory-maps the stacks instead of reading them;
    ``native`` lets ``gather_batch`` use the native gather.
    """

    def __init__(
        self,
        split: str = "train",
        base_path: str = "data/BRATS",
        target_modality: str = "T1CE",
        use_mmap: bool = False,
        orders: Optional[Dict[str, List[str]]] = None,
        native: bool = True,
    ) -> None:
        orders = orders or BRATS_ORDERS
        if target_modality not in orders:
            raise ValueError(
                f"Invalid target_modality {target_modality}; choose from {sorted(orders)}")
        self.split = split
        self.base_path = base_path
        self.modality_order = orders[target_modality]
        self.native = native
        self._data: Dict[str, np.ndarray] = {}
        for mod in self.modality_order:
            fp = os.path.join(base_path, split, f"{mod}.npy")
            if not os.path.isfile(fp):
                raise FileNotFoundError(fp)
            arr = np.load(fp, mmap_mode="r" if use_mmap else None)
            if not use_mmap:
                arr = np.ascontiguousarray(arr, dtype=np.float32)
            self._data[mod] = arr
        shp = self._data[self.modality_order[0]].shape
        self.length = shp[0]
        self.image_shape = (shp[1], shp[2])

    def __len__(self) -> int:
        return self.length

    @staticmethod
    def normalize(x: np.ndarray) -> np.ndarray:
        """z-score -> [-1, 1]: clamp to +-3 sigma, divide by 3."""
        return np.clip(x, -3.0, 3.0) / 3.0

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(conditions (H, W, 3), target (H, W, 1)), NHWC order."""
        conds = [self.normalize(self._data[m][idx].astype(np.float32))
                 for m in self.modality_order[:-1]]
        target = self.normalize(self._data[self.modality_order[-1]][idx].astype(np.float32))
        return np.stack(conds, axis=-1), target[..., None]

    def gather_batch(self, indices: np.ndarray,
                     out: Optional[Sequence[np.ndarray]] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(c1, c2, c3, target), each (B, H, W, 1) float32 in [-1, 1],
        written into ``out`` when given."""
        sources = tuple(self._data[m] for m in self.modality_order)
        return _native.gather_normalize4(sources, np.asarray(indices), native=self.native,
                                         out=out)
