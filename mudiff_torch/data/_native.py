"""ctypes binding of the native batch gather (``native/slice_gather.cpp``).

The port's counterpart of ``mudiff_tpu/data/_native.py``.  The C++
source (plain C++ and threads, no CUDA, no PyTorch headers) is built with
``g++`` at first use into ``mudiff_torch/_build/`` (git-ignored), named by
a hash of the source and the flags, as ``ops/_build.py`` names the CUDA
libraries: an edited source is rebuilt, a stale library never loaded.
The library that the JAX package builds beside the source is not loaded.

``gather_normalize4`` gathers a batch of slices from the four (N, H, W)
float32 stacks and normalises them (clamp to +-3, divide by 3).  The
numpy path is the bit-identical reference; it runs when the caller asks
for it (``native=False``), when an input is not a C-contiguous float32
array, or when the library cannot be built (``native_available()`` says
which).  This is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "slice_gather.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library is built: named by a hash of the source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libslice_gather_{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, target)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, build_error
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        target = library_path()
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        lib.mudiff_gather_normalize4.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32,
        ]
        lib.mudiff_gather_normalize4.restype = None
        _LIB = lib
    except (OSError, subprocess.SubprocessError) as e:
        stderr = getattr(e, "stderr", b"") or b""
        build_error = f"{e} {stderr.decode(errors='replace')}".strip()
    return _LIB


def native_available() -> bool:
    """Whether the native gather is built and loaded (building it if needed)."""
    return _load() is not None


def _usable(arrays: Sequence[np.ndarray]) -> bool:
    return all(isinstance(a, np.ndarray) and a.dtype == np.float32 and a.flags.c_contiguous
               for a in arrays)


def gather_normalize4(
    sources: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    indices: np.ndarray,
    n_threads: int = 0,
    native: bool = True,
    out: Optional[Sequence[np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Gather and normalise a batch from four (N, H, W) float32 stacks.

    Returns four (B, H, W, 1) float32 arrays in [-1, 1], written into
    ``out`` when given (four C-contiguous float32 arrays of that shape,
    e.g. views of pinned host tensors).  The native library serves it
    when ``native`` and the inputs allow, numpy otherwise (the same bits).
    """
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    b = len(idx)
    h, w = sources[0].shape[1:3]
    shape = (b, h, w, 1)
    if out is not None and any(o.shape != shape for o in out):
        raise ValueError(f"out arrays must be {shape}")
    lib = _load() if native else None
    outs = list(out) if out is not None else [np.empty(shape, np.float32) for _ in range(4)]
    if lib is not None and _usable(sources) and _usable(outs):
        n = sources[0].shape[0]
        if any(s.shape != sources[0].shape for s in sources):
            raise ValueError("the four stacks must have one shape")
        if b and (idx.min() < 0 or idx.max() >= n):  # the library reads unchecked
            raise IndexError(f"slice index out of range [0, {n})")
        lib.mudiff_gather_normalize4(
            *(s.ctypes.data for s in sources), idx.ctypes.data, b, h * w,
            *(o.ctypes.data for o in outs), n_threads)
        return tuple(outs)
    for s, o in zip(sources, outs):
        o[...] = (np.clip(s[idx].astype(np.float32), -3.0, 3.0) / 3.0)[..., None]
    return tuple(outs)
