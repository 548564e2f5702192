"""Build the CUDA kernels from ``mudiff_torch/csrc`` with ``nvcc`` and load
them with ``ctypes``.

Each source is a plain-C-interface shared library (no PyTorch headers),
so one ``nvcc`` call takes seconds.  ``build()`` starts one ``nvcc`` per
missing library, all at once, and waits for all of them.  Libraries go
to ``mudiff_torch/_build/`` (git-ignored), named by a hash of the source,
every header under ``csrc/`` and the flags, so an edited source or
header is rebuilt and a stale library is never loaded.  Nothing is built or loaded at import time: the first
CUDA call of a wrapper loads its library, building it if needed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

SOURCES = {
    "conv3x3": "conv3x3_kernel.cu",
    "fir": "fir_kernels.cu",
    "flash_attn": "flash_attn_kernel.cu",
    "flash_attn_bwd": "flash_attn_bwd_kernel.cu",
    "int8_conv": "int8_conv_kernel.cu",
    "group_norm": "group_norm_kernel.cu",
}

NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    """Where library ``name`` is built: named by a hash of its source, of
    every ``csrc/*.cuh`` (a source may include any of them) and of the
    flags."""
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build the named libraries (default: all) that are not built yet.

    Returns ``{name: {"seconds": wall time, "log": nvcc's stderr}}`` for
    each library built in this call.  Raises with nvcc's output if any
    build fails.
    """
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    results, failures = {}, []
    for name, (proc, tmp, target, t0) in started.items():
        out, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"[{name}] nvcc exit {proc.returncode}\n{out}{err}")
            continue
        os.replace(tmp, target)
        results[name] = {"seconds": seconds, "log": out + err}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
