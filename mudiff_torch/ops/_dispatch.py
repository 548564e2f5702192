"""Where each kernel wrapper decides between its CUDA kernel and its
plain PyTorch version.

The rule is the tensor's device: a CPU tensor takes the plain version
(only the tests pass CPU tensors); a CUDA tensor launches the kernel,
and a build or launch failure raises.  Nothing falls back quietly.  The
one exception is explicit: inside ``plain_kernels()`` the wrappers run
their plain versions on CUDA tensors too, so that a caller can hold a
whole forward through the kernels against the same forward without them.

``record_calls(log)`` appends ``(kernel name, shape key)`` for every
wrapper call inside the block, whichever way it goes.

Every wrapper is a ``torch.autograd.Function`` on every device, so its
backward follows the same rule: plain versions for CPU tensors, kernels
for CUDA tensors.  The autograd engine runs a CUDA backward on a worker
thread, where the caller's context variables are not set; so a Function
captures ``current_mode()`` in its forward and re-enters it with
``restored(mode)`` in its backward.  A backward therefore runs plain
(and is recorded) exactly when its forward was.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, List, Optional, Tuple

import torch

_FORCE_PLAIN = contextvars.ContextVar("mudiff_torch_force_plain", default=False)
_RECORD: contextvars.ContextVar[Optional[List[Tuple[str, tuple]]]] = (
    contextvars.ContextVar("mudiff_torch_record", default=None)
)


@contextlib.contextmanager
def plain_kernels() -> Iterator[None]:
    """Run every wrapper's plain version, on CUDA tensors too."""
    token = _FORCE_PLAIN.set(True)
    try:
        yield
    finally:
        _FORCE_PLAIN.reset(token)


@contextlib.contextmanager
def record_calls(log: List[Tuple[str, tuple]]) -> Iterator[List[Tuple[str, tuple]]]:
    """Append ``(name, key)`` of every wrapper call in the block to ``log``."""
    token = _RECORD.set(log)
    try:
        yield log
    finally:
        _RECORD.reset(token)


Mode = Tuple[bool, Optional[List[Tuple[str, tuple]]]]


def current_mode() -> Mode:
    """The calling context's (plain versions forced, call log)."""
    return _FORCE_PLAIN.get(), _RECORD.get()


@contextlib.contextmanager
def restored(mode: Mode) -> Iterator[None]:
    """Run the block under a mode captured by ``current_mode()``."""
    tokens = (_FORCE_PLAIN.set(mode[0]), _RECORD.set(mode[1]))
    try:
        yield
    finally:
        _RECORD.reset(tokens[1])
        _FORCE_PLAIN.reset(tokens[0])


def use_kernel(name: str, key: tuple, *tensors: Optional[torch.Tensor]) -> bool:
    """True when the call must launch the CUDA kernel.

    Raises for a device other than CPU or CUDA and for tensors on mixed
    devices.
    """
    log = _RECORD.get()
    if log is not None:
        log.append((name, key))
    present = [t for t in tensors if t is not None]
    device = present[0].device
    if any(t.device != device for t in present):
        raise ValueError(f"{name}: tensors on mixed devices")
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    return not _FORCE_PLAIN.get()


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def check_cuda_result(name: str, rc: int) -> None:
    """Raise if the launch reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
