"""Single-head attention forward, softmax(q k^T * scale) v: kernel K3.

Replaces the stock Pallas TPU flash attention that the JAX package calls
in ``AttnBlockpp`` under the ``flash`` lowering
(``mudiff_tpu/nn/blocks.py:206-214``:
``jax.experimental.pallas.ops.tpu.flash_attention.flash_attention`` ->
``_flash_attention_impl`` -> ``pallas_call``).  Non-causal, one head, no
mask.  The CUDA kernel is ``csrc/flash_attn_kernel.cu``: fp32 scores,
an online softmax with fp32 statistics, ``p`` rounded to the input dtype,
fp32 accumulation, output in the input dtype.

The plain version ``flash_attn_plain`` computes what the JAX package
computes for ``flash`` on the CPU, the exact einsum
(``blocks.py:204-205, 226-233``): fp32 scores and softmax, the weights
cast to the input dtype, ``w.v`` accumulated in fp32, the output in the
input dtype.

``flash_attn`` dispatches by device (``ops/_dispatch.py``): CPU tensors
run the plain version, CUDA tensors launch the kernel or raise.  There
is no backward yet.  ``flash_attn.launches`` counts kernel launches and
nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from mudiff_torch.ops import _build
from mudiff_torch.ops._dispatch import DTYPE_CODES, check_cuda_result, use_kernel

MAX_HEAD_DIM = 512


def flash_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """The plain version on (B, L, C) tensors: the exact einsum."""
    scores = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(1, 2)) * scale
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(w.to(torch.float32), v.to(torch.float32))
    return out.to(q.dtype)


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("flash_attn").mudiff_flash_attn
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attn: need q, k, v of one shape (B, L, C), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    c = q.shape[-1]
    if c % 4 or c > MAX_HEAD_DIM:
        raise ValueError(f"flash_attn: head dim {c} must be a multiple of 4 "
                         f"and at most {MAX_HEAD_DIM}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attn: q, k, v ({q.dtype}, {k.dtype}, {v.dtype}) must "
                        "be one of float32, bfloat16, float16 and agree")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attn: q, k, v must be contiguous and 16-byte aligned")


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, L, C) tensors, in q.dtype."""
    if not use_kernel("flash_attn", (*q.shape, q.dtype), q, k, v):
        return flash_attn_plain(q, k, v, scale)
    _check(q, k, v)
    b, length, c = q.shape
    out = torch.empty_like(q)
    rc = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, length, c, float(scale), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_cuda_result("flash_attn", rc)
    flash_attn.launches += 1
    return out


flash_attn.launches = 0
