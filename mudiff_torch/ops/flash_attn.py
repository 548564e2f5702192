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

The backward replaces the stock kernel's two backward ``pallas_call``s
(``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq``, wired by
``_flash_attention_bwd``): ``csrc/flash_attn_bwd_kernel.cu`` holds
``flash_attn_bwd_dkv`` and ``flash_attn_bwd_dq``, which recompute p from
the forward's fp32 row statistics (max m and sum l, a ``(2, B, L)``
tensor ``stats``), and ``flash_attn_bwd_plain`` is their plain version.
``di = rowsum(o * do)`` is plain PyTorch in fp32, as in the JAX package.
The ``flash_attn`` Function is once differentiable, as the stock kernel
is.

Every wrapper dispatches by device (``ops/_dispatch.py``): CPU tensors
run the plain version, CUDA tensors launch the kernel or raise.
``<wrapper>.launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from mudiff_torch.ops import _build
from mudiff_torch.ops._dispatch import (
    DTYPE_CODES,
    check_cuda_result,
    current_mode,
    restored,
    use_kernel,
)

MAX_HEAD_DIM = 512


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(1, 2)) * scale


def flash_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """The plain version on (B, L, C) tensors: the exact einsum."""
    w = torch.softmax(_scores(q, k, scale), dim=-1).to(q.dtype)
    out = torch.matmul(w.to(torch.float32), v.to(torch.float32))
    return out.to(q.dtype)


def row_stats_plain(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """The forward's row statistics, (2, B, L) float32: the max m of each
    score row and l = sum exp(s - m)."""
    s = _scores(q, k, scale)
    m = s.amax(dim=-1)
    return torch.stack([m, torch.exp(s - m[..., None]).sum(dim=-1)])


def flash_attn_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, stats: torch.Tensor, do: torch.Tensor,
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the backward: (dq, dk, dv) in q.dtype, with the
    kernels' arithmetic and rounding points in whole-matrix form."""
    return _bwd_plain(q, k, v, do, stats, attn_di(o, do), scale)


def attn_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(o * do) in float32, (B, L)."""
    return (o.to(torch.float32) * do.to(torch.float32)).sum(dim=-1)


def _bwd_plain(q, k, v, do, stats, di, scale, want=("dq", "dk", "dv")):
    """The named gradients of ``want``, in that order."""
    f32, dt = torch.float32, q.dtype
    p = torch.exp(_scores(q, k, scale) - stats[0][..., None]) * (1.0 / stats[1])[..., None]
    out = {}
    if "dv" in want:
        out["dv"] = torch.matmul(p.to(dt).to(f32).transpose(1, 2), do.to(f32)).to(dt)
    if "dq" in want or "dk" in want:
        dp = torch.matmul(do.to(f32), v.to(f32).transpose(1, 2))
        ds = ((dp - di[..., None]) * p * scale).to(dt).to(f32)
        if "dk" in want:
            out["dk"] = torch.matmul(ds.transpose(1, 2), q.to(f32)).to(dt)
        if "dq" in want:
            out["dq"] = torch.matmul(ds, k.to(f32)).to(dt)
    return tuple(out[name] for name in want)


_FNS = {}


def _kernel_fn(lib: str, name: str, n_ptr: int):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load(lib), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(*tensors: torch.Tensor) -> None:
    q = tensors[0]
    if q.dim() != 3 or any(t.shape != q.shape for t in tensors):
        raise ValueError("flash_attn: need tensors of one shape (B, L, C), got "
                         + ", ".join(str(tuple(t.shape)) for t in tensors))
    c = q.shape[-1]
    if c % 4 or c > MAX_HEAD_DIM:
        raise ValueError(f"flash_attn: head dim {c} must be a multiple of 4 "
                         f"and at most {MAX_HEAD_DIM}")
    if q.dtype not in DTYPE_CODES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError("flash_attn: tensors (" + ", ".join(str(t.dtype) for t in tensors)
                        + ") must be one of float32, bfloat16, float16 and agree")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attn: tensors must be contiguous and 16-byte aligned")


def _check_stats(q: torch.Tensor, stats: torch.Tensor, di: torch.Tensor) -> None:
    b, length, _ = q.shape
    if (stats.shape != (2, b, length) or di.shape != (b, length)
            or stats.dtype != torch.float32 or di.dtype != torch.float32
            or not (stats.is_contiguous() and di.is_contiguous())):
        raise ValueError(f"flash_attn bwd: need stats (2, {b}, {length}) and di "
                         f"({b}, {length}) contiguous float32, got {tuple(stats.shape)} "
                         f"{stats.dtype} and {tuple(di.shape)} {di.dtype}")


def _forward(q, k, v, scale, with_stats):
    """K3 (or its plain version): the output, and the row statistics
    when ``with_stats`` (else None)."""
    if not use_kernel("flash_attn", (*q.shape, q.dtype), q, k, v):
        out = flash_attn_plain(q, k, v, scale)
        return out, (row_stats_plain(q, k, scale) if with_stats else None)
    _check(q, k, v)
    b, length, c = q.shape
    out = torch.empty_like(q)
    stats = (torch.empty((2, b, length), dtype=torch.float32, device=q.device)
             if with_stats else None)
    rc = _kernel_fn("flash_attn", "mudiff_flash_attn", 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        stats[0].data_ptr() if with_stats else None,
        stats[1].data_ptr() if with_stats else None,
        b, length, c, float(scale), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_cuda_result("flash_attn", rc)
    flash_attn.launches += 1
    return out, stats


def flash_attn_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, stats: torch.Tensor, di: torch.Tensor,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of softmax(q k^T * scale) v, from the forward's ``stats``
    and ``di = attn_di(o, do)``."""
    if not use_kernel("flash_attn_bwd_dkv", (*q.shape, q.dtype), q, k, v, do, stats, di):
        return _bwd_plain(q, k, v, do, stats, di, scale, want=("dk", "dv"))
    _check(q, k, v, do)
    _check_stats(q, stats, di)
    b, length, c = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _kernel_fn("flash_attn_bwd", "mudiff_flash_attn_bwd_dkv", 9)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, length, c, float(scale), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_cuda_result("flash_attn_bwd_dkv", rc)
    flash_attn_bwd_dkv.launches += 1
    return dk, dv


def flash_attn_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, stats: torch.Tensor, di: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """dq of softmax(q k^T * scale) v, from the forward's ``stats`` and
    ``di = attn_di(o, do)``."""
    if not use_kernel("flash_attn_bwd_dq", (*q.shape, q.dtype), q, k, v, do, stats, di):
        return _bwd_plain(q, k, v, do, stats, di, scale, want=("dq",))[0]
    _check(q, k, v, do)
    _check_stats(q, stats, di)
    b, length, c = q.shape
    dq = torch.empty_like(q)
    rc = _kernel_fn("flash_attn_bwd", "mudiff_flash_attn_bwd_dq", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), di.data_ptr(), dq.data_ptr(),
        b, length, c, float(scale), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_cuda_result("flash_attn_bwd_dq", rc)
    flash_attn_bwd_dq.launches += 1
    return dq


class _FlashAttn(torch.autograd.Function):
    """K3 forward; backward: di in plain PyTorch, then dkv, then dq
    (``flash_attention.py:254-316``).  Once differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, scale, with_stats):
        out, stats = _forward(q, k, v, scale, with_stats)
        if with_stats:
            ctx.save_for_backward(q, k, v, out, stats)
        ctx.scale, ctx.mode = scale, current_mode()
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, stats = ctx.saved_tensors
        do = do.contiguous()
        with restored(ctx.mode):
            di = attn_di(out, do)
            dk, dv = flash_attn_bwd_dkv(q, k, v, do, stats, di, ctx.scale)
            dq = flash_attn_bwd_dq(q, k, v, do, stats, di, ctx.scale)
        return dq, dk, dv, None, None


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, L, C) tensors, in q.dtype.  The
    row statistics are kept only when a graph is recorded."""
    with_stats = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _FlashAttn.apply(q, k, v, float(scale), with_stats)


flash_attn.launches = 0
flash_attn_bwd_dkv.launches = 0
flash_attn_bwd_dq.launches = 0
