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
``<wrapper>.launches`` counts kernel launches and nothing else, and
``<wrapper>.path_launches`` the same launches by the kernel that took them
(``k3_path``, the same rule for the forward and both backward kernels):
``"wgmma"`` (bf16 / fp16 at C = 256 on Hopper's wgmma and TMA),
``"general"`` (bf16 / fp16 on ``mma.sync``) or ``"fma"`` (fp32).
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
# The one head dim of the wgmma kernels: the recipe's (nf = 64).  C = 512
# (nf = 128) would need a 64 x 512 fp32 accumulator a warpgroup; smaller
# head dims would leave most of a 64-channel TMA box empty.
WGMMA_HEAD_DIM = 256


def k3_path_for(c: int, dtype: torch.dtype) -> str:
    """``k3_path`` from the head dim and dtype alone."""
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if c == WGMMA_HEAD_DIM else "general"


def k3_path(q: torch.Tensor) -> str:
    """Which of K3's kernels takes a call on (B, L, C) tensors like ``q``,
    forward and backward alike: ``"fma"`` for float32; for bf16 / fp16
    ``"wgmma"`` at C = 256, else ``"general"``.  Decided before any launch,
    from the shape and dtype alone, on any device (the wrappers take only
    contiguous 16-byte aligned tensors, which the tensor maps need)."""
    return k3_path_for(q.shape[-1], q.dtype)


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
# {kernel: {path: (library, entry point, pointer arguments)}}; the wgmma
# forward takes one int more (block_q) before the stream
_ENTRIES = {
    "flash_attn": {"general": ("flash_attn", "mudiff_flash_attn", 6),
                   "wgmma": ("flash_attn", "mudiff_flash_attn_wgmma", 6)},
    "flash_attn_bwd_dkv": {"general": ("flash_attn_bwd", "mudiff_flash_attn_bwd_dkv", 9),
                           "wgmma": ("flash_attn_bwd", "mudiff_flash_attn_bwd_dkv_wgmma", 9)},
    "flash_attn_bwd_dq": {"general": ("flash_attn_bwd", "mudiff_flash_attn_bwd_dq", 8),
                          "wgmma": ("flash_attn_bwd", "mudiff_flash_attn_bwd_dq_wgmma", 8)},
}


def _kernel_fn(kernel: str, path: str):
    """The entry point of ``kernel``'s ``path`` (``"fma"`` shares the
    general entry point, which picks by dtype)."""
    lib, name, n_ptr = _ENTRIES[kernel]["wgmma" if path == "wgmma" else "general"]
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load(lib), name)
        extra = [ctypes.c_int] if name == "mudiff_flash_attn_wgmma" else []
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int] + extra + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check_path(name: str, path: str, dtype: torch.dtype) -> None:
    """A named path must exist for the dtype: "fma" for float32 only, the
    tensor-core ones for bf16 / fp16 only."""
    if path not in ("wgmma", "general", "fma") or (path == "fma") != (dtype == torch.float32):
        raise ValueError(f"{name}: no {path} kernel for {dtype}")


def _launched(wrapper, path: str) -> None:
    wrapper.launches += 1
    wrapper.path_launches[path] += 1


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
    return _launch_forward(q, k, v, scale, with_stats, k3_path(q))


def _launch_forward(q, k, v, scale, with_stats, path, block_q=0):
    """Launch K3's ``path`` on CUDA tensors; ``block_q`` (wgmma only): 0
    lets the kernel pick 64 or 128 queries a block by the grid."""
    _check(q, k, v)
    b, length, c = q.shape
    out = torch.empty_like(q)
    stats = (torch.empty((2, b, length), dtype=torch.float32, device=q.device)
             if with_stats else None)
    extra = (int(block_q),) if path == "wgmma" else ()
    rc = _kernel_fn("flash_attn", path)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        stats[0].data_ptr() if with_stats else None,
        stats[1].data_ptr() if with_stats else None,
        b, length, c, float(scale), DTYPE_CODES[q.dtype], *extra,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_cuda_result(f"flash_attn ({path})", rc)
    _launched(flash_attn, path)
    return out, stats


def flash_attn_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    path: str, block_q: int = 0) -> torch.Tensor:
    """K3's forward through the named kernel on CUDA tensors, whatever
    ``k3_path`` would pick (``chip_smoke.py`` times the mma.sync kernel beside the
    wgmma one and checks that 64- and 128-query blocks give the same bits);
    counted like any launch."""
    _check_path("flash_attn", path, q.dtype)
    return _launch_forward(q, k, v, scale, False, path, block_q)[0]


def flash_attn_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, stats: torch.Tensor, di: torch.Tensor,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of softmax(q k^T * scale) v, from the forward's ``stats``
    and ``di = attn_di(o, do)``."""
    if not use_kernel("flash_attn_bwd_dkv", (*q.shape, q.dtype), q, k, v, do, stats, di):
        return _bwd_plain(q, k, v, do, stats, di, scale, want=("dk", "dv"))
    return _launch_bwd("flash_attn_bwd_dkv", q, k, v, do, stats, di, scale, k3_path(q))


def flash_attn_bwd_path(name: str, q, k, v, do, stats, di, scale: float, path: str):
    """K3's backward kernel ``name`` (``"flash_attn_bwd_dkv"`` or
    ``"flash_attn_bwd_dq"``) through the named path on CUDA tensors,
    whatever ``k3_path`` would pick (``chip_smoke.py`` times the mma.sync kernels
    beside the wgmma ones); counted like any launch."""
    _check_path(name, path, q.dtype)
    return _launch_bwd(name, q, k, v, do, stats, di, scale, path)


def _launch_bwd(name, q, k, v, do, stats, di, scale, path):
    _check(q, k, v, do)
    _check_stats(q, stats, di)
    b, length, c = q.shape
    dkv = name == "flash_attn_bwd_dkv"
    outs = (torch.empty_like(k), torch.empty_like(v)) if dkv else (torch.empty_like(q),)
    rc = _kernel_fn(name, path)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), di.data_ptr(), *(t.data_ptr() for t in outs),
        b, length, c, float(scale), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_cuda_result(f"{name} ({path})", rc)
    _launched(flash_attn_bwd_dkv if dkv else flash_attn_bwd_dq, path)
    return outs if dkv else outs[0]


def flash_attn_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, stats: torch.Tensor, di: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """dq of softmax(q k^T * scale) v, from the forward's ``stats`` and
    ``di = attn_di(o, do)``."""
    if not use_kernel("flash_attn_bwd_dq", (*q.shape, q.dtype), q, k, v, do, stats, di):
        return _bwd_plain(q, k, v, do, stats, di, scale, want=("dq",))[0]
    return _launch_bwd("flash_attn_bwd_dq", q, k, v, do, stats, di, scale, k3_path(q))


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
# the launches of each path (k3_path): the recipe's C = 256 takes "wgmma"
for _wrapper in (flash_attn, flash_attn_bwd_dkv, flash_attn_bwd_dq):
    _wrapper.path_launches = {"wgmma": 0, "general": 0, "fma": 0}
