"""W8A8 int8 3x3 stride-1 SAME convolution, NHWC x HWIO: kernel K4.

The port of ``mudiff_tpu/ops/int8_conv.py`` (``int8_conv3x3`` at :268,
``_static_int8_conv3x3`` at :239, ``quantize_weight`` :214,
``quantize_activation`` :227; XLA-lowered on the TPU, not Pallas), with
its calibration record (``Int8Calib`` :63-112), its routing rule
(``int8_conv_routed`` :180) and its scopes.  Inference only: there is no
backward (no straight-through estimator, as in the JAX package).

Two activation-scale modes, the same arithmetic as the JAX package:

* **dynamic**: symmetric per-example scales, ``scale = absmax / 127 +
  1e-30`` with the absmax over (H, W, C), ``q = clip(round(x / scale),
  +-127)`` (a division), and ``y = float(acc) * (a_scale * w_scale) +
  bias``;
* **static** (a calibration): per-input-channel ``a = absmax_c / 127 +
  1e-30`` folded into the weight, ``w_eff = w * a``, and ``q =
  clip(round(x * (1 / a)), +-127)`` (a multiply by the reciprocal), and
  ``y = float(acc) * w_scale + bias``.

Both: weights symmetric int8 per output channel (``quantize_weight``),
s8 x s8 -> s32 accumulation, the rescale and the bias in fp32, one
rounding to the compute dtype.  Rounding is half to even throughout.

The arithmetic is the JAX package's as XLA compiles it, which is how it
serves (every sampler and CLI path is jitted), and XLA rewrites two
things in it: a run-time value divided by the constant 127 becomes a
multiply by the float32 reciprocal of 127, and a multiply followed by an
add becomes one fused multiply-add (one rounding).  So the weight's and
the dynamic activation's scales are ``fma(absmax, RECIP_127, 1e-30)``,
and the output is ``fma(float(acc), s, bias)``; the static ``a``, a
constant of the trace, is folded with a true division and an add.  Run
op by op, outside ``jit``, the JAX functions round twice instead, and
differ from these by an ulp now and then.  ``fma32`` computes the fused
form in PyTorch.

The CUDA kernels are ``csrc/int8_conv_kernel.cu``, on two paths that
``k4_path`` chooses by shape and alignment before any launch:

* **wgmma** (every shape of the flagship configurations): one ctypes call,
  ``int8_fused_cuda``.  The conv quantizes its own halo patches of x in
  shared memory and multiplies on Hopper's ``wgmma`` with the weight
  tiles arriving by TMA, so no int8 code reaches device memory; static
  scales are one launch, dynamic ones two (per-example partial maxima of
  |x| first).  It needs Cin % 16 == 0 and 16-byte aligned x and weight.
* **general** (any other shape): the quantize (an absmax reduction in
  dynamic mode, then an elementwise pass that writes the int8 codes) and
  the s8 ``mma.sync`` implicit GEMM with the epilogue,
  ``int8_quantize_cuda`` then ``int8_conv_cuda``.
The plain version (``int8_conv3x3_plain``) quantizes in PyTorch and
convolves the codes with ``F.conv2d`` in float64, which is exact below
2^53 (|acc| <= 9 * Cin * 127^2); float32 is not exact above 2^24.

The quantized weight (``Int8Weight``: int8 codes, ``w_scale`` and, in
static mode, the activation's reciprocal scales) is plain PyTorch on the
fp32 parameter.  ``Int8WeightCache`` keeps it per module and per
calibration site until a source parameter changes (``data_ptr`` or
``_version``), so a forward does not quantize its weights again.

Routing and calibration state live in context variables: ``int8_scope``
(on/off, the routing threshold, a static calibration and how many of its
sites a forward consumed) and ``record_scope`` (a sink that collects
each routed site's per-channel absmax).  There are no environment
knobs: the threshold and the stems bit are the generator's constructor
arguments.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import math
from typing import Callable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mudiff_torch.ops import _build
from mudiff_torch.ops._dispatch import DTYPE_CODES, check_cuda_result, use_kernel


class Int8Calib(NamedTuple):
    """Static activation calibration of one generator.

    ``sites`` holds one ``(cin, cout, absmax_per_channel)`` entry per
    int8-routed conv in forward order; ``absmax_per_channel`` is a
    length-``cin`` tuple of floats.  ``min_ch`` is the routing threshold
    it was recorded with and ``stems`` whether the fused stem conv2 was
    routed: serving replays both, since the site list depends on them.
    The JSON form (version 2) is the JAX package's, so one sidecar
    serves both packages; a version-1 sidecar reads as ``stems=False``.
    """

    min_ch: int
    sites: Tuple[Tuple[int, int, Tuple[float, ...]], ...]
    stems: bool = False

    def to_json_dict(self) -> dict:
        return {
            "version": 2,
            "min_ch": int(self.min_ch),
            "stems": bool(self.stems),
            "sites": [
                {"cin": int(ci), "cout": int(co), "absmax": list(map(float, a))}
                for ci, co, a in self.sites
            ],
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "Int8Calib":
        return cls(
            min_ch=int(d["min_ch"]),
            stems=bool(d.get("stems", False)),
            sites=tuple(
                (int(s["cin"]), int(s["cout"]), tuple(map(float, s["absmax"])))
                for s in d["sites"]
            ),
        )


class Int8Scope:
    """The state of one ``int8_scope``: whether routed convs run int8,
    the routing threshold, the static calibration and how many of its
    sites the scope's forward has consumed."""

    __slots__ = ("enabled", "min_ch", "calib", "consumed")

    def __init__(self, enabled: bool, min_ch: Optional[int], calib: Optional[Int8Calib]):
        self.enabled = enabled
        self.min_ch = min_ch
        self.calib = calib
        self.consumed = 0

    def check_consumed(self) -> None:
        """Raise unless the forward consumed every calibration site: a
        calibration recorded with more sites than the forward reached
        would otherwise serve shifted scales without a word."""
        if self.calib is not None and self.consumed != len(self.calib.sites):
            raise ValueError(
                f"int8 calibration has {len(self.calib.sites)} sites but the forward "
                f"consumed {self.consumed}: it was recorded for a different "
                "architecture, routing threshold or stems bit")


_SCOPE: contextvars.ContextVar[Optional[Int8Scope]] = contextvars.ContextVar(
    "mudiff_torch_int8_scope", default=None)
_RECORD: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar(
    "mudiff_torch_int8_record", default=None)


@contextlib.contextmanager
def int8_scope(enabled: bool, min_ch: Optional[int] = None,
               calib: Optional[Int8Calib] = None) -> Iterator[Int8Scope]:
    """Route eligible convs through K4 inside the block.  A calibration
    switches them to static scales and overrides ``min_ch`` with its own
    threshold.  Yields the scope's state."""
    scope = Int8Scope(bool(enabled), calib.min_ch if calib is not None else min_ch, calib)
    token = _SCOPE.set(scope)
    try:
        yield scope
    finally:
        _SCOPE.reset(token)


@contextlib.contextmanager
def record_scope(sink: list) -> Iterator[list]:
    """Inside the block every routed conv appends ``(cin, cout,
    absmax_per_channel)`` (a float32 tensor over its input's B, H, W) to
    ``sink`` in forward order, and computes with dynamic scales."""
    token = _RECORD.set(sink)
    try:
        yield sink
    finally:
        _RECORD.reset(token)


def recording() -> bool:
    """True inside a ``record_scope``."""
    return _RECORD.get() is not None


def int8_enabled() -> bool:
    """True inside an enabled ``int8_scope``."""
    scope = _SCOPE.get()
    return scope is not None and scope.enabled


def int8_conv_routed(cin: int, cout: int, min_ch: Optional[int] = None) -> bool:
    """Quantize only the trunk shapes that carry the FLOPs:
    ``cin >= min_ch and cout >= max(2, min_ch)``.  ``min_ch`` defaults to
    the enclosing scope's threshold, else 64."""
    if min_ch is None:
        scope = _SCOPE.get()
        min_ch = (scope.min_ch if scope is not None else None) or 64
    return cin >= min_ch and cout >= max(2, min_ch)


# -------------------------------------------------------------- the plain version

# float32(1 / 127): what XLA multiplies by where the JAX package divides a
# run-time value by 127.0 (module docstring).
RECIP_127 = float(torch.tensor(1.0, dtype=torch.float32) / torch.tensor(127.0))


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (a fused multiply-add), for
    float32 operands that broadcast.  The product is exact in float64 (24
    + 24 bits); the sum is rounded to float64, and its rounding error
    (TwoSum) decides the float32 rounding where the float64 sum lies on a
    float32 midpoint, the one case where rounding twice differs."""
    p = a.to(torch.float64) * torch.as_tensor(b, dtype=torch.float32, device=a.device).double()
    c = torch.as_tensor(c, dtype=torch.float32, device=a.device).double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    f = s.to(torch.float32)
    d = s - f.double()
    toward = torch.where(d > 0, torch.full_like(f, math.inf), torch.full_like(f, -math.inf))
    nb = torch.nextafter(f, toward)
    tie = (d != 0) & (2 * d.abs() == (nb.double() - f.double()).abs())
    return torch.where(tie & (err * d > 0), nb, f)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an HWIO kernel: ``(w_q int8,
    w_scale float32 (1, 1, 1, Cout))`` with ``w ~= w_q * w_scale``."""
    wf = w.to(torch.float32)
    absmax = wf.abs().amax(dim=(0, 1, 2), keepdim=True)
    scale = fma32(absmax, RECIP_127, 1e-30)
    return torch.round(wf / scale).to(torch.int8), scale


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric dynamic per-example int8 of an NHWC tensor: ``(x_q int8,
    a_scale float32 (B, 1, 1, 1))``."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=(1, 2, 3), keepdim=True)
    scale = fma32(absmax, RECIP_127, 1e-30)
    return torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8), scale


def quantize_activation_static(x: torch.Tensor, inv_a: torch.Tensor) -> torch.Tensor:
    """Static int8 of an NHWC tensor against the per-channel reciprocal
    scales ``inv_a = 1 / (absmax_c / 127 + 1e-30)``."""
    return torch.clamp(torch.round(x.to(torch.float32) * inv_a), -127.0, 127.0).to(torch.int8)


class Int8Weight(NamedTuple):
    """A conv weight ready for K4: ``wq`` int8 HWIO (the plain version's
    layout), ``wq_nk`` the same codes as a contiguous (Cout, 9 * Cin)
    matrix (the kernel's: K contiguous, tap-major), ``w_scale`` float32
    (Cout,), and in static mode ``inv_a`` float32 (Cin,), else None."""

    wq: torch.Tensor
    wq_nk: torch.Tensor
    w_scale: torch.Tensor
    inv_a: Optional[torch.Tensor]


def quantize_conv_weight(w: torch.Tensor,
                         absmax_c: Optional[Sequence[float]] = None) -> Int8Weight:
    """``quantize_weight`` of the fp32 HWIO parameter, after folding the
    static scales ``a = absmax_c / 127 + 1e-30`` into it when
    ``absmax_c`` is given (``conv(x, w) == conv(x / a, a * w)``)."""
    wf = w.detach().to(torch.float32)
    inv_a = None
    if absmax_c is not None:
        a = torch.tensor(absmax_c, dtype=torch.float32, device=w.device) / 127.0 + 1e-30
        inv_a = 1.0 / a
        wf = wf * a[None, None, :, None]
    wq, scale = quantize_weight(wf)
    cin, cout = wq.shape[2], wq.shape[3]
    return Int8Weight(wq, wq.permute(3, 0, 1, 2).reshape(cout, 9 * cin).contiguous(),
                      scale.reshape(cout).contiguous(), inv_a)


def conv_acc_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact s32 accumulator of the int8 conv, as float64 (B, H, W,
    Cout): ``F.conv2d`` in float64 on the codes.  cuDNN is off, so no FFT
    or Winograd algorithm rounds the sums."""
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq.to(torch.float64).permute(0, 3, 1, 2),
                       wq.to(torch.float64).permute(3, 2, 0, 1), padding=1)
    return acc.permute(0, 2, 3, 1)


def int8_conv3x3_plain(x: torch.Tensor, qw: Int8Weight, bias: Optional[torch.Tensor],
                       compute_dtype: torch.dtype) -> torch.Tensor:
    """The plain version: quantize, the exact float64 conv of the codes,
    the fp32 rescale and bias as the JAX package computes them (``s =
    a_scale * w_scale`` or ``w_scale``, ``fma(float(acc), s, bias)``),
    then the compute dtype."""
    if qw.inv_a is None:
        xq, a_scale = quantize_activation(x)
        scale = a_scale * qw.w_scale
    else:
        xq = quantize_activation_static(x, qw.inv_a)
        scale = qw.w_scale
    acc = conv_acc_plain(xq, qw.wq).to(torch.float32)
    y = acc * scale if bias is None else fma32(acc, scale, bias.to(torch.float32))
    return y.to(compute_dtype).contiguous()


# ------------------------------------------------------------------- the kernel

_FNS = None
OUT_CODES = {**DTYPE_CODES, torch.int32: 3}


def _kernel_fns():
    global _FNS
    if _FNS is None:
        lib = _build.load("int8_conv")
        quant = lib.mudiff_int8_quantize
        quant.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                          + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        quant.restype = ctypes.c_int
        conv = lib.mudiff_int8_conv3x3
        conv.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        conv.restype = ctypes.c_int
        fused = lib.mudiff_int8_conv3x3_fused
        fused.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
                          + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fused.restype = ctypes.c_int
        _FNS = (quant, conv, fused)
    return _FNS


# Partial maxima of |x| an example that the fused dynamic path reduces
# (csrc/int8_conv_kernel.cu, s8wgmma::ABSMAX_PARTS).
ABSMAX_PARTS = 128


def k4_path(x: torch.Tensor, qw: Int8Weight) -> str:
    """Which of K4's kernels takes a call on the contiguous NHWC ``x``:
    ``"wgmma"`` (the fused quantize + wgmma conv) when Cin % 16 == 0 and x
    and the (Cout, 9 * Cin) weight start on 16-byte boundaries (the tensor
    maps' strides and addresses), else ``"general"`` (the quantize pass and
    the mma.sync GEMM).  Decided before any launch, from shapes and
    addresses alone, on any device."""
    cin = x.shape[-1]
    if (cin % 16 == 0 and x.shape[0] <= 65535 and x.data_ptr() % 16 == 0
            and qw.wq_nk.data_ptr() % 16 == 0):
        return "wgmma"
    return "general"


def _check_bias(bias: Optional[torch.Tensor], cout: int) -> None:
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (cout,)
                             or not bias.is_contiguous()):
        raise ValueError("int8 conv: bias must be a contiguous float32 (Cout,)")


def int8_fused_cuda(x: torch.Tensor, qw: Int8Weight, bias: Optional[torch.Tensor],
                    out_dtype: torch.dtype) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K4's fused kernel on a contiguous CUDA NHWC ``x``, one ctypes call:
    ``(out, absmax float32 (B,))`` in dynamic mode (``qw.inv_a`` None),
    ``(out, None)`` in static mode; ``out`` the rescaled output in
    ``out_dtype``, or the raw s32 accumulator for ``torch.int32``."""
    if x.dtype not in DTYPE_CODES or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"int8 conv: need a contiguous float NHWC x, got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, h, w, cin = x.shape
    cout = qw.wq_nk.shape[0]
    if tuple(qw.wq_nk.shape) != (cout, 9 * cin) or k4_path(x, qw) != "wgmma":
        raise ValueError(f"int8 conv: x {tuple(x.shape)} and weight "
                         f"{tuple(qw.wq_nk.shape)} do not fit the wgmma path")
    _check_bias(bias, cout)
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=x.device)
    absmax = parts = None
    if qw.inv_a is None:
        absmax = torch.empty((b,), dtype=torch.float32, device=x.device)
        parts = torch.empty((b, ABSMAX_PARTS), dtype=torch.float32, device=x.device)
    elif (qw.inv_a.dtype != torch.float32 or tuple(qw.inv_a.shape) != (cin,)
          or not qw.inv_a.is_contiguous()):
        raise ValueError("int8 conv: inv_a must be a contiguous float32 (Cin,)")
    rc = _kernel_fns()[2](
        x.data_ptr(), DTYPE_CODES[x.dtype], qw.wq_nk.data_ptr(),
        None if qw.inv_a is None else qw.inv_a.data_ptr(),
        None if absmax is None else absmax.data_ptr(),
        None if parts is None else parts.data_ptr(), qw.w_scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), OUT_CODES[out_dtype],
        b, h, w, cin, cout, torch.cuda.current_stream(x.device).cuda_stream)
    check_cuda_result("int8 conv (wgmma)", rc)
    return out, absmax


def int8_quantize_cuda(x: torch.Tensor, inv_a: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K4's quantize on a CUDA tensor: ``(codes int8, absmax float32 (B,))``
    in dynamic mode (``inv_a`` None), ``(codes, None)`` in static mode."""
    if x.dtype not in DTYPE_CODES or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"int8 quantize: need a contiguous float NHWC x, got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, h, w, c = x.shape
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    absmax = None
    if inv_a is None:
        absmax = torch.empty((b,), dtype=torch.float32, device=x.device)
    elif inv_a.dtype != torch.float32 or tuple(inv_a.shape) != (c,) or not inv_a.is_contiguous():
        raise ValueError("int8 quantize: inv_a must be a contiguous float32 (C,)")
    rc = _kernel_fns()[0](
        x.data_ptr(), DTYPE_CODES[x.dtype], None if inv_a is None else inv_a.data_ptr(),
        None if absmax is None else absmax.data_ptr(), q.data_ptr(), b, h * w * c, c,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_cuda_result("int8 quantize", rc)
    return q, absmax


def int8_conv_cuda(q: torch.Tensor, qw: Int8Weight, absmax: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """K4's s8 implicit GEMM on the codes: the rescaled output in
    ``out_dtype``, or the raw s32 accumulator for ``torch.int32``."""
    b, h, w, cin = q.shape
    cout = qw.wq_nk.shape[0]
    if (q.dtype != torch.int8 or not q.is_contiguous()
            or tuple(qw.wq_nk.shape) != (cout, 9 * cin)):
        raise ValueError(f"int8 conv: codes {q.dtype} {tuple(q.shape)} and weight "
                         f"{tuple(qw.wq_nk.shape)} do not fit")
    _check_bias(bias, cout)
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=q.device)
    rc = _kernel_fns()[1](
        q.data_ptr(), qw.wq_nk.data_ptr(), None if absmax is None else absmax.data_ptr(),
        qw.w_scale.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
        OUT_CODES[out_dtype], b, h, w, cin, cout,
        torch.cuda.current_stream(q.device).cuda_stream)
    check_cuda_result("int8 conv", rc)
    return out


def int8_conv3x3(x: torch.Tensor, w: Optional[torch.Tensor], bias: Optional[torch.Tensor], *,
                 absmax_c: Optional[Sequence[float]] = None, compute_dtype: torch.dtype,
                 qweight: Optional[Int8Weight] = None) -> torch.Tensor:
    """W8A8 3x3 stride-1 SAME conv.  x (B,H,W,Cin) in any float dtype, w
    the fp32 HWIO parameter (or ``qweight``, its quantized form from an
    ``Int8WeightCache``), bias float32 (Cout,) or None; static scales when
    ``absmax_c`` is given.  Returns (B,H,W,Cout) in ``compute_dtype``.
    Inference only: raises if a gradient is required."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        raise RuntimeError("int8_conv3x3 has no backward: the int8 path serves inference "
                           "only (use no_grad, or the module's training mode)")
    qw = qweight if qweight is not None else quantize_conv_weight(w, absmax_c)
    mode = "dynamic" if qw.inv_a is None else "static"
    key = (tuple(x.shape), qw.wq.shape[-1], x.dtype, compute_dtype, mode)
    if not use_kernel("int8_conv3x3", key, x, qw.wq, bias):
        return int8_conv3x3_plain(x, qw, bias, compute_dtype)
    if compute_dtype not in DTYPE_CODES:
        raise TypeError(f"int8_conv3x3: compute dtype {compute_dtype}")
    x = x.contiguous()
    path = k4_path(x, qw)
    if path == "wgmma":
        out, _ = int8_fused_cuda(x, qw, bias, compute_dtype)
    else:
        q, absmax = int8_quantize_cuda(x, qw.inv_a)
        out = int8_conv_cuda(q, qw, absmax, bias, compute_dtype)
    int8_conv3x3.launches += 1
    int8_conv3x3.path_launches[path] += 1
    return out


int8_conv3x3.launches = 0
# the launches of each path (k4_path): the main path's shapes take "wgmma"
int8_conv3x3.path_launches = {"wgmma": 0, "general": 0}


class Int8WeightCache:
    """The quantized weight of one routed conv: rebuilt when a source
    parameter moves or changes (``data_ptr``, ``_version``: a
    ``load_state_dict`` after a forward is never served stale) or when the
    calibration site changes (one entry: a module serves one calibration)."""

    def __init__(self) -> None:
        self._entry = None

    def get(self, sources: Sequence[torch.Tensor], make_weight: Callable[[], torch.Tensor],
            absmax_c: Optional[Sequence[float]]) -> Int8Weight:
        if any(t.is_inference() for t in sources):
            # made under inference_mode: no version counter, so no cache
            return quantize_conv_weight(make_weight(), absmax_c)
        stamp = tuple((t.data_ptr(), t._version) for t in sources)
        entry = self._entry
        if entry is not None and entry[0] == stamp and entry[1] is absmax_c:
            return entry[2]
        qw = quantize_conv_weight(make_weight(), absmax_c)
        self._entry = (stamp, absmax_c, qw)
        return qw


def routed_conv(x: torch.Tensor, cout: int, make_weight: Callable[[], torch.Tensor],
                sources: Sequence[torch.Tensor], bias: Optional[torch.Tensor],
                compute_dtype: torch.dtype, cache: Int8WeightCache) -> torch.Tensor:
    """One int8-routed conv site under the enclosing scopes: a record
    scope logs its per-channel absmax (and it runs dynamic); a static
    calibration gives it the next site's scales, whose ``(cin, cout)``
    must match; else dynamic scales."""
    cin = x.shape[-1]
    absmax_c = None
    sink: Optional[List] = _RECORD.get()
    scope = _SCOPE.get()
    if sink is not None:
        sink.append((cin, cout, x.to(torch.float32).abs().amax(dim=(0, 1, 2))))
    elif scope is not None and scope.calib is not None:
        idx = scope.consumed
        scope.consumed = idx + 1
        sites = scope.calib.sites
        if idx >= len(sites):
            raise ValueError(
                f"int8 calibration has {len(sites)} sites but the forward reached site "
                f"#{idx}: the calibration was recorded for a different architecture or "
                "routing threshold")
        ci, co, absmax_c = sites[idx]
        if (ci, co) != (cin, cout):
            raise ValueError(
                f"int8 calibration site #{idx} is ({ci},{co}) but the forward hit a "
                f"({cin},{cout}) conv: calibration/architecture drift")
    qw = cache.get(sources, make_weight, absmax_c)
    return int8_conv3x3(x, None, bias, absmax_c=absmax_c, compute_dtype=compute_dtype,
                        qweight=qw)
