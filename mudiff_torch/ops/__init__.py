"""Ops of the port: the FIR family, ``upsample_conv_2d`` /
``conv_downsample_2d`` and ``fused_leaky_relu`` (plain PyTorch), and the
hand-written CUDA kernels K1 (``conv3x3``), K2a (``fir_down2``), K2b
(``fir_up2``), K3 (``flash_attn``), K3's backward (``flash_attn_bwd_dkv``,
``flash_attn_bwd_dq``), K4 (``int8_conv3x3``, W8A8, inference only) and K5
(``group_norm_act``: GroupNorm / AdaGN with its SiLU).  The other wrappers
are differentiable: K2 twice, K1, K3 and K5 once (K5's backward is plain
PyTorch)."""

from mudiff_torch.ops._dispatch import plain_kernels, record_calls
from mudiff_torch.ops.conv3x3 import conv3x3, conv3x3_plain
from mudiff_torch.ops.fir import fir_down2, fir_up2
from mudiff_torch.ops.fused_act import fused_leaky_relu
from mudiff_torch.ops.group_norm import group_norm_act, group_norm_act_plain
from mudiff_torch.ops.flash_attn import (
    attn_di,
    flash_attn,
    flash_attn_bwd_dkv,
    flash_attn_bwd_dq,
    flash_attn_bwd_plain,
    flash_attn_plain,
    row_stats_plain,
)
from mudiff_torch.ops.int8_conv import int8_conv3x3, int8_conv3x3_plain
from mudiff_torch.ops.upfirdn2d import (
    conv_downsample_2d,
    downsample_2d,
    setup_fir_kernel,
    upfirdn2d,
    upsample_2d,
    upsample_conv_2d,
)

KERNEL_WRAPPERS = {"conv3x3": conv3x3, "fir_down2": fir_down2, "fir_up2": fir_up2,
                   "flash_attn": flash_attn, "flash_attn_bwd_dkv": flash_attn_bwd_dkv,
                   "flash_attn_bwd_dq": flash_attn_bwd_dq, "int8_conv3x3": int8_conv3x3,
                   "group_norm_act": group_norm_act}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "path_launches"):
            fn.path_launches = dict.fromkeys(fn.path_launches, 0)


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
