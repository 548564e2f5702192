"""Ops of the port: the FIR family (plain PyTorch) and the hand-written
CUDA kernels K1 (``conv3x3``), K2a (``fir_down2``) and K2b (``fir_up2``)."""

from mudiff_torch.ops._dispatch import plain_kernels, record_calls
from mudiff_torch.ops.conv3x3 import conv3x3, conv3x3_plain
from mudiff_torch.ops.fir import fir_down2, fir_up2
from mudiff_torch.ops.upfirdn2d import (
    conv_downsample_2d,
    downsample_2d,
    setup_fir_kernel,
    upfirdn2d,
    upsample_2d,
)

KERNEL_WRAPPERS = {"conv3x3": conv3x3, "fir_down2": fir_down2, "fir_up2": fir_up2}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
