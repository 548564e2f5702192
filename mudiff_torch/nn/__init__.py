"""Layers, blocks and stems of the port (NHWC, float32 parameters)."""

from mudiff_torch.nn.blocks import (
    AdaptiveGroupNorm,
    AffineGroupNorm,
    AttnBlockpp,
    Combine,
    Downsample,
    FIRConv2d,
    GaussianFourierProjection,
    PlainGroupNorm,
    ResnetBlockBigGANppAdagn,
    ResnetBlockBigGANppAdagnOne,
    ResnetBlockDDPMppAdagn,
    Upsample,
    naive_downsample_2d,
    naive_upsample_2d,
)
from mudiff_torch.nn.fused_stems import ConvBlock, ConvBlockGAP, ConvFeatBlock
from mudiff_torch.nn.initializers import default_init, stylegan_dense_init
from mudiff_torch.nn.layers import (
    NIN,
    Conv1x1,
    Conv3x3,
    Dense,
    get_act,
    get_timestep_embedding,
    pixel_norm,
)
