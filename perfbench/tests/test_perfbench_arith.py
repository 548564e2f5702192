"""``perfbench.arith`` against counts made by hand at a tiny configuration
(32x32, nf 32, ch_mult (1, 2), one resblock a level, attention at 16x16)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import arith  # noqa: E402
from perfbench.tests.tiny import tiny_config  # noqa: E402


def conv(h, cin, cout, k=3):
    return 2 * h * h * cin * cout * k * k


# G1's 3x3 convs, one slice, in forward order, written out from the
# architecture: the four stems (1 -> 32, 32 -> 32 at 32x32, counted a stem),
# the trunk, the input pyramid's stride-2 conv and the head
G1_CONVS = (
    4 * conv(32, 1, 32) + 4 * conv(32, 32, 32)
    + conv(32, 128, 32) + conv(32, 32, 32)            # down_0_0
    + conv(16, 32, 32) + conv(16, 32, 32)             # downsample_0 (h resampled first)
    + conv(16, 1, 32)                                 # pyramid_downsample_0, 16x16 out
    + conv(16, 32, 64) + conv(16, 64, 64)             # down_1_0
    + 2 * (conv(16, 64, 64) + conv(16, 64, 64))       # mid_block1, mid_block2
    + conv(16, 128, 64) + conv(16, 64, 64)            # up_1_0: cat(64, 64)
    + conv(16, 96, 64) + conv(16, 64, 64)             # up_1_1: cat(64, 32)
    + conv(32, 64, 64) + conv(32, 64, 64)             # upsample_1 (h resampled first)
    + conv(32, 96, 32) + conv(32, 32, 32)             # up_0_0: cat(64, 32)
    + conv(32, 160, 32) + conv(32, 32, 32)            # up_0_1: cat(32, 128)
    + conv(32, 32, 1)                                 # final_conv
)
# three attention blocks at 16x16, C = 64: q k^T and w v
ATTN_PRODUCTS = 3 * 2 * (2 * 256 * 64 * 256)


def test_generator_conv_and_attention_operations():
    cfg = tiny_config()
    ops = arith.generator_ops(cfg, 1, adaptive=False, int8=False)
    convs = sum(2 * o[4] * o[5] * o[6] * o[7] * o[8] ** 2 for o in ops if o[0] == "conv")
    assert convs == G1_CONVS
    mm = sum(2 * o[1] * o[2] * o[3] * o[4] for o in ops if o[0] == "matmul")
    assert mm == ATTN_PRODUCTS


def test_g2_adds_its_stems_gates_and_style_branch():
    cfg = tiny_config()
    g1 = arith._work(arith.generator_ops(cfg, 1, False, False))
    g2 = arith._work(arith.generator_ops(cfg, 1, True, False))
    extra = (conv(32, 1, 32) + conv(32, 32, 32)          # the pseudo-target stem
             + conv(32, 96, 6 * 32) + 3 * conv(32, 32, 32))  # six gates, three weights
    conv_g1 = sum(o for o, _, _ in g1.convs)
    conv_g2 = sum(o for o, _, _ in g2.convs)
    assert conv_g2 - conv_g1 == extra


def test_conv_bytes_and_int8_split():
    cfg = tiny_config()
    ops = arith.generator_ops(cfg, 4, adaptive=False, int8=True)
    stem2 = [o for o in ops if o[0] == "conv"][4]       # the first stem's second conv
    w = arith._work([stem2])
    # bf16: input, weights, output once each (stem convs stay on bf16: the
    # fused stem conv2 is int8-routed at 4 nf = 128 >= max(64, 2 nf) = 64)
    assert stem2[-1] is True
    assert w.convs[0][1] == 4 * 32 * 32 * 32 * 2 + 9 * 32 * 32 * 1 + 4 * 32 * 32 * 32 * 2
    routed = arith._work(ops)
    assert routed.ops_int8 > 0 and routed.ops_bf16 > 0
    total = arith._work(arith.generator_ops(cfg, 4, adaptive=False, int8=False))
    assert routed.ops_int8 + routed.ops_bf16 == total.ops_bf16


def test_sample_and_train_work_scale_as_counted():
    cfg = tiny_config(image_size=64)
    s = arith.sample_work(cfg, int8=False)
    g = (arith._work(arith.generator_ops(cfg, 1, False, False)).ops_bf16
         + arith._work(arith.generator_ops(cfg, 1, True, False)).ops_bf16)
    assert s.ops_bf16 == cfg["num_timesteps"] * g
    crit = arith._work(arith.critic_ops(cfg, 2)).ops_bf16
    g2 = (arith._work(arith.generator_ops(cfg, 2, False, False)).ops_bf16
          + arith._work(arith.generator_ops(cfg, 2, True, False)).ops_bf16)
    plain = arith.train_work(cfg, 2, with_r1=False).ops_bf16
    assert plain == g2 + 9 * crit + 3 * g2 + 4 * crit
    assert arith.train_work(cfg, 2, with_r1=True).ops_bf16 == plain + 3 * crit
