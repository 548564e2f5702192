"""K5 (``ops.group_norm_act``, ``csrc/group_norm_kernel.cu``) on the CPU.

* The wrapper's plain path against the chains the norm modules ran before
  they called it (``blocks.group_norm``, then the modulation and
  ``F.silu``), bit for bit: affine, AdaGN, plain and the stems' stacked
  norm, SiLU on and off, fp32 and bf16, C / G from 4 to 32.
* Its backward (plain PyTorch) against autograd through the plain chain:
  float64 to 1e-10, bf16 within BF16_GRAD_TOL.
* A replay of the kernels' launch geometry and order of sums, its
  constants read from the kernel source: every input element read once by
  the stats kernel and every output written once by the apply kernel, at
  the path's shapes; the replayed mean and variance within fp32 rounding
  of a float64 reference.
* ``record_calls``: one G1 and one G2 forward route every norm through
  ``group_norm_act``.

The kernel itself is held against its plain version on the card by
``chip_smoke.py``.
"""

from __future__ import annotations

import math
import re

import pytest
import torch
import torch.nn.functional as F

from mudiff_torch import config, ops
from mudiff_torch.models import NCSNppGenerator
from mudiff_torch.nn import blocks, fused_stems
from mudiff_torch.ops import _build
from mudiff_torch.ops import group_norm as k5

_SRC = (_build.CSRC / "group_norm_kernel.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


THREADS = _constant("THREADS")
MAX_THREADS = _constant("MAX_THREADS")
VECTOR_BYTES = _constant("VECTOR_BYTES")
TARGET_BLOCKS = _constant("TARGET_BLOCKS")
SOFT_CHUNKS = _constant("SOFT_CHUNKS")
MIN_BLOCKS = _constant("MIN_BLOCKS")
MAX_CHUNKS = _constant("MAX_CHUNKS")
MIN_CHUNK_BYTES = _constant("MIN_CHUNK_BYTES")
MAX_CHANNELS = _constant("MAX_CHANNELS")

# bf16 gradients: K5's backward takes the whole chain in fp32, autograd
# through the plain chain rounds the modulation's and SiLU's gradients to
# bf16 on the way; their distance, relative in the max norm
BF16_GRAD_TOL = 2e-2


def _x(shape, dtype=torch.float32, seed=0, offset=0.5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 1.7 + offset).to(dtype)


# --- the plain path against the modules' former chains ----------------------

# (C, G): C / G = 4, 8, 12, 32, as min(C // 4, 32) gives on the path
WIDTHS = [(64, 16), (256, 32), (384, 32), (1024, 32)]


def _former_affine(m, x, silu):
    h = blocks.group_norm(x, m.num_groups, m.dtype, m.weight, m.bias)
    return F.silu(h) if silu else h


def _former_adagn(m, x, style, silu):
    gamma, beta = m.style(style).chunk(2, dim=-1)
    h = blocks.group_norm(x, blocks._num_groups(m.channels), m.dtype)
    h = gamma[:, None, None, :] * h + beta[:, None, None, :]
    return F.silu(h) if silu else h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("silu", [False, True], ids=["id", "silu"])
@pytest.mark.parametrize("c,groups", WIDTHS, ids=[f"C{c}G{g}" for c, g in WIDTHS])
@pytest.mark.parametrize("kind", ["affine", "adagn", "plain"])
def test_modules_equal_their_former_chains(kind, c, groups, silu, dtype):
    x = _x((2, 5, 3, c), dtype)
    with torch.no_grad():
        if kind == "affine":
            m = blocks.AffineGroupNorm(groups, c, dtype=dtype)
            m.weight.copy_(_x((c,), seed=1, offset=1.0))
            m.bias.copy_(_x((c,), seed=2, offset=0.0))
            got, want = m(x, silu=silu), _former_affine(m, x, silu)
        elif kind == "adagn":
            m = blocks.AdaptiveGroupNorm(c, 12, dtype=dtype)
            m.style.reset_parameters(torch.Generator().manual_seed(3))
            style = _x((2, 12), seed=4)
            got, want = m(x, style, silu=silu), _former_adagn(m, x, style, silu)
        else:
            got = blocks.PlainGroupNorm()(x, silu=silu)
            want = blocks.group_norm(x, blocks._num_groups(c), x.dtype)
            want = F.silu(want) if silu else want
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n_stems,f", [(4, 16), (5, 16), (4, 64), (5, 128)])
def test_stacked_norm_equals_the_former_chain(n_stems, f, dtype):
    """G1's four and G2's five stems: groups inside stems, then SiLU."""
    h = _x((2, 4, 3, n_stems * f), dtype, seed=5)
    gps = blocks._num_groups(f)
    got = fused_stems.stacked_group_norm(h, n_stems, gps)
    assert torch.equal(got, F.silu(blocks.group_norm(h, n_stems * gps, h.dtype)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_fp32_input_normed_into_the_compute_dtype(dtype):
    """``AttnBlockpp._out`` under skip_rescale returns fp32, and the
    ``torch.cat``s that meet it promote: the norm reads fp32, writes the
    compute dtype."""
    x = _x((2, 4, 4, 128), torch.float32, seed=6)
    m = blocks.AffineGroupNorm(32, 128, dtype=dtype)
    got = m(x, silu=True)
    assert got.dtype == dtype and torch.equal(got, _former_affine(m, x, True))


def test_the_g2_stems_slices_equal_the_stacked_norm():
    """G2's fused encode norms the pseudo stem, the x stem and the three
    condition stems (AdaGN) apart, each reading its channel slice of the
    first conv's output in place: the bits of the stacked norm the encode
    ran before, its SiLU on each stem's slice and the modulation's dense
    product."""
    f, n = 16, 5
    h = _x((2, 6, 6, n * f), seed=7)
    gps = blocks._num_groups(f)
    whole = blocks.group_norm(h, n * gps, h.dtype)
    style = torch.cat([_x((2, 3 * f), seed=8), _x((2, 3 * f), seed=9)], dim=-1)
    gamma, beta = style.chunk(2, dim=-1)
    conds = fused_stems.stacked_group_norm(h[..., f:4 * f], 3, gps, style=style)
    assert torch.equal(conds, F.silu(gamma[:, None, None, :] * whole[..., f:4 * f]
                                     + beta[:, None, None, :]))
    for sl in (slice(0, f), slice(4 * f, 5 * f)):
        assert k5.pixel_stride(h[..., sl]) == n * f
        assert torch.equal(fused_stems.stacked_group_norm(h[..., sl], 1, gps),
                           F.silu(whole[..., sl]))


def test_wrapper_refuses_what_it_cannot_do():
    x = _x((2, 3, 3, 24))
    with pytest.raises(ValueError, match="divisible"):
        ops.group_norm_act(x, 5, x.dtype)
    with pytest.raises(ValueError, match="without an affine"):
        ops.group_norm_act(x, 6, x.dtype, weight=torch.ones(24), style=torch.ones(2, 48))


def test_cpu_calls_are_recorded_and_launch_nothing():
    x = _x((2, 3, 3, 24))
    before = ops.group_norm_act.launches
    log = []
    with ops.record_calls(log):
        ops.group_norm_act(x[..., :16], 4, torch.bfloat16, style=torch.ones(2, 32,
                                                                          dtype=torch.bfloat16),
                           silu=True)
    assert ops.group_norm_act.launches == before
    assert log == [("group_norm_act", ((2, 3, 3, 16), 24, 4, torch.float32, torch.bfloat16,
                                       "style", True))]


# --- the backward --------------------------------------------------------------


def _inputs(kind, c, dtype, seed):
    x = _x((2, 5, 4, c), dtype, seed=seed)
    w = b = style = None
    if kind == "affine":
        w = _x((c,), torch.float64 if dtype == torch.float64 else torch.float32, seed + 1, 1.0)
        b = _x((c,), w.dtype, seed + 2, 0.0)
    elif kind == "adagn":
        style = _x((2, 2 * c), dtype, seed + 3, 0.5)
    return [t if t is None else t.requires_grad_() for t in (x, w, b, style)]


def _grads(fn, inputs, seed):
    out = fn(*inputs)
    g = _x(tuple(out.shape), out.dtype, seed=seed + 9, offset=0.0)
    present = [t for t in inputs if t is not None]
    return torch.autograd.grad(out, present, g)


@pytest.mark.parametrize("silu", [False, True], ids=["id", "silu"])
@pytest.mark.parametrize("c,groups", [(64, 16), (96, 8), (128, 4)])
@pytest.mark.parametrize("kind", ["affine", "adagn", "plain"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16], ids=["fp64", "bf16"])
def test_backward_matches_autograd_through_the_plain_chain(dtype, kind, c, groups, silu):
    inputs = _inputs(kind, c, dtype, seed=c + groups)

    def wrapper(x, w, b, s):
        return ops.group_norm_act(x, groups, dtype, w, b, s, silu)

    def chain(x, w, b, s):
        return k5.group_norm_act_plain(x, groups, dtype, w, b, s, silu)

    got = _grads(wrapper, inputs, c)
    want = _grads(chain, inputs, c)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape
        if dtype == torch.float64:
            torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-10)
        else:
            err = (g.double() - r.double()).abs().max() / r.double().abs().max()
            assert err <= BF16_GRAD_TOL, float(err)


def test_backward_through_a_channel_slice_and_without_a_graph():
    """The G2 stems' strided input gets a dense gradient; under
    inference_mode nothing is saved."""
    h = _x((2, 4, 4, 40), torch.float64, seed=11).requires_grad_()
    out = ops.group_norm_act(h[..., 8:32], 6, torch.float64, silu=True)
    ref = k5.group_norm_act_plain(h[..., 8:32], 6, torch.float64, silu=True)
    g = _x(tuple(out.shape), torch.float64, seed=12)
    (got,) = torch.autograd.grad(out, h, g)
    (want,) = torch.autograd.grad(ref, h, g)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    assert float(got[..., :8].abs().max()) == 0.0
    with torch.inference_mode():
        assert torch.equal(ops.group_norm_act(h.detach(), 8, torch.float64),
                           k5.group_norm_act_plain(h.detach(), 8, torch.float64))


# --- the kernels' launch geometry and order of sums, replayed -------------------


def test_wrapper_constants_are_the_kernels():
    assert k5.VECTOR_BYTES == VECTOR_BYTES and k5.MAX_CHUNKS == MAX_CHUNKS


def plan(batch, hw, c, itemsize, vector):
    """(channels a vector, vectors a pixel, threads, rows, chunk pixels,
    chunks) as ``gnorm::plan`` computes them."""
    n = VECTOR_BYTES // itemsize if vector else 1
    vecs = c // n
    threads = THREADS if vecs <= THREADS else math.ceil(vecs / 32) * 32
    rows = threads // vecs
    chunks = max(min(math.ceil(TARGET_BLOCKS / batch), SOFT_CHUNKS),
                 math.ceil(MIN_BLOCKS / batch))
    chunks = max(min(chunks, hw * c * itemsize // MIN_CHUNK_BYTES, math.ceil(hw / rows),
                     MAX_CHUNKS), 1)
    chunk_pixels = math.ceil(hw / chunks)
    return n, vecs, threads, rows, chunk_pixels, math.ceil(hw / chunk_pixels)


# (H*W at 32², C, itemsize) of every norm of a G1 + G2 forward at
# brats_recipe(num_channels_dae=nf): the widths, their skip concats, fp32
# where an attention output meets them, the stacked stems (G1 4 nf, G2's
# slices of 5 nf); ``test_path_widths_are_the_recipes`` records them
PATH_WIDTHS = {
    128: [(64, 256, 2), (64, 512, 2), (64, 512, 4), (64, 768, 2), (64, 1024, 2),
          (256, 128, 2), (256, 256, 2), (256, 256, 4), (256, 384, 2), (256, 512, 2),
          (256, 512, 4), (256, 768, 4), (1024, 128, 2), (1024, 256, 2), (1024, 384, 2),
          (1024, 512, 2), (1024, 640, 2)],
    64: [(64, 128, 2), (64, 256, 2), (64, 256, 4), (64, 384, 2), (64, 512, 2),
         (256, 64, 2), (256, 128, 2), (256, 128, 4), (256, 192, 2), (256, 256, 2),
         (256, 256, 4), (256, 384, 4), (1024, 64, 2), (1024, 128, 2), (1024, 192, 2),
         (1024, 256, 2), (1024, 320, 2)],
}


def test_path_widths_are_the_recipes():
    for nf, widths in PATH_WIDTHS.items():
        cfg = config.brats_recipe(num_channels_dae=nf, image_size=32)
        log = []
        with ops.record_calls(log), torch.inference_mode():
            for adaptive in (False, True):
                g = NCSNppGenerator(cfg, adaptive=adaptive, dtype=torch.bfloat16,
                                    generator=torch.Generator().manual_seed(0)).eval()
                x = torch.randn(1, 32, 32, 1)
                g(x, x, x, x, torch.tensor([1]), torch.randn(1, cfg.nz),
                  pseudo_target=x if adaptive else None)
        got = {(key[0][1] * key[0][2], key[0][3], torch.empty((), dtype=key[3]).element_size())
               for name, key in log if name == "group_norm_act"}
        assert got == set(widths), nf


# the benchmark's batches at 256² (H*W 64x the 32² record): nf 128 sampling
# at 8 and training at 2, nf 64 sampling at 32
PATH_SHAPES = sorted({(b, 64 * hw, c, size) for nf, batches in ((128, (8, 2)), (64, (32,)))
                      for b in batches for hw, c, size in PATH_WIDTHS[nf]})


@pytest.mark.parametrize("batch,hw,c,itemsize", PATH_SHAPES,
                         ids=[f"b{b}-hw{h}-c{c}-{s}B" for b, h, c, s in PATH_SHAPES])
def test_every_element_has_one_owner_at_the_path_shapes(batch, hw, c, itemsize):
    """Each block (chunk, example), each thread (row r, vector v): pixels
    p0 + r, + rows, ... < p1.  Both kernels share the mapping; the stats
    kernel reads each (pixel, vector) once, the apply kernel writes each
    once."""
    n, vecs, threads, rows, chunk_pixels, chunks = plan(batch, hw, c, itemsize, True)
    assert threads <= MAX_THREADS and vecs * n == c and c <= MAX_CHANNELS
    assert chunks <= MAX_CHUNKS and (chunks - 1) * chunk_pixels < hw <= chunks * chunk_pixels
    assert 2 * 4 * rows * c <= 48 * 1024  # the stats kernel's shared memory
    count = torch.zeros(hw, dtype=torch.int32)
    t = torch.arange(rows * vecs)
    r = t // vecs
    for k in range(chunks):
        p0, p1 = k * chunk_pixels, min((k + 1) * chunk_pixels, hw)
        steps = torch.arange(math.ceil((p1 - p0) / rows))
        p = (p0 + r[:, None] + steps[None, :] * rows).reshape(-1)
        count.index_add_(0, p[p < p1], torch.ones_like(p[p < p1], dtype=torch.int32))
    # every thread of a row covers one vector of each of its pixels
    assert torch.equal(count, torch.full((hw,), vecs, dtype=torch.int32))
    # where the size does not cap the chunks, the benchmark's batches fill
    # the card: 4 waves of 2 blocks an SM at 32, 2 at 8, one at 2
    if hw * c * itemsize >= MAX_CHUNKS * MIN_CHUNK_BYTES:
        assert chunks * batch == {32: 1056, 8: 528, 2: 256}[batch]


class Replay:
    """The two kernels' sums for one example, every thread at once: the
    stats kernel's per-thread sums (pixels in order; squares by fmaf),
    rows in order, channels in order; the apply kernel's chunks, ``lanes``
    strided sets in order, then the lanes in order."""

    def __init__(self, x: torch.Tensor, groups: int, vector: bool, batch: int):
        self.hw, self.c = x.shape
        self.groups, self.cpg = groups, self.c // groups
        self.x = x.float()
        (self.n, self.vecs, self.threads, self.rows, self.chunk_pixels,
         self.chunks) = plan(batch, self.hw, self.c, x.element_size(), vector)

    def partials(self):
        """(chunks, groups, 2): each chunk's (sum, sum of squares)."""
        out = []
        for k in range(self.chunks):
            p0, p1 = k * self.chunk_pixels, min((k + 1) * self.chunk_pixels, self.hw)
            s = torch.zeros(self.rows, self.c)
            q = torch.zeros(self.rows, self.c)
            for base in range(p0, p1, self.rows):
                p = base + torch.arange(self.rows)
                live = (p < p1)[:, None]
                f = self.x[p.clamp_max(self.hw - 1)]
                s = torch.where(live, s + f, s)
                fma = (f.double() * f.double() + q.double()).float()
                q = torch.where(live, fma, q)
            for row in range(1, self.rows):  # rows in order, into row 0
                s[0] += s[row]
                q[0] += q[row]
            gs = torch.zeros(self.groups)
            gq = torch.zeros(self.groups)
            for j in range(self.cpg):       # channels of a group in order
                gs += s[0, j::self.cpg]
                gq += q[0, j::self.cpg]
            out.append(torch.stack([gs, gq], dim=-1))
        return torch.stack(out)

    def moments(self):
        """(mean, var) per group, as the apply kernel forms them."""
        part = self.partials()
        lanes = max(1, self.threads // self.groups)
        acc = torch.zeros(lanes, self.groups, 2)
        for lane in range(lanes):
            for k in range(lane, self.chunks, lanes):
                acc[lane] += part[k]
        tot = acc[0].clone()
        for lane in range(1, lanes):
            tot += acc[lane]
        inv_n = torch.tensor(1.0, dtype=torch.float32) / (self.hw * self.cpg)
        mean = tot[:, 0] * inv_n
        var = (tot[:, 1] * inv_n - mean * mean).clamp_min(0.0)
        return mean, var


REPLAYS = [  # (hw, C, groups, dtype, vector, batch): the recipe's widths at 64² and 32²,
    (4096, 128, 32, torch.bfloat16, True, 8),        # ragged chunks, the scalar path,
    (4096, 640, 160, torch.bfloat16, True, 8),       # G2's five stems at nf 128,
    (1024, 1024, 32, torch.float32, True, 2),        # fp32 at the widest concat,
    (1000, 24, 6, torch.float32, False, 3),
    (4096, 64, 16, torch.bfloat16, True, 32),
    (777, 96, 8, torch.float16, True, 1),
]


@pytest.mark.parametrize("hw,c,groups,dtype,vector,batch", REPLAYS,
                         ids=[f"hw{r[0]}-c{r[1]}-g{r[2]}" for r in REPLAYS])
def test_replayed_statistics_are_within_fp32_rounding(hw, c, groups, dtype, vector, batch):
    x = (torch.randn(hw, c, generator=torch.Generator().manual_seed(hw + c)) * 2.0
         + torch.linspace(-1.5, 3.0, c)).to(dtype)
    replay = Replay(x, groups, vector, batch)
    assert replay.chunks > 1 or hw * c * x.element_size() < 2 * MIN_CHUNK_BYTES
    mean, var = replay.moments()
    xd = x.double().reshape(hw, groups, c // groups)
    ref_mean = xd.mean(dim=(0, 2))
    ref_var = xd.var(dim=(0, 2), unbiased=False)
    ex2 = (xd * xd).mean(dim=(0, 2))
    # fp32 sums of n terms: a few ulps of the sum of |x| (of x^2), and var =
    # E[x^2] - mean^2 inherits E[x^2]'s error
    eps = 2.0 ** -23
    assert ((mean.double() - ref_mean).abs() <= 64 * eps * xd.abs().mean(dim=(0, 2))).all()
    assert ((var.double() - ref_var).abs() <= 64 * eps * ex2).all()
    # and no worse than the plain chain's own fp32 statistics, by much
    plain_mean, plain_rstd = k5.group_stats_plain(x.reshape(1, hw, 1, c), groups)
    plain_err = (plain_mean[0].double() - ref_mean).abs().max()
    assert (mean.double() - ref_mean).abs().max() <= max(8 * plain_err, 4 * eps * ex2.max())


# --- a generator forward: every norm through the wrapper -------------------------


SMALL = dict(image_size=32, num_channels=1, num_channels_dae=16, ch_mult=(1, 2),
             num_res_blocks=1, attn_resolutions=(16,), z_emb_dim=32, nz=16, n_mlp=3)


@pytest.mark.parametrize("adaptive", [False, True], ids=["G1", "G2"])
def test_a_generator_forward_routes_every_norm_through_k5(adaptive):
    """SMALL: 2 levels (32², 16²), one resblock a level, so 2 + 1 down (with
    the downsampling one), 2 middle, 2 x 2 + 1 up resblocks = 10, two AdaGN
    norms and SiLUs each; three attention blocks (16²: one down, the middle,
    one up), an affine norm each, without SiLU; ``final_norm`` with SiLU;
    the fused stems, G1 one plain call, G2 two plain (the pseudo and x
    stems) and one AdaGN (the conditions): 25 calls in G1 and 27 in G2,
    and every norm module the forward runs is one of them."""
    g = NCSNppGenerator(config.MuDiffConfig(**SMALL), adaptive=adaptive,
                        generator=torch.Generator().manual_seed(0)).eval()
    rng = torch.Generator().manual_seed(1)
    x, c1, c2, c3 = (torch.randn(2, 32, 32, 1, generator=rng) for _ in range(4))
    kw = {"pseudo_target": torch.tanh(x)} if adaptive else {}
    log = []
    with torch.inference_mode(), ops.record_calls(log):
        g(x, c1, c2, c3, torch.tensor([0, 3]), torch.randn(2, 16, generator=rng), **kw)
    norms = [key for name, key in log if name == "group_norm_act"]
    assert len(norms) == (27 if adaptive else 25) == g.kernel_launches_per_forward()[
        "group_norm_act"]
    kinds = [(kind, silu) for *_, kind, silu in norms]
    assert kinds.count(("style", True)) == (21 if adaptive else 20)
    assert kinds.count(("affine", False)) == 3  # the attention norms feed their NINs
    assert kinds.count(("affine", True)) == 1   # final_norm, then final_conv
    assert kinds.count(("plain", True)) == (2 if adaptive else 1)  # the stems
    modules = (blocks.AffineGroupNorm, blocks.AdaptiveGroupNorm, blocks.PlainGroupNorm)
    # G2's stem AdaGN modules lend the fused encode their style denses only
    assert sum(isinstance(m, modules) for m in g.modules()) == 24 + (3 if adaptive else 0)
