#!/usr/bin/env python3
"""Where one block of K1's wgmma kernel spends its time, on one NVIDIA GPU.

    python3 k1_timeline.py [--out FILE.json]

Builds a copy of ``mudiff_torch/csrc/conv3x3_kernel.cu`` with clock
stamps (``clock64``; ``globaltimer`` and the SM id at a block's start and
end) written at the wgmma kernel's hand-over points, into the git-ignored
``mudiff_torch/_build/timeline/``, and runs it in bf16 at five shapes of
the main paths: the 64-channel conv at 256^2 and the 128-channel one of
the nf=64 sampler at batch 4, its 256-channel conv at 64^2, a
64-channel conv at 64^2 and batch 2 (64 blocks, a grid as small as the
training batch's smallest), and the nf=128 decoder's widest conv at
batch 8.  Prints, per shape, the median over
blocks (clocks) of: the prologue up to the consumers' first product (the
first patch's and weight tile's TMA), the consumers' chunk-to-chunk
intervals, the main loop, the clocks consumer 0 waited for weight tiles
in it, and the epilogue; the block's wall time and the most blocks
resident on one SM at once (ns, globaltimer; the median over SMs); the
main loop's tensor rate against an SM's peak.  The
stamps cost a few global stores and one barrier a block; the library
the port loads is not touched.  The hand-over points are found by their
source text: an edit there makes this script fail loudly.  Exits
non-zero when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys

SLOTS = 20
MAX_BLOCKS = 16384
# dense bf16 flops an SM a clock: 989 TFLOP/s over 132 SMs at the 1830 MHz
# the data sheet's peak assumes
SM_FLOPS_PER_CLK = 4096
SHAPES = (((4, 256, 256, 64), 64), ((4, 256, 256, 128), 128), ((4, 64, 64, 256), 256),
          ((2, 64, 64, 64), 64), ((8, 64, 64, 1024), 512))

# (source text, stamp inserted after it); slots: 0 block start, 1 first
# patch issued, 2 + c consumers start chunk c (c < 4), 6 first product
# issued, 7 last product done, 8 block end (all stores issued), 9 clocks
# consumer 0 waited on weight tiles; 17 / 18 globaltimer at start / end,
# 19 the SM id
STAMPS = (
    ("    asm volatile(\"fence.mbarrier_init.release.cluster;\\n\" ::: \"memory\");\n  }\n"
     "  __syncthreads();\n", "  if (threadIdx.x == 0) { TR(0); TG(17); }\n"),
    ("      load_patch(0);\n", "      TR(1);\n"),
    ("  uint32_t a[A_SETS][4];\n", "  long long b_wait = 0;\n"),
    ("    mbar_wait(&x_full[c & 1], (c >> 1) & 1);\n", "    if (ctid == 0 && c < 4) TR(2 + c);\n"),
    ("      const int sw = (px & 7) ^ hi;  // chunk 2 k + hi of the row lies at (2 k) ^ sw\n",
     "      const long long tb0 = clock64();\n"),
    ("      mbar_wait(&b_full[s], phase);\n",
     "      b_wait += clock64() - tb0;\n      if (ctid == 0 && c == 0 && t == 0) TR(6);\n"),
    ("  wgmma_wait<0>();\n#pragma unroll\n  for (int i = 0; i < NACC; ++i) fence_reg(acc[i]);\n",
     "  if (ctid == 0) { TR(7); TV(9, b_wait); }\n"),
    ("        *reinterpret_cast<const uint4*>(stage + mm * LD + 8 * v);\n  }\n",
     "  consumer_sync();\n  if (ctid == 0) { TR(8); TG(18); }\n"),
)

STAMP_DEFS = r'''
__device__ unsigned long long g_stamps[%(blocks)d * %(slots)d];
__device__ __forceinline__ void TV(int k, unsigned long long v) {
  if (blockIdx.x < %(blocks)d) g_stamps[blockIdx.x * %(slots)d + k] = v;
}
__device__ __forceinline__ void TR(int k) {
  unsigned long long c;
  asm volatile("mov.u64 %%0, %%%%clock64;" : "=l"(c));
  TV(k, c);
}
__device__ __forceinline__ void TG(int k) {
  unsigned long long t;
  unsigned s;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(s));
  TV(k, t);
  TV(19, s);
}
'''


def stamped_source(src: str) -> str:
    """The kernel source with the stamps and a reader of them."""
    defs = STAMP_DEFS % {"blocks": MAX_BLOCKS, "slots": SLOTS}
    src = src.replace("namespace wgmma {\n", "namespace wgmma {\n" + defs, 1)
    for anchor, stamp in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"k1_timeline: hand-over point not found once: {anchor!r}")
        src = src.replace(anchor, anchor + stamp)
    return src + ('\nextern "C" int k1_read_stamps(void* dst) {\n'
                  '  return (int)cudaMemcpyFromSymbol(dst, wgmma::g_stamps,\n'
                  '                                   sizeof(unsigned long long) * %d);\n}\n'
                  % (MAX_BLOCKS * SLOTS))


def build():
    from mudiff_torch.ops import _build

    out = _build.BUILD_DIR / "timeline"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "conv3x3_stamped.cu"
    cu.write_text(stamped_source((_build.CSRC / "conv3x3_kernel.cu").read_text()))
    lib = out / "libconv3x3_stamped.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"k1_timeline: nvcc failed\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def readings(stamps, blocks: int, chunks: int, block_flops: float):
    import numpy as np

    t = stamps[:blocks].astype(np.int64)

    def med(a, b):
        return float(np.median(t[:, b] - t[:, a]))

    shown = min(chunks, 4)
    resident = []  # per SM, the most of its blocks running at one time
    for sm in np.unique(t[:, 19]):
        mine = t[t[:, 19] == sm]
        starts, ends = mine[:, 17], mine[:, 18]
        resident.append(max(int(((starts <= s) & (ends > s)).sum()) for s in starts))
    main_loop = med(6, 7)
    return {
        "blocks": blocks, "chunks": chunks,
        "block_clk": med(0, 8),
        "prologue_clk": med(0, 6),
        "first_patch_tma_clk": med(1, 2),
        "consumer_chunk_clk": [med(2 + c, 3 + c) for c in range(shown - 1)],
        "main_loop_clk": main_loop,
        "weight_wait_clk": float(np.median(t[:, 9])),
        "epilogue_clk": med(7, 8),
        "block_ns": float(np.median(t[:, 18] - t[:, 17])),
        "kernel_ns": float(t[:, 18].max() - t[:, 17].min()),
        "most_blocks_resident_on_an_sm": float(np.median(resident)),
        # the main loop's flops a clock against an SM's peak; the blocks
        # resident on the SM share that peak
        "main_loop_share_of_sm_peak": block_flops / main_loop / SM_FLOPS_PER_CLK,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the readings here (JSON)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_timeline: no CUDA device", file=sys.stderr)
        return 2
    from mudiff_torch.ops import _build, conv3x3_plain

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    src = (_build.CSRC / "conv3x3_kernel.cu").read_text()
    ns = src[src.index("namespace wgmma {"):]
    tile_m = int(re.search(r"constexpr int TILE_M = (\d+);", ns).group(1))
    tile_w = int(re.search(r"constexpr int TILE_W = (\d+);", ns).group(1))
    lib = build()
    fn = lib.mudiff_conv3x3_wgmma
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = torch.Generator("cuda").manual_seed(0)
    result = {"card": card}
    for xshape, cout in SHAPES:
        b, h, w, cin = xshape
        x = torch.randn(xshape, generator=g, device="cuda").to(torch.bfloat16)
        wt = (torch.randn((3, 3, cin, cout), generator=g, device="cuda")
              / math.sqrt(9 * cin)).to(torch.bfloat16)
        bn = 128 if cout % 128 == 0 else 64
        tw = min(w, tile_w)
        blocks = b * math.ceil(h / (tile_m // tw)) * math.ceil(w / tw) * math.ceil(cout / bn)
        if blocks > MAX_BLOCKS:
            raise RuntimeError(f"k1_timeline: {blocks} blocks exceed {MAX_BLOCKS}")
        out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device="cuda")
        for _ in range(3):  # the last run's stamps are read
            rc = fn(x.data_ptr(), wt.data_ptr(), None, out.data_ptr(), b, h, w, cin, cout, 1,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"k1_timeline: launch failed with {rc}")
        torch.cuda.synchronize()
        err = float((out.float() - conv3x3_plain(x, wt).float()).abs().max())
        buf = (ctypes.c_ulonglong * (MAX_BLOCKS * SLOTS))()
        if lib.k1_read_stamps(buf) != 0:
            raise RuntimeError("k1_timeline: reading the stamps failed")
        stamps = np.frombuffer(buf, dtype=np.uint64).reshape(MAX_BLOCKS, SLOTS)
        key = f"{xshape}->{cout}"
        result[key] = {"max_abs_err_vs_plain": err, **readings(
            stamps, blocks, math.ceil(cin / 64), 2.0 * tile_m * bn * 9 * cin)}
        print(json.dumps({key: result[key]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
