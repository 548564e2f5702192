#!/usr/bin/env python3
"""Where one block of K4's fused kernel spends its time, on one NVIDIA GPU.

    python3 k4_timeline.py [--out FILE.json]

Builds a copy of ``mudiff_torch/csrc/int8_conv_kernel.cu`` with clock
stamps (``clock64``; ``globaltimer`` and the SM id at a block's start and
end) written at the kernel's hand-over points, into the git-ignored
``mudiff_torch/_build/timeline/``, and runs it at three sites of the
nf=64 sampler at batch 4 (the stem conv2 at 256^2, the 128-channel
convs at 256^2 and a 256-channel conv at 64^2), bf16, in both scale
modes.  Prints, per site and mode, the median over blocks (clocks) of:
the prologue up to the consumers' first chunk (the first patch's TMA,
then its quantize), the quantize of chunks 0 and 1, the consumers'
chunk-to-chunk intervals, the last chunk's product (no quantize beside
it) and the epilogue; the block's wall time and the gap between blocks
on one SM (ns).  The stamps cost a few global stores a block; the
library the port loads is not touched.  The hand-over points are found
by their source text: an edit there makes this script fail loudly.
Exits non-zero when CUDA is unavailable.
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
SITES = (((4, 256, 256, 256), 256), ((4, 256, 256, 128), 128), ((4, 64, 64, 256), 256))

# (source text, stamp inserted after it); slots: 0 block start, 1 first
# patch issued, 2 + 2c / 3 + 2c chunk c's patch landed / quantized (c < 4),
# 10 + c consumers start chunk c, 14 last product done, 15 block end;
# 17 / 18 globaltimer at start / end, 19 the SM id
STAMPS = (
    ("  __syncthreads();\n\n  if (threadIdx.x < 32) {\n",
     "  if (threadIdx.x == 0) { TR(0); TG(17); }\n"),
    ("      load_patch(0);\n", "      TR(1);\n"),
    ("      mbar_wait(&x_full[c & 1], (c >> 1) & 1);\n",
     "      if (qt == 0 && c < 4) TR(2 + 2 * c);\n"),
    ("      named_sync(2, QUANT_THREADS);  // every quantizer's codes are written\n",
     "      if (qt == 0 && c < 4) TR(3 + 2 * c);\n"),
    ("    mbar_wait(&s_full[c & 1], (c >> 1) & 1);\n", "    if (ctid == 0 && c < 4) TR(10 + c);\n"),
    ("  wgmma_wait<0>();\n#pragma unroll\n  for (int i = 0; i < NACC; ++i) fence_reg(acc[i]);\n",
     "  if (ctid == 0) TR(14);\n"),
    ("    default: store_tile<int>(acc, p, row_base, b, h0, w0, n0, col_scale, col_bias, xs);\n"
     "      break;\n  }\n", "  if (ctid == 0) { TR(15); TG(18); }\n"),
)

STAMP_DEFS = r'''
__device__ unsigned long long g_stamps[%(blocks)d * %(slots)d];
__device__ __forceinline__ void TR(int k) {
  if (blockIdx.x < %(blocks)d) {
    unsigned long long c;
    asm volatile("mov.u64 %%0, %%%%clock64;" : "=l"(c));
    g_stamps[blockIdx.x * %(slots)d + k] = c;
  }
}
__device__ __forceinline__ void TG(int k) {
  if (blockIdx.x < %(blocks)d) {
    unsigned long long t;
    unsigned s;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(s));
    g_stamps[blockIdx.x * %(slots)d + k] = t;
    g_stamps[blockIdx.x * %(slots)d + 19] = s;
  }
}
'''


def stamped_source(src: str) -> str:
    """The kernel source with the stamps and a reader of them."""
    defs = STAMP_DEFS % {"blocks": MAX_BLOCKS, "slots": SLOTS}
    src = src.replace("namespace s8wgmma {\n", "namespace s8wgmma {\n" + defs, 1)
    for anchor, stamp in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"k4_timeline: hand-over point not found once: {anchor!r}")
        src = src.replace(anchor, anchor + stamp)
    return src + ('\nextern "C" int k4_read_stamps(void* dst) {\n'
                  '  return (int)cudaMemcpyFromSymbol(dst, s8wgmma::g_stamps,\n'
                  '                                   sizeof(unsigned long long) * %d);\n}\n'
                  % (MAX_BLOCKS * SLOTS))


def build():
    from mudiff_torch.ops import _build

    out = _build.BUILD_DIR / "timeline"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "int8_conv_stamped.cu"
    cu.write_text(stamped_source((_build.CSRC / "int8_conv_kernel.cu").read_text()))
    lib = out / "libint8_conv_stamped.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"k4_timeline: nvcc failed\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def medians(stamps, blocks: int, chunks: int) -> dict:
    import numpy as np

    t = stamps[:blocks].astype(np.int64)

    def med(a, b):
        return float(np.median(t[:, b] - t[:, a]))

    shown = min(chunks, 4)
    gaps = []
    for sm in np.unique(t[:, 19]):
        mine = t[t[:, 19] == sm]
        order = np.argsort(mine[:, 17])
        gaps += list(mine[order, 17][1:] - mine[order, 18][:-1])
    return {
        "blocks": blocks, "chunks": chunks,
        "block_clk": med(0, 15),
        "prologue_clk": med(0, 10),
        "first_patch_tma_clk": med(1, 2),
        "quantize_clk": [med(2 + 2 * c, 3 + 2 * c) for c in range(min(chunks, 2))],
        "consumer_chunk_clk": [med(10 + c, 11 + c) for c in range(shown - 1)],
        "last_chunk_product_clk": med(10 + shown - 1, 14) if chunks <= 4 else None,
        "epilogue_clk": med(14, 15),
        "block_ns": float(np.median(t[:, 18] - t[:, 17])),
        "kernel_ns": float(t[:, 18].max() - t[:, 17].min()),
        "gap_between_blocks_on_an_sm_ns": float(np.median(gaps)) if gaps else None,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the readings here (JSON)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k4_timeline: no CUDA device", file=sys.stderr)
        return 2
    from mudiff_torch.ops import int8_conv as k4

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    from mudiff_torch.ops import _build

    src = (_build.CSRC / "int8_conv_kernel.cu").read_text()
    tile_w = int(re.search(r"constexpr int TILE_W = (\d+);", src).group(1))
    lib = build()
    fused = lib.mudiff_int8_conv3x3_fused
    fused.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
                      + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fused.restype = ctypes.c_int
    g = torch.Generator("cuda").manual_seed(0)
    readings = {"card": card}
    for xshape, cout in SITES:
        b, h, w, cin = xshape
        spread = torch.logspace(-1, 1, cin, device="cuda")
        x = (torch.randn(xshape, generator=g, device="cuda") * spread).to(torch.bfloat16)
        wt = torch.randn((3, 3, cin, cout), generator=g, device="cuda") / math.sqrt(9 * cin)
        absmax_c = tuple((x.float().abs().amax(dim=(0, 1, 2)) * 0.8).tolist())
        tw = min(w, tile_w)
        blocks = b * math.ceil(h / (128 // tw)) * math.ceil(w / tw) * math.ceil(cout / 128)
        if blocks > MAX_BLOCKS:
            raise RuntimeError(f"k4_timeline: {blocks} blocks exceed {MAX_BLOCKS}")
        for mode in ("dynamic", "static"):
            qw = k4.quantize_conv_weight(wt, absmax_c if mode == "static" else None)
            out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device="cuda")
            absmax = torch.empty((b,), device="cuda")
            parts = torch.empty((b, k4.ABSMAX_PARTS), device="cuda")
            for _ in range(3):  # the last run's stamps are read
                rc = fused(x.data_ptr(), k4.DTYPE_CODES[x.dtype], qw.wq_nk.data_ptr(),
                           None if qw.inv_a is None else qw.inv_a.data_ptr(),
                           absmax.data_ptr(), parts.data_ptr(), qw.w_scale.data_ptr(), None,
                           out.data_ptr(), k4.OUT_CODES[torch.bfloat16], b, h, w, cin, cout,
                           torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"k4_timeline: launch failed with {rc}")
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (MAX_BLOCKS * SLOTS))()
            if lib.k4_read_stamps(buf) != 0:
                raise RuntimeError("k4_timeline: reading the stamps failed")
            stamps = np.frombuffer(buf, dtype=np.uint64).reshape(MAX_BLOCKS, SLOTS)
            key = f"{xshape}->{cout} {mode}"
            readings[key] = medians(stamps, blocks, math.ceil(cin / 64))
            print(json.dumps({key: readings[key]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(readings, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
