#!/usr/bin/env python3
"""Where K3's wgmma kernels spend a step, on one NVIDIA GPU.

    python3 k3_timeline.py [--out FILE.json]

Builds copies of ``mudiff_torch/csrc/flash_attn_kernel.cu`` and
``flash_attn_bwd_kernel.cu`` with clock counters (``clock64``; the
``globaltimer`` and the SM id at the consumers' loop start and end) at
the wgmma kernels' hand-over points, into the git-ignored
``mudiff_torch/_build/timeline/``, and runs them in bf16: the forward at
the volume's (8, 4096, 256) (128-query blocks) and the training batch's
(2, 4096, 256) (64-query blocks), the backward's dkv and dq at (2, 4096,
256).  Thread 0 of each consumer warpgroup adds up, over the steps of its
loop (a key tile of the forward and of dq, a query step of dkv), the
clocks it spent waiting for a slot's TMA bytes (``full_wait``), in the
score products (``scores``: issue to wait, S / S^T / dP^T, in dq S
alone), in the elementwise work between them and the next product
(``elementwise``: the softmax, P^T, dS; in dkv it holds the P^T handover
``handover_wait``; in dq the wait for dP ``dp_wait``), in the m64n256
product (``product``: P V, dV, dK, dQ) and in refilling the ring
(``refill``: the forward's and dkv's loads issued by the consumers).
Prints the median over blocks of each per step, the loop's clocks a step,
the SM clock (loop clocks over loop ns) and the steps' tensor rate against
an SM's peak.  The counters cost a few registers and clock reads a step;
the library the port loads is not touched.  The hand-over points are
found by their source text: an edit there makes this script fail loudly.
Exits non-zero when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

SLOTS = 12
MAX_BLOCKS = 1024
SM_FLOPS_PER_CLK = 4096  # dense bf16 flops an SM a clock at the data sheet's 1830 MHz
NAMES = ("loop", "full_wait", "scores", "elementwise", "product", "refill", "handover_wait",
         "dp_wait_or_to_a")

DEFS = r'''
__device__ unsigned long long g_k3[%(blocks)d * 2 * %(slots)d];
__device__ __forceinline__ unsigned long long k3_now() {
  unsigned long long c;
  asm volatile("mov.u64 %%0, %%%%clock64;" : "=l"(c));
  return c;
}
__device__ __forceinline__ void k3_put(int wg, int k, unsigned long long v) {
  const unsigned blk = blockIdx.y * gridDim.x + blockIdx.x;
  if (blk < %(blocks)d) g_k3[(blk * 2 + wg) * %(slots)d + k] = v;
}
__device__ __forceinline__ void k3_stamp(int wg, int k) {
  unsigned long long t;
  unsigned s;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(s));
  k3_put(wg, k, t);
  k3_put(wg, 11, s);
}
'''

OPEN = "unsigned long long k3a[8] = {}; unsigned long long k3_t = k3_now();\n"
ACC = "k3a[%d] += k3_now() - k3_t; k3_t = k3_now();\n"


def close(wg: str) -> str:
    return ("if (t == 0) { k3a[0] = k3_now() - k3a[0];"
            f" for (int k = 0; k < 8; ++k) k3_put({wg}, k, k3a[k]); k3_stamp({wg}, 9); }}\n")


START = "if (t == 0) k3_stamp(%s, 8); k3a[0] = k3_now();\n"
# a refill's own clocks (slot 5), inside the window that holds it
REFILL_IN = "{ unsigned long long k3_r = k3_now();\n"
REFILL_OUT = "k3a[5] += k3_now() - k3_r; }\n"

# {kernel function: [(anchor, text before it, text after it)]}, each
# anchor found once in that function's body
POINTS = {
    "flash_attn_kernel_wgmma": [
        ("  wait_phase(q_full, 0);\n", "", OPEN + START % "wg"),
        ("    wait_phase(&full[n % STAGES], (n / STAGES) & 1);\n", "k3_t = k3_now();\n", ACC % 1),
        ("    for (int i = 0; i < 32; ++i) tc::fence_reg(sc[i]);\n    leave(n);\n",
         "", ACC % 5),
        ("    leave(n);\n", ACC % 2, ""),
        ("    wait_phase(&full[(n + 1) % STAGES], ((n + 1) / STAGES) & 1);\n", ACC % 3, ACC % 1),
        ("    leave(n + 1);\n", ACC % 4, ACC % 5),
        ("  // row sums across the quad; one division, one rounding\n", close("wg"), ""),
    ],
    "flash_attn_bwd_dkv_kernel_wgmma": [
        ("  wait_phase(kv_full, 0);\n", "", OPEN + START % "wg"),
        ("    wait_phase(&full[s], phase);\n    const uint32_t q_tile", "k3_t = k3_now();\n",
         ""),
        ("    const uint32_t q_tile = ring0 + s * DKV_STAGE_BYTES;\n", ACC % 1, ""),
        ("\n    if (wg == 0) {\n", ACC % 2, ""),
        ("      if (i > 0) tc::named_sync(P_EMPTY, 2 * WG_THREADS);\n",
         "{ unsigned long long k3_s = k3_now();\n", "k3a[6] += k3_now() - k3_s; }\n"),
        ("      tc::named_sync(P_FULL, 2 * WG_THREADS);\n",
         "{ unsigned long long k3_s = k3_now();\n", "k3a[6] += k3_now() - k3_s; }\n"),
        ("    to_a<T>(a, sc);\n", ACC % 3, ACC % 7),
        ("    const uint32_t bt = wg == 0 ? do_tile : q_tile;\n", ACC % 3, ""),
        ("    if (wg == 1 && t < STAT_THREADS) {\n", REFILL_IN, ""),
        ("    tc::wgmma_wait<0>();\n#pragma unroll\n    for (int x = 0; x < 32; ++x) "
         "tc::fence_reg(sc[x]);\n", REFILL_OUT, ""),
        ("    if (lane == 0) mbar_arrive(&empty[s]);\n", "", ACC % 4),
        ("  T* out = static_cast<T*>(wg == 0 ? p.d1 : p.d0) + sbase * HEAD_DIM;\n",
         close("wg"), ""),
    ],
    "flash_attn_bwd_dq_kernel_wgmma": [
        ("  wait_phase(q_full, 0);\n", "", OPEN + START % "0"),
        ("    wait_phase(&full[s], phase);\n", "k3_t = k3_now();\n", ACC % 1),
        ("    for (int x = 0; x < 32; ++x) tc::fence_reg(sc[x]);\n", "", ACC % 2),
        ("    tc::wgmma_wait<0>();\n#pragma unroll\n    for (int x = 0; x < 32; ++x) "
         "tc::fence_reg(dp[x]);\n", ACC % 3, ACC % 7),
        ("    // dQ += round(dS) K\n", ACC % 3, ""),
        ("    if (lane == 0) mbar_arrive(&empty[s]);\n    if (++s == DQ_STAGES)", ACC % 4, ""),
        ("  store_acc<T>(static_cast<T*>(p.d0) + sbase * HEAD_DIM, acc, q0, p.L, t);\n",
         close("0"), ""),
    ],
}
# (name, library, kernel function, shape, block_q, m64n64 + m64n256 products a step)
RUNS = (("forward (8, 4096, 256), 128-query blocks", "flash_attn", "flash_attn_kernel_wgmma",
         (8, 4096, 256), 128, 2),
        ("forward (2, 4096, 256), 64-query blocks", "flash_attn", "flash_attn_kernel_wgmma",
         (2, 4096, 256), 64, 2),
        ("dkv (2, 4096, 256)", "flash_attn_bwd", "flash_attn_bwd_dkv_kernel_wgmma",
         (2, 4096, 256), 0, 2),
        ("dq (2, 4096, 256)", "flash_attn_bwd", "flash_attn_bwd_dq_kernel_wgmma",
         (2, 4096, 256), 0, 3))


def function_span(src: str, fn: str):
    """[start, end) of the body of the kernel function ``fn``."""
    head = src.index(f"{fn}(const __grid_constant__")
    start = src.index("{\n", head)
    end = src.index("\n}\n", start) + 1
    return start, end


def stamped_source(src: str) -> str:
    src = src.replace("namespace wgmma {\n", "namespace wgmma {\n" + DEFS % {
        "blocks": MAX_BLOCKS, "slots": SLOTS}, 1)
    for fn, points in POINTS.items():
        if fn not in src:
            continue
        start, end = function_span(src, fn)
        body = src[start:end]
        for anchor, before, after in points:
            if body.count(anchor) != 1:
                raise RuntimeError(f"k3_timeline: hand-over point not found once in {fn}: "
                                   f"{anchor!r}")
            body = body.replace(anchor, before + anchor + after)
        src = src[:start] + body + src[end:]
    return src + ('\nextern "C" int k3_read_stamps(void* dst) {\n'
                  '  return (int)cudaMemcpyFromSymbol(dst, wgmma::g_k3,\n'
                  '                                   sizeof(unsigned long long) * %d);\n}\n'
                  % (MAX_BLOCKS * 2 * SLOTS))


def build(name: str):
    from mudiff_torch.ops import _build

    out = _build.BUILD_DIR / "timeline"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{name}_stamped.cu"
    cu.write_text(stamped_source((_build.CSRC / _build.SOURCES[name]).read_text()))
    lib = out / f"lib{name}_stamped.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"k3_timeline: nvcc failed\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def readings(stamps, blocks: int, wgs: int, steps: int, step_flops: float) -> dict:
    import numpy as np

    out = {}
    for wg in range(wgs):
        t = stamps[:blocks, wg].astype(np.int64)
        per = {name: float(np.median(t[:, k])) / steps for k, name in enumerate(NAMES)}
        per["sm_ghz"] = float(np.median(t[:, 0] / np.maximum(t[:, 9] - t[:, 8], 1)))
        out[f"wg{wg}_clk_a_step"] = per
    loop = out["wg0_clk_a_step"]["loop"]
    out["steps"] = steps
    out["step_share_of_sm_peak"] = step_flops / loop / SM_FLOPS_PER_CLK
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the readings here (JSON)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k3_timeline: no CUDA device", file=sys.stderr)
        return 2
    from mudiff_torch.ops import attn_di, flash_attn_plain, row_stats_plain

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = {name: build(name) for name in ("flash_attn", "flash_attn_bwd")}
    g = torch.Generator("cuda").manual_seed(0)
    result = {"card": card}
    for name, lib_name, fn_name, shape, block_q, products in RUNS:
        b, length, c = shape
        scale = c ** -0.5
        q = (2.0 * torch.randn(shape, generator=g, device="cuda")).to(torch.bfloat16)
        k, v, do = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                    for _ in range(3))
        lib = libs[lib_name]
        stream = torch.cuda.current_stream().cuda_stream
        if lib_name == "flash_attn":
            fn = lib.mudiff_flash_attn_wgmma
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            out = torch.empty_like(q)
            call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                              None, b, length, c, scale, 1, block_q, stream)
            rows, wgs, steps = block_q, block_q // 64, length // 64
        else:
            stats = row_stats_plain(q, k, scale)
            di = attn_di(flash_attn_plain(q, k, v, scale), do)
            dkv = "dkv" in fn_name
            fn = getattr(lib, "mudiff_flash_attn_bwd_dkv_wgmma" if dkv
                         else "mudiff_flash_attn_bwd_dq_wgmma")
            fn.argtypes = [ctypes.c_void_p] * (9 if dkv else 8) + [ctypes.c_int] * 3 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            outs = [torch.empty_like(q) for _ in range(2 if dkv else 1)]
            call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                              stats[0].data_ptr(), stats[1].data_ptr(), di.data_ptr(),
                              *(o.data_ptr() for o in outs), b, length, c, scale, 1, stream)
            rows, wgs, steps = 64, 2 if dkv else 1, length // 64
        fn.restype = ctypes.c_int
        blocks = b * (length // rows)
        if blocks > MAX_BLOCKS:
            raise RuntimeError(f"k3_timeline: {blocks} blocks exceed {MAX_BLOCKS}")
        for _ in range(3):  # the last run's counters are read
            if call() != 0:
                raise RuntimeError(f"k3_timeline: {name} launch failed")
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (MAX_BLOCKS * 2 * SLOTS))()
        if lib.k3_read_stamps(buf) != 0:
            raise RuntimeError("k3_timeline: reading the counters failed")
        stamps = np.frombuffer(buf, dtype=np.uint64).reshape(MAX_BLOCKS, 2, SLOTS)
        # a step's products over the block's warpgroups: 64 x 64 x 256 each
        step_flops = 2.0 * 64 * 64 * c * products * (wgs if lib_name == "flash_attn" else 1)
        if "dkv" in fn_name:
            step_flops = 2.0 * 64 * 64 * c * 4
        result[name] = {"blocks": blocks, **readings(stamps, blocks, wgs, steps, step_flops)}
        print(json.dumps({name: result[name]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
