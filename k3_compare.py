#!/usr/bin/env python3
"""K3 (the mid-block flash attention, forward and backward) by path on one
NVIDIA GPU: the wgmma kernels beside the general path's mma.sync kernels,
SDPA and the plain versions.

    python3 k3_compare.py check [--out FILE.json]
    python3 k3_compare.py shapes [--out FILE.json]

``check`` builds K3's two libraries, prints the ``ptxas -v`` lines of
their wgmma kernels and, from their SASS, the highest register each names
and its local-memory (spill) instructions, then runs each wgmma kernel once per case in a child
process of its own (a time limit each, so that a kernel that never ends
is reported and the next case still runs): the forward at (2, 4096, 256),
(8, 4096, 256) and the ragged (2, 1000, 256) in bf16 and fp16, with 64-
and 128-query blocks; the backward's dkv and dq at (2, 4096, 256) and
(2, 1000, 256), each run twice.  Each case prints its largest error
against the plain version beside ``chip_smoke.FLASH_TOL`` /
``FLASH_BWD_TOL``, where the worst element lies, and whether the block
sizes and the reruns gave the same bits.

``shapes`` runs ``chip_smoke.flash_rows`` and ``flash_bwd_rows`` at K3's
shapes on the smoke's paths (forward: the volume's (8, 4096, 256), the
training batch's (2, 4096, 256), the nf=128 (4, 4096, 512) and the ragged
(2, 1000, 256); backward: (2, 4096, 256), (2, 4096, 512), (2, 1000,
256)): each checked in bf16, fp16 and fp32 and timed (CUDA events behind
a device spin) beside the mma.sync kernels through their entry points
and SDPA, in the same call, with the bound.  Exits non-zero when CUDA is
unavailable or a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

FWD_CASES = [((2, 4096, 256), "bf16"), ((2, 4096, 256), "fp16"), ((8, 4096, 256), "bf16"),
             ((2, 1000, 256), "bf16"), ((2, 1000, 256), "fp16")]
BWD_CASES = [((2, 4096, 256), "bf16"), ((2, 4096, 256), "fp16"), ((2, 1000, 256), "bf16")]
CASE_TIMEOUT = 180
FWD_SHAPES = ((8, 4096, 256), (2, 4096, 256), (4, 4096, 512), (2, 1000, 256))
BWD_SHAPES = ((2, 4096, 256), (2, 4096, 512), (2, 1000, 256))


def worst(got, want) -> dict:
    """Largest |got - want|, where it lies, and the share of non-finite
    outputs."""
    import torch

    err = (got.float() - want.float()).abs()
    idx = int(torch.nan_to_num(err, nan=float("inf")).argmax())
    where = []
    for n in reversed(got.shape):
        where.append(idx % n)
        idx //= n
    return {"max_abs_err": float(torch.nan_to_num(err, nan=float("inf")).max()),
            "at": where[::-1], "nonfinite": float((~torch.isfinite(got)).float().mean())}


def run_case(kind: str, shape, tag: str) -> dict:
    """One wgmma case on the card (in a child process)."""
    import torch

    import chip_smoke as cs
    from mudiff_torch.ops import attn_di, flash_attn_plain, plain_kernels, row_stats_plain
    from mudiff_torch.ops import flash_attn_bwd_dkv, flash_attn_bwd_dq
    from mudiff_torch.ops.flash_attn import flash_attn_bwd_path, flash_attn_path

    dt = {"bf16": torch.bfloat16, "fp16": torch.float16}[tag]
    b, length, c = shape
    g = torch.Generator("cuda").manual_seed(cs.SEED + 3)
    scale = float(c) ** -0.5
    q = (2.0 * torch.randn(shape, generator=g, device="cuda")).to(dt)
    k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dt) for _ in range(3))
    out = {"kind": kind, "shape": list(shape), "dtype": tag}
    if kind == "forward":
        want = flash_attn_plain(q, k, v, scale)
        got = {bq: flash_attn_path(q, k, v, scale, "wgmma", bq) for bq in (64, 128)}
        torch.cuda.synchronize()
        out.update(worst(got[64], want))
        out["blocks_same_bits"] = bool(torch.equal(got[64], got[128]))
        general = flash_attn_path(q, k, v, scale, "general")
        out["general_max_abs_err"] = worst(general, want)["max_abs_err"]
        atol, rtol = cs.FLASH_TOL["bf16"]
        limit = atol + rtol * want.float().abs()
        out["ok"] = bool(torch.isfinite(got[64]).all()) and bool(
            ((got[64].float() - want.float()).abs() <= limit).all()) and out["blocks_same_bits"]
        return out
    stats = row_stats_plain(q, k, scale)
    di = attn_di(flash_attn_plain(q, k, v, scale), do)
    with plain_kernels():
        pk, pv = flash_attn_bwd_dkv(q, k, v, do, stats, di, scale)
        pq = flash_attn_bwd_dq(q, k, v, do, stats, di, scale)
    runs = []
    for _ in range(2):
        dk, dv = flash_attn_bwd_path("flash_attn_bwd_dkv", q, k, v, do, stats, di, scale,
                                     "wgmma")
        dq = flash_attn_bwd_path("flash_attn_bwd_dq", q, k, v, do, stats, di, scale, "wgmma")
        runs.append((dk, dv, dq))
    torch.cuda.synchronize()
    out["reruns_same_bits"] = all(torch.equal(a, b) for a, b in zip(*runs))
    ok = out["reruns_same_bits"]
    for name, got, want in zip(("dk", "dv", "dq"), runs[0], (pk, pv, pq)):
        w = worst(got, want)
        w["rel"] = w["max_abs_err"] / float(want.float().abs().max())
        out[name] = w
        ok = ok and w["nonfinite"] == 0 and w["rel"] <= cs.FLASH_BWD_TOL["bf16"]
    out["ok"] = ok
    return out


def ptxas_lines(logs: dict) -> list:
    """nvcc's -v lines about the wgmma kernels and any spill."""
    keep = []
    for name, log in logs.items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "wgmma" in line and "Compiling entry" in line:
                keep.append(f"[{name}] {line.strip()}")
                keep.extend(f"[{name}] {x.strip()}" for x in lines[i + 1:i + 4])
            elif "spill" in line.lower() and "0 bytes spill" not in line:
                keep.append(f"[{name}] {line.strip()}")
    return keep


def sass_summary(names=("flash_attn", "flash_attn_bwd")) -> list:
    """Per wgmma kernel of K3's libraries: the highest register its SASS
    names and its local-memory (spill) instructions (cuobjdump -sass)."""
    import re

    from mudiff_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = []
    for name in names:
        sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        fn = None
        for line in sass.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                fn = found.group(1) if "wgmma" in found.group(1) else None
                if fn:
                    out.append({"kernel": fn, "max_register": 0, "local_memory_instructions": 0})
                continue
            if fn:
                regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
                out[-1]["max_register"] = max([out[-1]["max_register"], *regs])
                out[-1]["local_memory_instructions"] += ("STL" in line) or ("LDL" in line)
    return out


def check(args) -> int:
    from mudiff_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build(["flash_attn", "flash_attn_bwd"])
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    for line in ptxas_lines({k: v["log"] for k, v in built.items()}):
        print(line, flush=True)
    for entry in sass_summary():
        print(json.dumps(entry), flush=True)
    results, failed = [], 0
    for kind, cases in (("forward", FWD_CASES), ("backward", BWD_CASES)):
        for shape, tag in cases:
            arg = json.dumps({"kind": kind, "shape": shape, "dtype": tag})
            try:
                proc = subprocess.run([sys.executable, __file__, "case", arg], cwd=HERE,
                                      capture_output=True, text=True, timeout=CASE_TIMEOUT)
                lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
                res = json.loads(lines[-1]) if proc.returncode == 0 and lines else {
                    "kind": kind, "shape": shape, "dtype": tag, "ok": False,
                    "rc": proc.returncode, "stderr": proc.stderr[-1500:]}
            except subprocess.TimeoutExpired:
                res = {"kind": kind, "shape": shape, "dtype": tag, "ok": False,
                       "timeout_s": CASE_TIMEOUT}
            print(json.dumps(res), flush=True)
            results.append(res)
            failed += not res["ok"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results}, f, indent=1)
    print(json.dumps({"cases": len(results), "failed": failed}), flush=True)
    return 1 if failed else 0


def shapes(args) -> int:
    import torch

    import chip_smoke as cs
    from mudiff_torch.ops import _build

    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    built = _build.build(["flash_attn", "flash_attn_bwd"])
    for line in ptxas_lines({k: v["log"] for k, v in built.items()}):
        print(line, flush=True)
    _, peaks = cs.peaks_for(torch.cuda.get_device_name(0))
    none = dict.fromkeys(cs.PATHS, 0)
    fwd = cs.flash_rows({(*s, torch.bfloat16): dict(none) for s in FWD_SHAPES}, peaks, card)
    names = ("flash_attn_bwd_dkv", "flash_attn_bwd_dq")
    bwd = cs.flash_bwd_rows({(*s, torch.bfloat16): {n: dict(none) for n in names}
                             for s in BWD_SHAPES}, peaks, card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": fwd + bwd}, f, indent=1)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["case"]:
        spec = json.loads(argv[1])
        print(json.dumps(run_case(spec["kind"], tuple(spec["shape"]), spec["dtype"])),
              flush=True)
        return 0
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("check", "shapes"))
    parser.add_argument("--out", help="write the results here as JSON")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k3_compare: no CUDA device", file=sys.stderr)
        return 2
    return check(args) if args.mode == "check" else shapes(args)


if __name__ == "__main__":
    sys.exit(main())
