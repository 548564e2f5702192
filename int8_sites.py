#!/usr/bin/env python3
"""Where W8A8 loses against bf16 on a trained checkpoint, site by site.
Needs one NVIDIA GPU.

    python3 int8_sites.py -c experiments/phantom_flagship.yaml -e flagship64 \\
        [--out FILE.json] [--capture SITE]

The checkpoint is ``<output_root>/<exp>/<target>`` of the YAML (the
run's, as ``phantom_quality.py`` leaves it), with its
``int8_calib_g{1,2}.json`` sidecars.  The test split is sampled as
``ab_int8_quality`` samples it (``sample_and_test``, einsum attention)
with the generators serving W8A8 dynamic scales, twice over:

- **teacher-forced**: every routed conv returns the bf16 conv of its
  input, so each site sees the bf16 trajectory; beside it the site's
  dynamic-scale and static-scale (the sidecar's) int8 outputs are read
  on the same input: their relative error from the bf16 output, the
  input's channel-absmax spread (max / median over the batch) and the
  share of (example, channel) pairs whose absmax lies under 8 levels of
  the example's dynamic scale; the sites sorted by dynamic error.  The
  sites seen must be the sidecars' sites, in their order and shapes;
- **free-running**: the dynamic-scale test with the worst 0, 1 and 3
  sites (by that error) served in bf16: PSNR / SSIM / MAE.

A site is ``g1#i`` / ``g2#i``, the i-th routed conv of a generator's
forward (the sidecar's order), with the module that holds its weight
cache.  ``--capture SITE`` also saves, beside ``--out``, the input of
that site's example with the largest dynamic-scale error (in the call
with the largest), its weight and bias and the errors read here, as
``int8_site_<g2_0>.pt``: ``tests/test_torch_port_int8_witness.py``
reruns the JAX package's dynamic conv on it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def int8_sites(config_path: str, experiment: str, out_dir=".", device=None, worst=(0, 1, 3),
               capture=None) -> dict:
    """The per-site readings and the free-running legs (see the module
    docstring); the legs' PNGs go under ``out_dir``, and the input of
    site ``capture`` (``--capture``) into ``out_dir``'s parent."""
    import numpy as np
    import torch

    import mudiff_torch.nn.fused_stems as fused_stems
    import mudiff_torch.nn.layers as layers
    from mudiff_torch import config
    from mudiff_torch.infer import load_generators, sample_and_test
    from mudiff_torch.infer.calibrate import calib_sidecar_paths, load_calib
    from mudiff_torch.metrics import evaluate_pair_dirs
    from mudiff_torch.ops import int8_conv
    from mudiff_torch.ops.conv3x3 import conv3x3

    doc, exp = config.load_experiment(config_path, experiment)
    target = exp.get("target", "T1CE")
    ckpt_dir = os.path.join(doc["output_root"], experiment, target)
    cfg = config._config_from_yaml(dict(exp["test_args"], use_int8=True, int8_static=False),
                                   doc.get("data_path", "/data/BRATS"), doc["output_root"],
                                   experiment, target)
    g1, g2 = load_generators(cfg, ckpt_dir, device=device, attn="einsum")
    calibs = dict(zip(("g1", "g2"), (load_calib(p) for p in calib_sidecar_paths(ckpt_dir))))
    names, at = {}, {"gen": None, "idx": 0}
    hooks = []
    for tag, g in (("g1", g1), ("g2", g2)):
        for n, m in g.named_modules():
            for a, v in vars(m).items():
                for k, c in (v.items() if isinstance(v, dict) else [("", v)]):
                    if isinstance(c, int8_conv.Int8WeightCache):
                        names[id(c)] = f"{tag}.{n}.{a}{'[' + k + ']' if k else ''}"
        hooks.append(g.register_forward_pre_hook(
            lambda mod, inp, tag=tag: at.update(gen=tag, idx=0)))
    real = int8_conv.routed_conv
    mode = {"teacher": True, "skip": set()}
    stats, held = {}, {}

    def routed(x, cout, make_weight, sources, bias, dtype, cache):
        tag, idx = at["gen"], at["idx"]
        at["idx"] += 1
        key = f"{tag}#{idx}"
        w = make_weight()
        y16 = conv3x3(x.to(dtype).contiguous(), w.to(dtype).contiguous(), bias)
        if mode["teacher"]:
            y8 = real(x, cout, make_weight, sources, bias, dtype, cache)
            _, _, absmax_c = calibs[tag].sites[idx]
            y8s = int8_conv.int8_conv3x3(x, None, bias, absmax_c=absmax_c, compute_dtype=dtype,
                                         qweight=int8_conv.quantize_conv_weight(w, absmax_c))
            den = float(y16.float().norm())
            xa = x.float().abs()
            per_ex = xa.amax(dim=(1, 2, 3))
            per_ch = xa.amax(dim=(0, 1, 2))
            coarse = (xa.amax(dim=(1, 2)) < 8 * per_ex[:, None] / 127).float().mean()
            rec = stats.setdefault(key, {"name": names.get(id(cache), "?"), "cin": x.shape[-1],
                                         "cout": cout, "dyn": [], "static": [], "ratio": [],
                                         "coarse": [], "argmax_ch": []})
            rec["dyn"].append(float((y8.float() - y16.float()).norm()) / den)
            rec["static"].append(float((y8s.float() - y16.float()).norm()) / den)
            rec["ratio"].append(float(per_ch.max() / per_ch.median().clamp_min(1e-12)))
            rec["coarse"].append(float(coarse))
            rec["argmax_ch"].append(int(per_ch.argmax()))
            if key == capture and rec["dyn"][-1] >= max(rec["dyn"]):
                per_ex_err = ((y8.float() - y16.float()).flatten(1).norm(dim=1)
                              / y16.float().flatten(1).norm(dim=1))
                b = int(per_ex_err.argmax())
                held.update(x=x[b:b + 1].detach().cpu().clone(), w=w.detach().float().cpu(),
                            bias=None if bias is None else bias.detach().float().cpu(),
                            dtype=str(dtype), call=len(rec["dyn"]) - 1, example=b,
                            dyn_call=rec["dyn"][-1], dyn_example=float(per_ex_err[b]))
            return y16
        if key in mode["skip"]:
            return y16
        return real(x, cout, make_weight, sources, bias, dtype, cache)

    def test(tag):
        t = time.perf_counter()
        out = sample_and_test(cfg, ckpt_dir=ckpt_dir, output_dir=os.path.join(out_dir, tag),
                              generators=(g1, g2), device=device, attn="einsum")
        m = evaluate_pair_dirs(out["pred_dir"], out["gt_dir"])
        return {k: m[k] for k in ("psnr", "ssim", "mae")} | {"s": time.perf_counter() - t}

    layers.routed_conv = fused_stems.routed_conv = routed
    try:
        test("teacher")
        for tag, calib in calibs.items():
            seen = [(stats[f"{tag}#{i}"]["cin"], stats[f"{tag}#{i}"]["cout"])
                    if f"{tag}#{i}" in stats else None for i in range(len(calib.sites))]
            extra = [k for k in stats if k.startswith(f"{tag}#")
                     and int(k.split("#")[1]) >= len(calib.sites)]
            if seen != [(ci, co) for ci, co, _ in calib.sites] or extra:
                raise AssertionError(f"{tag}: the routed convs seen {seen} + {extra} are not "
                                     "the sidecar's sites; a module calls the routed conv "
                                     "by another name")
        sites = sorted(({"site": key, "name": r["name"], "cin": r["cin"], "cout": r["cout"],
                         "calls": len(r["dyn"]),
                         **{k: float(np.mean(r[k])) for k in ("dyn", "static", "ratio",
                                                              "coarse")},
                         "dyn_max": float(np.max(r["dyn"])),
                         "argmax_ch": int(np.bincount(r["argmax_ch"]).argmax())}
                        for key, r in stats.items()), key=lambda s: -s["dyn"])
        mode["teacher"] = False
        free = {}
        for k in worst:
            mode["skip"] = {s["site"] for s in sites[:k]}
            free[f"dynamic, worst {k} in bf16"] = test(f"skip{k}") | {
                "kept_bf16": sorted(mode["skip"])}
    finally:
        layers.routed_conv = fused_stems.routed_conv = real
        for h in hooks:
            h.remove()
    out = {"experiment": experiment, "ckpt_dir": ckpt_dir, "teacher_forced": sites,
           "free_running": free}
    if capture is not None:
        path = os.path.join(os.path.dirname(os.path.abspath(out_dir)),
                            f"int8_site_{capture.replace('#', '_')}.pt")
        torch.save({"site": capture, **held,
                    "dyn_mean": next(s["dyn"] for s in sites if s["site"] == capture)}, path)
        out["captured"] = path
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", default="experiments/phantom_flagship.yaml")
    ap.add_argument("-e", "--experiment", default="flagship64")
    ap.add_argument("--out", default=None, help="also write the readings here")
    ap.add_argument("--capture", default=None, help="a site (g2#0) whose input to save")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("int8_sites: no CUDA device", file=sys.stderr)
        return 2
    out_dir = os.path.dirname(os.path.abspath(args.out)) if args.out else "."
    result = int8_sites(args.config, args.experiment, os.path.join(out_dir, "int8_sites"),
                        "cuda", capture=args.capture)
    for s in result["teacher_forced"][:8]:
        print(json.dumps(s))
    print(json.dumps(result["free_running"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
