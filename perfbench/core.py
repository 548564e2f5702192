"""The benchmark's frame: find a cell's files by name, check the card,
run the cell's driver, read the per-layer metrics, decide ``correct`` and
print the result.

Everything that belongs to one cell is data found by name:

* ``BENCHMARK.json`` (the checkout's root): the cell's configuration,
  traffic and chips, and which metrics it reports;
* ``perfbench/configs/<config>.json``: the recipe's sizes;
* ``perfbench/traffic/<traffic>.json``: the mix, with ``driver`` naming a
  module of ``perfbench/drivers/`` and its parameters;
* ``perfbench/workloads/<cell>.json``: the limits of the numbers that
  decide ``correct``;
* ``perfbench/metrics/<metric>.py``: one reader a per-layer metric;
* ``perfbench/kernels/<family>.json``: kernel-name patterns a family.

The result is one JSON line, the last of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end ones, or with
``--trace 1`` the per-layer ones), ``device``, with ``--trace 1``
``breakdown``, then ``readings`` (numbers compared without a limit) and
last ``checks`` (each compared number beside its limit), which also
close standard error.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "mudiff_tpu")
RUN_ID_ENV = "PERFBENCH_RANK_CHILD"


class Ctx:
    """What a driver gets: the cell's data, the run's arguments, the
    device, and the clock's zero (process start)."""

    def __init__(self, root: Path, cell: dict, config: dict, traffic: dict, limits: dict,
                 seed: int, seconds: float, trace: bool, device: str, t0: float):
        self.root, self.cell, self.config, self.traffic = root, cell, config, traffic
        self.limits = limits
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t0 = device, t0


class Outcome:
    """What a driver returns."""

    def __init__(self):
        self.attempted = 0
        self.failed = 0
        self.metrics: Dict[str, float] = {}
        self.memory_peak_bytes = 0
        self.trace = None           # perfbench.trace.TraceView, --trace 1 only
        self.readings: Dict[str, float] = {}   # every number the check computed
        self.phases: Dict[str, float] = {}     # host seconds of set-up's parts and the check


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, name: str):
    manifest = load_json(root / "BENCHMARK.json")
    cells = [w for w in manifest["workloads"] if w["name"] == name]
    if not cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[0]
    conf = [c for c in manifest["configs"] if c["name"] == cell["config"]][0]
    bench = root / "perfbench"
    config = load_json(root / conf["file"])
    traffic = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(bench / "workloads" / f"{name}.json")
    return manifest, cell, config, traffic, limits


def metrics_for(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or (``trace``) its per-layer ones."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def set_cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed places inside the checkout."""
    cache = root / ".perfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(root: Path, argv: List[str], chips: int) -> int:
    """Re-run this command as ``chips`` ranks under torchrun; rank 0's
    output is the result."""
    env = dict(os.environ, **{RUN_ID_ENV: "1"})
    cmd = [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={chips}",
           "--master_addr=localhost", f"--master_port={_free_port()}",
           str(root / "perfbench" / "run.py"), *argv]
    return subprocess.run(cmd, env=env, cwd=root).returncode


def decide(limits: dict, readings: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} of every number the cell's limits name;
    a reading that is missing or not finite reads as infinity."""
    checks = {}
    for name, limit in limits.get("limits", {}).items():
        v = readings.get(name)
        v = math.inf if v is None or not math.isfinite(v) else v
        checks[name] = {"value": v, "limit": limit}
    return checks


def main(argv: List[str], root: str, t0: float) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(root)
    manifest, cell, config, traffic, limits = find_cell(root, args.workload)
    set_cache_dirs(root)

    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if chips > 1 and os.environ.get(RUN_ID_ENV) != "1":
        return launch_ranks(root, argv, chips)
    ctx = Ctx(root, cell, config, traffic, limits, args.seed, args.seconds, bool(args.trace),
              "cuda", t0)
    return report(ctx, manifest, torch.cuda.get_device_name(0), chips)


def run_driver(ctx: Ctx) -> Outcome:
    import importlib

    driver = importlib.import_module(f"perfbench.drivers.{ctx.traffic['driver']}")
    return driver.run(ctx)


def report(ctx: Ctx, manifest: dict, kind: str, chips: int,
           out=sys.stdout, err=sys.stderr) -> int:
    """Run the cell, print the result line; the exit code."""
    outcome = run_driver(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}; the benchmark measures the port alone",
              file=err)
        return 3
    cell = ctx.cell["name"]
    wanted = metrics_for(manifest, cell, ctx.trace)
    metrics = {}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    result = {}
    if ctx.trace:
        from perfbench.trace import read_metric

        tv = outcome.trace
        for m in wanted:
            v = read_metric(ctx.root, m["name"], tv)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = tv.busy_s
        device["window_s"] = tv.window_s
        result["breakdown"] = tv.breakdown()
    else:
        for m in wanted:
            if m["name"] in outcome.metrics:
                metrics[m["name"]] = {"value": outcome.metrics[m["name"]], "unit": m["unit"]}
    checks = decide(ctx.limits, outcome.readings)
    correct = (outcome.attempted > 0 and outcome.failed == 0 and bool(checks)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device, **result,
            "readings": {k: v for k, v in outcome.readings.items() if k not in checks},
            "checks": checks}
    for k, v in outcome.phases.items():
        print(f"phase {k} {v!r} s", file=err)
    for k, v in line["readings"].items():
        print(f"reading {k} {v!r}", file=err)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0
