"""The port's spans over a cell's traced window, on the card: each kernel
put down to the ``mudiff.*`` spans open where it was launched
(``perfbench/attribution.py``).

    python3 perfbench/tools/spans.py --workload nf128.train.b2 --seed 7 \\
        [--out chiprun_out/spans.json]

Runs the cell as ``perfbench/run.py --trace 1`` does (the same driver and
traced window; the result line comes first, standard error as the
harness writes it), keeps the window's profiler, then prints:

* ``span <path> <device ms> <launch calls> <host ms>``: one line per span
  path, the top 40 by device ms, over the window (``<path>/backward``:
  reached through the autograd link);
* ``attributed rule1 .. rule2 .. rule3 .. rule4 .. launch_calls N``: the
  share of device time each rule gave (4: unattributed);
* ``quantity <name> <value>``: the cell's norm, critic and K1 ``dw``
  device ms a slice and launch calls a slice (what the benchmark does not
  report yet: PERF.md §7);
* ``gap <seconds> <benchmark span>/<port span>/<host op>``: the longest
  idle gaps, the port span being the innermost one open at the gap's
  middle on the thread that launched the kernel ending the gap (left out
  where none was), the host op found with the port's spans left out.

``--out`` also writes every path's device ms by kernel name and rule.  A
development tool: the benchmark never runs it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench import core  # noqa: E402
from perfbench.attribution import PORT, Attribution, from_profile  # noqa: E402
from perfbench.trace import WINDOW, _gaps, _name_gaps  # noqa: E402

# the spans each split's quantities read, and the quantities' names
QUANTITIES = {"sample": {"norm_ms_per_slice": "nn.norm"},
              "train": {"norm_ms_per_slice": "nn.norm", "critic_ms_per_slice": "critic",
                        "k1_dw_ms_per_slice": "ops.conv3x3.dw"}}


def quantities(tv, att: Attribution) -> dict:
    """{name.<split>: value} of the view's split (a span with no kernel
    under it is left out)."""
    out = {}
    for name, match in QUANTITIES[tv.kind].items():
        if att.has_span(match):
            out[f"{name}.{tv.kind}"] = 1e3 * att.device_s(match) / tv.slices
    out[f"launch_calls_per_slice.{tv.kind}"] = att.total_launch_calls() / tv.slices
    return out


def port_gaps(tv, att: Attribution, events, keep: int = 10):
    """The ``keep`` longest idle gaps of ``tv`` as ``(name, seconds)``,
    named as the harness names them but with the port's spans left out of
    the host ops and the innermost port span put in (``events``: the
    profiler's ``events()``)."""
    from torch.autograd import DeviceType

    spans, ops = [], []
    for evt in events:
        s, e = evt.time_range.start / 1e6, evt.time_range.end / 1e6
        if evt.device_type == DeviceType.CPU:
            if evt.name.startswith("perfbench."):
                spans.append((evt.name, s, e))
            elif not evt.name.startswith(PORT):
                ops.append((evt.name, s, e))
    win = [x for x in spans if x[0] == WINDOW]
    lo, hi = win[0][1], win[0][2]
    gaps = _gaps(tv.kernels, lo, hi)
    named = _name_gaps(gaps, spans, ops)
    out = {}
    for (g_lo, g_hi), (name, sec) in zip(sorted(gaps, key=lambda g: g[0] - g[1]), named):
        port = att.port_span_at(g_hi, 0.5 * (g_lo + g_hi))
        if port:
            bench, op = name.split("/", 1)
            name = f"{bench}/{port}/{op}"
        out[name] = out.get(name, 0.0) + sec
    return sorted(out.items(), key=lambda kv: -kv[1])[:keep]


def report_lines(tv, att: Attribution, events) -> list:
    """The tool's lines for the traced view ``tv``, its attribution and the
    profiler's ``events()``."""
    lines = [f"span {p} {1e3 * dev!r} {calls} {1e3 * host!r}"
             for p, dev, calls, host in att.table()]
    shares = " ".join(f"rule{r} {v!r}" for r, v in att.rule_shares().items())
    lines.append(f"attributed {shares} launch_calls {att.total_launch_calls()}")
    lines += [f"quantity {k} {v!r}" for k, v in quantities(tv, att).items()]
    lines += [f"gap {sec!r} {name}" for name, sec in port_gaps(tv, att, events)]
    return lines


def records(tv, att: Attribution) -> dict:
    """What ``--out`` holds: per path, device ms by kernel name and rule."""
    by_path: dict = {}
    for name, s, e, path, rule in att.kernels:
        key = f"{name[:100]} (rule {rule})"
        row = by_path.setdefault(path, {})
        row[key] = row.get(key, 0.0) + 1e3 * (e - s)
    return {"kind": tv.kind, "slices": tv.slices, "window_s": tv.window_s,
            "busy_s": tv.busy_s, "quantities": quantities(tv, att),
            "rules": att.rule_shares(), "launch_calls": att.launch_calls,
            "host_ms": {p: 1e3 * s for p, s in att.host_s.items()}, "device_ms": by_path}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from pathlib import Path

    root = Path(ROOT)
    manifest, cell, config, traffic, limits = core.find_cell(root, args.workload)
    core.set_cache_dirs(root)

    import torch
    import torch.profiler

    if not torch.cuda.is_available():
        print("spans: no CUDA device; the traced window runs on the card", file=sys.stderr)
        return 2
    profiles, outcomes = [], []

    class _Kept(torch.profiler.profile):
        """The harness's profiler, kept once its window has closed."""

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            profiles.append(self)
            return out

    torch.profiler.profile = _Kept
    run_driver = core.run_driver

    def kept_run_driver(ctx):
        outcomes.append(run_driver(ctx))
        return outcomes[-1]

    core.run_driver = kept_run_driver
    ctx = core.Ctx(root, cell, config, traffic, limits, args.seed, args.seconds, True, "cuda",
                   T0)
    rc = core.report(ctx, manifest, torch.cuda.get_device_name(0), int(cell["chips"]))
    if rc != 0:
        return rc
    tv, prof = outcomes[-1].trace, profiles[-1]
    events = prof.events()
    from torch.autograd import DeviceType

    win = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    att = from_profile(prof, win[0].time_range.start / 1e6, win[0].time_range.end / 1e6)
    if att is None:
        print("spans: the profiler kept no raw events to attribute", file=sys.stderr)
        return 1
    for line in report_lines(tv, att, events):
        print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cell": args.workload, "seed": args.seed, **records(tv, att)}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
