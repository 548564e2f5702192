#!/usr/bin/env python3
"""The phantom quality protocol of the port on one NVIDIA GPU: flagship64
trained by the port and read on held-out patients in every serving mode.

    python3 phantom_quality.py --work DIR [--seed 1024] [--experiment flagship64]
        [--budget-s S] [--out FILE.json]

Stages, run in this order, each skipped when a previous call under the same ``--work``,
``--experiment`` and ``--seed`` finished it (the record is
``DIR/<experiment>-seed<seed>/protocol.json``):

- ``data``: the phantom set at the command in the header of
  ``experiments/phantom_flagship.yaml`` (seed 0, 60 patients, 256², 8
  slices: 336 / 72 / 72 slices), written by ``python -m
  mudiff_torch.data.phantom`` into ``DIR/phantom256``, shared by seeds;
- ``train``: a copy of the YAML in that directory with ``data_path``
  and ``output_root`` pointed there, the training ``seed`` set from
  ``--seed`` and ``resume`` true once a ``content.pt`` exists (the
  shipped file is read, never written), then ``python -m
  mudiff_torch.cli.run -c <copy> -e <experiment> --train-only`` as a
  subprocess; the card's ``memory.used`` (nvidia-smi) is polled meanwhile;
- ``calibrate``: ``mudiff_torch.cli.calibrate_int8`` (its
  defaults: 4 val batches of 4), the sites each sidecar records;
- ``ab``: ``mudiff_torch.cli.ab_int8_quality --lpips_rand`` over
  ``bf16,int8,int8-static`` x ``einsum,bf16``, then ``bf16,int8-static``
  with ``flash``;
- ``report``: one JSON line: every leg's row, the seed, the per-epoch
  val PSNR and epoch seconds of ``training_history.json``, each stage's
  wall seconds, the memory peak and the card's name and power limit.

``--budget-s`` bounds the call: when it is spent during training the
subprocess gets a SIGTERM, finishes its iteration and saves
``content.pt``; the call then stops, and the next one resumes.  A resumed
run continues at the epoch after the one it stopped in, as the port's and
the JAX package's ``--resume`` do, so a chunk that ends inside an epoch
trains that epoch's remaining iterations not at all: the record lists
each chunk's stop.  ``num_epoch`` is never changed (the cosine schedule
rests on it).  A later stage starts only with budget left.

Exits non-zero, printing no report, without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
YAML = "experiments/phantom_flagship.yaml"
EXPERIMENT = "flagship64"  # the protocol's; the YAML's flagship128* run the same way
STAGES = ("data", "train", "calibrate", "ab", "report")
# the set of the YAML header's command
PHANTOM_ARGS = {"n_patients": 60, "image_size": 256, "slices": 8, "seed": 0}
PHANTOM_SLICES = {"train": 336, "val": 72, "test": 72}
AB_LEGS = (("bf16,int8,int8-static", "einsum,bf16"), ("bf16,int8-static", "flash"))
MODS = ("T1", "T1CE", "T2", "FLAIR")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def write_yaml(run_dir: str, data: str, seed: int, resume: bool, epochs=None) -> str:
    """A copy of YAML in ``run_dir``: ``data_path`` -> ``data``,
    ``output_root`` -> ``run_dir/runs``, the training anchor's ``seed``
    and ``resume``; ``epochs`` (the smoke's short run only) sets
    flagship64's ``num_epoch``.  The copy is checked against the shipped
    file key by key.  Returns its path."""
    from mudiff_torch.utils import yaml_lite

    src = os.path.join(REPO, YAML)
    with open(src) as f:
        text = f.read()
    shipped = yaml_lite.loads(text)
    subs = [(f"data_path: {shipped['data_path']}\n", f"data_path: {data}\n"),
            (f"output_root: {shipped['output_root']}\n",
             f"output_root: {os.path.join(run_dir, 'runs')}\n"),
            ("    seed: 1024\n    resume: false\n",
             f"    seed: {seed}\n    resume: {'true' if resume else 'false'}\n")]
    if epochs is not None:
        subs.append(("    batch_size: 8\n    num_epoch: 16\n",
                     f"    batch_size: 8\n    num_epoch: {epochs}\n"))
    for old, new in subs:
        if text.count(old) != 1:
            raise AssertionError(f"{YAML} no longer holds {old.strip()!r} once")
        text = text.replace(old, new)
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "phantom_flagship.yaml")
    with open(path, "w") as f:
        f.write(text)
    copy = yaml_lite.load(path)
    for a, b in zip(shipped["experiments"], copy["experiments"]):
        want = {**a["train_args"], "seed": seed, "resume": resume}
        if epochs is not None and a["exp_name"] == EXPERIMENT:
            want["num_epoch"] = epochs
        if want != b["train_args"] or a["test_args"] != b["test_args"]:
            raise AssertionError(f"the copy of {YAML} changed {a['exp_name']} beyond "
                                 "seed, resume and num_epoch")
    return path


def exp_dir_of(yaml_path: str, experiment: str) -> str:
    from mudiff_torch.config import load_experiment

    doc, exp = load_experiment(yaml_path, experiment)
    return os.path.join(doc["output_root"], experiment, exp["target"])


def make_data(data: str) -> dict:
    """The phantom set, unless every split is already there."""
    from mudiff_torch.data import phantom

    have = all(os.path.isfile(os.path.join(data, s, f"{m}.npy"))
               for s in PHANTOM_SLICES for m in MODS)
    if have:
        import numpy as np

        counts = {s: int(np.load(os.path.join(data, s, "T1CE.npy"), mmap_mode="r").shape[0])
                  for s in PHANTOM_SLICES}
    else:
        counts = phantom.main(["--output_dir", data]
                              + [a for k, v in PHANTOM_ARGS.items() for a in (f"--{k}", str(v))])
    if counts != PHANTOM_SLICES:
        raise AssertionError(f"phantom split {counts} != {PHANTOM_SLICES}")
    return {"slices": counts, "reused": have}


class MemoryPoll:
    """The card's largest ``memory.used`` (MiB, nvidia-smi) while open."""

    def __init__(self, every_s: float = 2.0):
        self.every_s, self.peak_mib = every_s, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                                      "--format=csv,noheader,nounits"],
                                     capture_output=True, text=True, timeout=30).stdout
                self.peak_mib = max([self.peak_mib] + [int(v) for v in out.split()])
            except (OSError, ValueError, subprocess.SubprocessError):
                pass
            self._stop.wait(self.every_s)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def train_chunk(run_dir: str, data: str, seed: int, experiment: str,
                deadline: float) -> dict:
    """One call's training: the run CLI as a subprocess, SIGTERM at the
    deadline.  Returns whether training finished, the stop of a cut
    chunk, the seconds and the memory peak."""
    path = write_yaml(run_dir, data, seed, resume=False)
    content = os.path.join(exp_dir_of(path, experiment), "content.pt")
    if os.path.isfile(content):
        path = write_yaml(run_dir, data, seed, resume=True)
    log_path = os.path.join(run_dir, f"train_{int(time.time())}.log")
    cmd = [sys.executable, "-m", "mudiff_torch.cli.run", "-c", path, "-e", experiment,
           "--train-only"]
    t0 = time.perf_counter()
    stopped, lines = None, []
    with MemoryPoll() as mem, open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, bufsize=1)
        timer = threading.Timer(min(max(0.0, deadline - time.time()), 1e9),
                                lambda: proc.poll() is None and proc.send_signal(signal.SIGTERM))
        timer.start()
        try:
            for line in proc.stdout:
                log.write(line)
                log.flush()
                if line.startswith(("[EPOCH", "[signal] content", "resumed from")):
                    print(f"[phantom_quality] seed {seed}: {line.rstrip()}", flush=True)
                if line.startswith("[signal] content"):
                    stopped = line.split("saved at ", 1)[1].split(";")[0]
                lines.append(line)
                del lines[:-40]
            rc = proc.wait()
        finally:
            timer.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if rc != 0:
        raise RuntimeError(f"training exited {rc}; last lines:\n{''.join(lines)}")
    return {"finished": stopped is None, "stopped_at": stopped, "log": log_path,
            "seconds": time.perf_counter() - t0, "memory_used_peak_mib": mem.peak_mib,
            "resumed": "resume: true" in open(path).read()}


def calibrate(yaml_path: str, experiment: str) -> dict:
    from mudiff_torch.cli import calibrate_int8

    out = calibrate_int8.main(["-c", yaml_path, "-e", experiment])
    return {"sites": [len(c.sites) for c in out["calibs"]],
            "min_ch": [c.min_ch for c in out["calibs"]], "indices": out["indices"]}


def ab(yaml_path: str, experiment: str, out_dir: str) -> dict:
    from mudiff_torch.cli import ab_int8_quality

    rows = {}
    for modes, attns in AB_LEGS:
        res = ab_int8_quality.main(["-c", yaml_path, "-e", experiment, "--out", out_dir,
                                    "--modes", modes, "--attn", attns, "--lpips_rand"])
        rows.update(res[experiment]["ab"])
    return rows


def report(record: dict, run_dir: str, experiment: str, card: str) -> dict:
    history_path = os.path.join(exp_dir_of(os.path.join(run_dir, "phantom_flagship.yaml"),
                                           experiment), "training_history.json")
    with open(history_path) as f:
        history = json.load(f)
    chunks = record["train"]["chunks"]
    return {"card": card, "experiment": experiment, "seed": record["seed"],
            "data": record["data"], "val_psnr": [h["val_psnr"] for h in history],
            "epoch_s": [h["epoch_time"] for h in history],
            "epochs": [h["epoch"] for h in history],
            "train_chunks": [{k: c[k] for k in ("stopped_at", "seconds", "resumed")}
                             for c in chunks],
            "memory_used_peak_mib": max(c["memory_used_peak_mib"] for c in chunks),
            "calibration": record["calibrate"], "ab": record["ab"],
            "stage_s": record["stage_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work", required=True, help="the data and every seed's runs")
    ap.add_argument("--seed", type=int, default=1024, help="the training seed")
    ap.add_argument("--experiment", default=EXPERIMENT,
                    help="an experiment of the YAML (its flagship128* too)")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="stop this call after about so many seconds (resumable)")
    ap.add_argument("--out", help="also write the report here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("phantom_quality: no CUDA device; the protocol runs on the card", file=sys.stderr)
        return 2
    from mudiff_torch.ops import _build

    start = time.time()
    deadline = start + args.budget_s if args.budget_s is not None else float("inf")
    card = card_line()
    print(card, flush=True)
    work = os.path.abspath(args.work)
    data = os.path.join(work, "phantom256")
    run_dir = os.path.join(work, f"{args.experiment}-seed{args.seed}")
    os.makedirs(run_dir, exist_ok=True)
    record_path = os.path.join(run_dir, "protocol.json")
    record = {"seed": args.seed, "experiment": args.experiment, "stage_s": {},
              "train": {"chunks": []}}
    if os.path.isfile(record_path):
        with open(record_path) as f:
            record = json.load(f)

    def save():
        with open(record_path, "w") as f:
            json.dump(record, f, indent=1)

    _build.build()  # every kernel, one nvcc per source, before the subprocess
    yaml_path = os.path.join(run_dir, "phantom_flagship.yaml")
    for stage in STAGES:
        if stage != "report" and record.get(f"{stage}_done"):
            continue
        if time.time() >= deadline:
            print(f"[phantom_quality] budget spent before {stage}; rerun to continue",
                  flush=True)
            return 0
        t = time.perf_counter()
        if stage == "data":
            record["data"] = make_data(data)
        elif stage == "train":
            chunk = train_chunk(run_dir, data, args.seed, args.experiment, deadline)
            record["train"]["chunks"].append(chunk)
            if not chunk["finished"]:
                record["stage_s"]["train"] = record["stage_s"].get("train", 0.0) + chunk["seconds"]
                save()
                print(f"[phantom_quality] training stopped at {chunk['stopped_at']}; "
                      "rerun to resume", flush=True)
                return 0
        elif stage == "calibrate":
            record["calibrate"] = calibrate(yaml_path, args.experiment)
        elif stage == "ab":
            record["ab"] = ab(yaml_path, args.experiment, os.path.join(run_dir, "ab"))
        else:
            line = report(record, run_dir, args.experiment, card)
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(line, f, indent=1)
            continue
        record[f"{stage}_done"] = True
        record["stage_s"][stage] = record["stage_s"].get(stage, 0.0) + time.perf_counter() - t
        save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
