"""The phantom quality protocol's tools of the port, on the CPU.

``python -m mudiff_torch.data.phantom`` writes the bytes of
``tools/make_phantom_dataset.py`` (loaded from its path; the port never
imports it) for the same arguments.  ``ab_int8_quality`` on a tiny copy
of ``experiments/phantom_flagship.yaml``'s flagship64 (image 64, the
critic's six FIR halvings need it; nf 16, fp32, two steps) and a checkpoint that one
training iteration of the port's ``run`` wrote on a port phantom set
gives one row per mode and attention lowering with the JAX tool's keys;
``int8-static`` without the calibration sidecars raises, and so does an
unknown mode.  ``phantom_quality.write_yaml`` changes only what it says,
and ``phantom_quality.py`` refuses to run without a card.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from mudiff_torch.cli import ab_int8_quality, calibrate_int8, run
from mudiff_torch.data import phantom
from mudiff_torch.utils import yaml_lite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KEYS = {"psnr", "ssim", "mae", "psnr_std", "ssim_std", "mae_std", "sample_and_test_s"}
TINY = dict(image_size=64, num_channels_dae=16, ch_mult=[1, 2], attn_resolutions=[8],
            z_emb_dim=32, t_emb_dim=32, nz=8, ngf=8, use_bf16=False, num_timesteps=2)
EXP = "flagship64"


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_phantom_dataset", os.path.join(REPO, "tools", "make_phantom_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,shell", [(0, True), (5, False)])
def test_phantom_cli_writes_the_tools_bytes(tmp_path, seed, shell):
    """Seed 0 through ``python -m``, seed 5 through ``main(argv)``."""
    args = ["--n_patients", "4", "--image_size", "32", "--slices", "2", "--seed", str(seed)]
    _tool().main(["--output_dir", str(tmp_path / "jax")] + args)
    port = ["--output_dir", str(tmp_path / "port")] + args
    if shell:
        subprocess.run([sys.executable, "-m", "mudiff_torch.data.phantom"] + port, cwd=REPO,
                       check=True, capture_output=True)
    else:
        assert phantom.main(port) == {"train": 4, "val": 2, "test": 2}
    for split, n in (("train", 4), ("val", 2), ("test", 2)):
        for mod in phantom.MODS:
            name = os.path.join(split, f"{mod}.npy")
            with open(tmp_path / "jax" / name, "rb") as f, open(tmp_path / "port" / name,
                                                                 "rb") as g:
                assert f.read() == g.read(), name
            assert np.load(tmp_path / "port" / name).shape == (n, 32, 32)


def test_phantom_split_at_the_yaml_header():
    splits = phantom.split_of_patients(60, 0.7, 0.15)
    assert [splits.count(s) for s in phantom.SPLITS] == [42, 9, 9]
    assert splits == sorted(splits, key=phantom.SPLITS.index)
    with pytest.raises(ValueError, match="one patient per split"):
        phantom.split_of_patients(2, 0.7, 0.15)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny flagship64 YAML on a 64² port phantom set (4 / 2 / 2 slices)
    and one training iteration of ``run --train-only`` at batch 4."""
    root = tmp_path_factory.mktemp("phantom")
    npy = str(root / "npy")
    phantom.main(["--output_dir", npy, "--n_patients", "4", "--image_size", "64",
                  "--slices", "2"])
    doc = yaml_lite.load(os.path.join(REPO, "experiments", "phantom_flagship.yaml"))
    exp = next(e for e in doc["experiments"] if e["exp_name"] == EXP)
    exp = {**exp, "train_args": {**exp["train_args"], **TINY, "batch_size": 4,
                                 "num_epoch": 1},
           "test_args": {**exp["test_args"], **TINY}}
    doc = {**doc, "data_path": npy, "output_root": str(root / "runs"), "experiments": [exp]}
    path = str(root / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    res = run.main(["-c", path, "-e", EXP, "--train-only"], device="cpu")
    assert len(res["train"]["timings"]["iteration_s"]) == 1
    return {"path": path, "root": root, "exp_dir": res["exp_dir"]}


def test_ab_rows_per_mode_and_attn_with_the_jax_keys(trained, capsys):
    argv = ["-c", trained["path"], "-e", EXP, "--out", str(trained["root"] / "ab")]
    with pytest.raises(FileNotFoundError, match="int8_static requires the calibration"):
        ab_int8_quality.main(argv + ["--modes", "int8-static"], device="cpu")
    calibrate_int8.main(["-c", trained["path"], "-e", EXP, "--batches", "1"], device="cpu")
    capsys.readouterr()
    out = ab_int8_quality.main(argv + ["--attn", "einsum,bf16"], device="cpu")[EXP]
    legs = ["bf16", "bf16-bf16", "int8", "int8-bf16", "int8-static", "int8-static-bf16"]
    assert list(out["ab"]) == legs
    for leg, row in out["ab"].items():
        assert set(row) == JAX_KEYS, leg
        assert all(np.isfinite(v) for v in row.values()), leg
        pred = out["dirs"][leg]["pred_dir"]
        assert pred == str(trained["root"] / "ab" / EXP / leg / "pred")
        assert len([f for f in os.listdir(pred) if f.endswith(".png")]) == 2
    printed = capsys.readouterr().out.strip().splitlines()
    assert [line.split(" ", 2)[:2] for line in printed[:-1]] == [[EXP, leg] for leg in legs]
    last = json.loads(printed[-1])
    assert last == {"experiment": EXP, "target": "T1CE", "ab": out["ab"]}
    # the bf16 leg again, with the LPIPS proxy: the same sample (seeded draws)
    again = ab_int8_quality.main(argv + ["--modes", "bf16", "--lpips_rand"], device="cpu")
    row = again[EXP]["ab"]["bf16"]
    assert set(row) == JAX_KEYS | {"lpips_rand", "lpips_rand_std"}
    assert {k: row[k] for k in ("psnr", "ssim", "mae")} == \
        {k: out["ab"]["bf16"][k] for k in ("psnr", "ssim", "mae")}


def test_int8_sites_reads_every_routed_site_and_replays_the_dynamic_leg(trained):
    """``int8_sites.py`` on the tiny checkpoint: one reading per routed
    site of each generator (the sidecars' sites), sorted by the dynamic
    error; its free-running leg with no site in bf16 is the A/B's int8
    row, and each further leg keeps the worst sites in bf16.  The
    captured site holds what the witness test reads."""
    sys.path.insert(0, REPO)
    try:
        import int8_sites
    finally:
        sys.path.remove(REPO)
    argv = ["-c", trained["path"], "-e", EXP]
    calibrate_int8.main(argv + ["--batches", "1"], device="cpu")
    out = int8_sites.int8_sites(trained["path"], EXP, out_dir=str(trained["root"] / "sites"),
                                device="cpu", worst=(0, 1), capture="g2#0")
    want = ab_int8_quality.main(argv + ["--out", str(trained["root"] / "ab8"), "--modes",
                                        "int8"], device="cpu")[EXP]["ab"]["int8"]
    sites = out["teacher_forced"]
    g1 = [s for s in sites if s["site"].startswith("g1#")]
    g2 = [s for s in sites if s["site"].startswith("g2#")]
    sidecars = [json.load(open(os.path.join(trained["exp_dir"], f"int8_calib_g{i}.json")))
                for i in (1, 2)]
    assert [len(g1), len(g2)] == [len(c["sites"]) for c in sidecars]
    assert len(sites) == len(g1) + len(g2)
    assert [s["dyn"] for s in sites] == sorted((s["dyn"] for s in sites), reverse=True)
    assert all(np.isfinite(s[k]) and s[k] >= 0 for s in sites for k in ("dyn", "static", "ratio"))
    free = out["free_running"]
    assert {k: free["dynamic, worst 0 in bf16"][k] for k in ("psnr", "ssim", "mae")} == \
        {k: want[k] for k in ("psnr", "ssim", "mae")}
    assert free["dynamic, worst 1 in bf16"]["kept_bf16"] == [sites[0]["site"]]
    cap = torch.load(out["captured"])
    assert out["captured"] == str(trained["root"] / "int8_site_g2_0.pt")
    assert cap["site"] == "g2#0" and cap["x"].shape[0] == 1
    first = sidecars[1]["sites"][0]
    assert (cap["x"].shape[-1], cap["w"].shape[-1]) == (first["cin"], first["cout"])
    assert cap["dyn_mean"] == next(s["dyn"] for s in sites if s["site"] == "g2#0")
    assert 0 <= cap["dyn_example"] and cap["dyn_call"] == max(
        cap["dyn_call"], cap["dyn_mean"])


@pytest.mark.parametrize("flag,value", [("--modes", "bf16,fp8"), ("--attn", "einsum,sdpa")])
def test_ab_refuses_an_unknown_mode_or_lowering(trained, flag, value):
    with pytest.raises(SystemExit, match="unknown"):
        ab_int8_quality.main(["-c", trained["path"], "-e", EXP, flag, value], device="cpu")


def test_phantom_quality_copy_changes_only_its_keys(tmp_path):
    sys.path.insert(0, REPO)
    try:
        import phantom_quality
    finally:
        sys.path.remove(REPO)
    path = phantom_quality.write_yaml(str(tmp_path), "/data/p", seed=1025, resume=True)
    shipped = yaml_lite.load(os.path.join(REPO, phantom_quality.YAML))
    copy = yaml_lite.load(path)
    assert copy["data_path"] == "/data/p"
    assert copy["output_root"] == str(tmp_path / "runs")
    for a, b in zip(shipped["experiments"], copy["experiments"]):
        assert b["train_args"] == {**a["train_args"], "seed": 1025, "resume": True}
        assert b["test_args"] == a["test_args"]
    short = yaml_lite.load(phantom_quality.write_yaml(str(tmp_path), "/d", 1024, False, 1))
    exps = {e["exp_name"]: e for e in short["experiments"]}
    assert exps[EXP]["train_args"]["num_epoch"] == 1
    assert exps["flagship128"]["train_args"]["num_epoch"] == 20
    if not torch.cuda.is_available():
        assert phantom_quality.main(["--work", str(tmp_path / "w")]) == 2
