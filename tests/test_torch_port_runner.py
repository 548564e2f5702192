"""The port's YAML runner and the tools around it, end to end on the CPU.

A tiny YAML derived from ``experiments/brats.yaml`` (its
``synthesize_T1CE`` experiment at image 64, nf 16, ch_mult [1, 2], a
small critic, remat ``hires``, one epoch of two iterations at batch 2;
the critic needs 64², six FIR halvings) on a split that the port's
``preprocess`` writes from synthetic BraTS-2023 patients.  ``run`` writes
the JAX runner's file set (``session_metadata.json``, the checkpoints,
``generated_samples/pred`` and ``gt``, ``test_metrics.json``), and
``--train-only`` / ``--test-only`` behave as the JAX runner's: no test
outputs, and no training (``content.pt`` untouched).  ``metric_calc``
on the same directories prints the same metrics.  ``calibrate_int8``
writes sidecars that ``load_generators`` serves, and its record is
``calibrate_sampler``'s on the same batches and draws.  The volume
wrapper finds a patient's files by name and writes the volume, and the
demo writes a readable PNG.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from mudiff_torch import config
from mudiff_torch.cli import calibrate_int8, metric_calc, predict_volume_wrapper, run
from mudiff_torch.data import SliceDataset, preprocess
from mudiff_torch.infer import load_generators
from mudiff_torch.infer.calibrate import calib_sidecar_paths, calibrate_sampler, load_calib
from mudiff_torch.sampler import Sampler
from mudiff_torch.utils import nifti, png, yaml_lite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ARGS = dict(image_size=64, num_channels_dae=16, ch_mult=[1, 2], attn_resolutions=[16],
                 z_emb_dim=32, t_emb_dim=32, nz=8, ngf=8, num_epoch=1, lazy_reg=2,
                 use_grad_checkpoint=True, grad_checkpoint_policy="hires", use_bf16=False,
                 save_ckpt_every=1, log_every=1)
TEST_ARGS = {k: TINY_ARGS[k] for k in ("image_size", "num_channels_dae", "ch_mult",
                                       "attn_resolutions", "z_emb_dim", "t_emb_dim", "nz",
                                       "use_bf16")}
EXP = "synthesize_T1CE"


def _patients(root, n=8, shape=(64, 64, 3), seed=0):
    """BraTS-2023-named patients of four modalities: a blob on zeros."""
    rng = np.random.RandomState(seed)
    x, y = np.meshgrid(np.linspace(-1, 1, shape[0]), np.linspace(-1, 1, shape[1]),
                       indexing="ij")
    blob = (x ** 2 + y ** 2 < 0.7)[..., None]
    for p in range(n):
        d = os.path.join(root, f"BraTS-GLI-{p:05d}-000")
        os.makedirs(d)
        for m, kw in enumerate(("t1n", "t1c", "t2w", "t2f")):
            vol = (blob * (100.0 + 30 * m + 10 * rng.rand(*shape))).astype(np.float32)
            nifti.save(vol, np.eye(4), os.path.join(d, f"BraTS-GLI-{p:05d}-000-{kw}.nii.gz"))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny YAML, its data (4 / 2 / 2 slices) and one full run."""
    root = tmp_path_factory.mktemp("runner")
    raw, npy = str(root / "raw"), str(root / "npy")
    _patients(raw)
    preprocess.main(["--input_dir", raw, "--output_dir", npy, "--slice_half_range", "0",
                     "--train_ratio", "0.5", "--val_ratio", "0.25"])
    doc = yaml_lite.load(os.path.join(REPO, "experiments", "brats.yaml"))
    exp = next(e for e in doc["experiments"] if e["exp_name"] == EXP)
    exp = {**exp, "train_args": {**exp["train_args"], **TINY_ARGS},
           "test_args": {**exp["test_args"], **TEST_ARGS}}
    doc = {**doc, "data_path": npy, "output_root": str(root / "results"), "experiments": [exp]}
    path = str(root / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    results = run.main(["-c", path, "-e", EXP], device="cpu")
    return {"path": path, "doc": doc, "npy": npy, "raw": raw, "results": results,
            "exp_dir": results["exp_dir"]}


def test_run_writes_the_jax_runner_file_set(tiny):
    exp_dir = tiny["exp_dir"]
    assert exp_dir == os.path.join(tiny["doc"]["output_root"], EXP, "T1CE")
    files = set(os.listdir(exp_dir))
    assert {"session_metadata.json", "test_metrics.json", "content.pt", "gen_diffusive_1.pt",
            "gen_diffusive_2.pt", "training_history.json", "train_config.json",
            "generated_samples"} <= files
    with open(os.path.join(exp_dir, "session_metadata.json")) as f:
        meta = json.load(f)
    assert meta["experiment"] == EXP and meta["target"] == "T1CE"
    assert meta["torch_version"] == torch.__version__ and meta["devices"] == ["cpu"]
    assert meta["config_file"] == os.path.abspath(tiny["path"])
    train = tiny["results"]["train"]
    assert len(train["timings"]["iteration_s"]) == 2  # 4 train slices at batch 2
    with open(os.path.join(exp_dir, "train_config.json")) as f:
        cfg = json.load(f)["config"]
    assert cfg["use_grad_checkpoint"] and cfg["grad_checkpoint_policy"] == "hires"
    assert cfg["num_channels_dae"] == 16 and cfg["input_path"] == tiny["npy"]
    test = tiny["results"]["test"]
    assert test["n_slices"] == 2
    for kind in ("pred", "gt"):
        d = os.path.join(exp_dir, "generated_samples", kind)
        assert sorted(os.listdir(d)) == [f"{kind}_{i:05d}.png" for i in range(2)]
    with open(os.path.join(exp_dir, "test_metrics.json")) as f:
        metrics = json.load(f)
    assert metrics == test["metrics"]
    assert {"psnr", "ssim", "mae", "psnr_std"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())


def test_metric_calc_prints_the_runs_metrics(tiny, capsys):
    d = os.path.join(tiny["exp_dir"], "generated_samples")
    got = metric_calc.main(["--pred_dir", os.path.join(d, "pred"),
                            "--gt_dir", os.path.join(d, "gt")], device="cpu")
    assert json.loads(capsys.readouterr().out) == got
    want = tiny["results"]["test"]["metrics"]
    for k in ("psnr", "ssim", "mae"):
        assert got[k] == want[k]
    rand = metric_calc.main(["--pred_dir", os.path.join(d, "pred"),
                             "--gt_dir", os.path.join(d, "gt"), "--lpips_rand"], device="cpu")
    assert "lpips_rand" in rand and "lpips" not in rand and np.isfinite(rand["lpips_rand"])


def test_train_only_and_test_only_behave_as_jax(tiny, tmp_path):
    doc = {**tiny["doc"], "output_root": str(tmp_path / "r")}
    path = str(tmp_path / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    out = run.main(["-c", path, "-e", EXP, "--train-only"], device="cpu")
    files = set(os.listdir(out["exp_dir"]))
    assert "train" in out and "test" not in out
    assert "content.pt" in files and "test_metrics.json" not in files
    assert "generated_samples" not in files
    content = os.path.join(out["exp_dir"], "content.pt")
    stamp = os.stat(content).st_mtime_ns
    out = run.main(["-c", path, "-e", EXP, "--test-only"], device="cpu")
    assert "train" not in out and "test" in out
    assert os.stat(content).st_mtime_ns == stamp
    assert os.path.isfile(os.path.join(out["exp_dir"], "test_metrics.json"))
    with pytest.raises(ValueError, match="not found"):
        run.main(["-c", path, "-e", "nope"], device="cpu")


def test_calibrate_int8_writes_sidecars_load_generators_serves(tiny):
    argv = ["-c", tiny["path"], "-e", EXP, "--batches", "2", "--batch-size", "1",
            "--seed", "3"]
    out = calibrate_int8.main(argv, device="cpu")
    assert out["paths"] == calib_sidecar_paths(tiny["exp_dir"])
    doc, exp = config.load_experiment(tiny["path"], EXP)
    cfg = config._config_from_yaml(dict(exp["test_args"], use_int8=True, int8_static=False),
                                   doc["data_path"], doc["output_root"], EXP, "T1CE")
    # the same batches and draws through calibrate_sampler directly
    g1, g2 = load_generators(cfg, tiny["exp_dir"], device="cpu")
    ds = SliceDataset("val", cfg.input_path, "T1CE")
    want_idx = [sorted(np.random.RandomState(3).permutation(len(ds))[i:i + 1].tolist())
                for i in range(2)]
    assert out["indices"] == want_idx
    batches = [tuple(torch.from_numpy(c) for c in ds.gather_batch(np.array(i))[:3])
               for i in want_idx]
    post = Sampler(cfg, g1, g2, torch.device("cpu"), torch.float32).post
    want = calibrate_sampler(g1, g2, post, batches, cfg.num_timesteps, cfg.nz,
                             compute_dtype=torch.float32,
                             generator=torch.Generator().manual_seed(3))
    for got, ref, path in zip(out["calibs"], want, out["paths"]):
        assert got.to_json_dict() == ref.to_json_dict()
        assert load_calib(path).to_json_dict() == ref.to_json_dict()
        assert got.sites and got.min_ch == 64
    s1, s2 = load_generators(cfg.replace(int8_static=True), tiny["exp_dir"], device="cpu")
    assert s1.int8_calib.to_json_dict() == want[0].to_json_dict()
    assert s2.int8_calib.to_json_dict() == want[1].to_json_dict()


def test_volume_wrapper_finds_the_files_and_writes_the_volume(tiny, tmp_path):
    patient = os.path.join(tiny["raw"], "BraTS-GLI-00000-000")
    out = predict_volume_wrapper.main(
        ["--patient_dir", patient, "--target_modality", "T1CE", "--config", tiny["path"],
         "--experiment", EXP, "--ckpt_dir", tiny["exp_dir"], "--output_dir", str(tmp_path),
         "--slice_half_range", "1", "--batch_size", "2"], device="cpu")
    img = nifti.load(out)
    vol = img.get_fdata()
    assert vol.shape == (64, 64, 3) and np.allclose(img.affine, np.eye(4))
    assert np.isfinite(vol).all() and vol[..., 0:3].std() > 0
    with pytest.raises(FileNotFoundError, match="could not locate"):
        predict_volume_wrapper.main(["--patient_dir", str(tmp_path), "--ckpt_dir",
                                     tiny["exp_dir"]], device="cpu")


def test_demo_writes_a_readable_png(tmp_path):
    from mudiff_torch import demo

    out = demo.main(["--synthetic", "--image_size", "32", "--num_channels_dae", "16",
                     "--out", str(tmp_path / "panel")], device="cpu")
    assert out == str(tmp_path / "panel.png")
    img = png.read_gray8(out)
    assert img.shape == (32, 4 * 32) and img.std() > 0
    x = demo.irm_minmax(np.arange(100, dtype=np.float32).reshape(10, 10))
    assert x.min() == -1.0 and x.max() == 1.0
