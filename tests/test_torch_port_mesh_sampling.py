"""The slice test spread over the data mesh: gloo ranks on the CPU.

``sample_and_test(..., mesh=...)`` is the port of the JAX package's
``sample_and_test(use_mesh=True)``: the batch rounded up to a multiple of
the data axis, each rank sampling its rows of the global batch with the
global batch's draws sliced, the fakes gathered in rank order, the lead
rank alone writing.  The ranks are spawned as torchrun would (the
environment of ``test_torch_port_multiproc.py``, ``OMP_NUM_THREADS=1``)
at that file's tiny widths (nf 16, ch_mult (1, 2), fp32, 64²) on a
10-slice test split; they import torch only, the JAX side runs here.
What the tests hold:

* (a) at world size 2, ``batch_size`` 3 rounds up to a global batch of
  4 (the tail padded by 2) and gives one process's predictions at batch
  4 within rtol 1e-5, atol 1e-6 (fp32 summed in another order), with the
  same PNG codes within 1.  The only sums that a rank's two rows order
  otherwise than the batch of four are the dense layers' GEMMs (MKL picks
  its kernel by the row count: the time embedding's first dense differs
  in its last bit).  With ``F.linear`` taken row by row on both sides
  (``ROW_BY_ROW``) world size 2 gives one process's bits, in fp32 and in
  W8A8 with dynamic scales: nothing couples the rows, the per-example
  int8 scales included.  (Without it, such a last bit flips an int8 code
  now and then, and the W8A8 predictions move past fp32's tolerance.)
* (b) only the lead rank writes ``pred/``, ``gt/`` and the grids: the
  other rank's writers raise;
* (c) given the JAX run's draws of the global batch, the gathered
  predictions at world size 2 equal the JAX package's
  ``sample_and_test(use_mesh=True)`` over the 8 virtual CPU devices at
  batch 8, within the slice test's fp32 tolerance (atol 1e-3, rtol
  1e-3), with PNG codes within 1;
* (d) the ``test`` CLI (W8A8, its default) on 2 ranks prints its metrics
  once, those of one process, to the bit under ``ROW_BY_ROW``;
* (e) ``run --test-only`` on 2 ranks samples on both and writes
  ``test_metrics.json`` once, the metrics of one process (likewise);
* (f) a one-rank mesh on an explicit store gives the bits of no mesh;
* without a card the CLIs' default device raises, under torchrun's
  environment too, before any rendezvous.
"""

import contextlib
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from mudiff_tpu.config import MuDiffConfig as JaxConfig
from mudiff_tpu.infer import slice_test as jslice
from mudiff_tpu.models import NCSNppGenerator as JaxGenerator
from mudiff_torch.cli import args
from mudiff_torch.cli import run as run_cli
from mudiff_torch.cli import test as test_cli
from mudiff_torch.convert import GENERATOR_FILES, export_generators
from mudiff_torch.infer import sample_and_test
from mudiff_torch.parallel import init_mesh
from mudiff_torch.utils import png
from test_torch_port_helpers import random_flax_params
from test_torch_port_multiproc import _free_port, _spawn

TINY = dict(image_size=64, num_channels=1, num_channels_dae=16, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(8,), z_emb_dim=32, t_emb_dim=32, nz=8,
            ngf=8, num_timesteps=2, use_bf16=False, seed=3)
ARCH = ["--image_size", "64", "--num_channels", "1", "--num_channels_dae", "16",
        "--ch_mult", "1", "2", "--num_res_blocks", "1", "--attn_resolutions", "8",
        "--z_emb_dim", "32", "--t_emb_dim", "32", "--nz", "8", "--ngf", "8",
        "--num_timesteps", "2", "--seed", "3"]
MODES = {"fp32": ["--bf16", "--no_bf16", "--attn", "einsum"],
         "int8": ["--no_bf16", "--int8_dynamic", "--attn", "einsum"]}
N_SLICES = 10
BATCH = 3  # rounds up to 4 at world size 2: batches of 4, 4 and 2 + 2 padded
JAX_BATCH = 8  # the JAX package's mesh of 8 devices takes it as it is
EXP = "mesh_T1CE"

# F.linear row by row: the same GEMM for a row whatever the batch.
ROW_BY_ROW = r"""
def row_by_row(linear):
    def f(x, w, b=None):
        if x.dim() < 2 or x.shape[0] < 2:
            return linear(x, w, b)
        return torch.cat([linear(x[i:i + 1], w, b) for i in range(x.shape[0])])
    return f
"""
exec(ROW_BY_ROW)


@pytest.fixture()
def rows_alone(monkeypatch):
    monkeypatch.setattr(torch.nn.functional, "linear", row_by_row(torch.nn.functional.linear))

# A rank's writers raise while it samples, unless it leads.
_HEAD = r"""
import contextlib, io, json, os, sys
import numpy as np
import torch
from mudiff_torch.cli import args
from mudiff_torch.infer import slice_test

ARGS = json.loads(os.environ["T_ARGS"])
RANK = int(os.environ["RANK"])
LINEAR = torch.nn.functional.linear
""" + ROW_BY_ROW + r"""


@contextlib.contextmanager
def writers_raise(active):
    def boom(*a, **k):
        raise AssertionError("a non-lead rank wrote an artifact")

    names = ("export_png_pairs", "save_image_grid", "write_gray8")
    saved = [getattr(slice_test, n) for n in names] + [os.makedirs, json.dump]
    if active:
        for n in names:
            setattr(slice_test, n, boom)
        os.makedirs = json.dump = boom
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(slice_test, n, f)
        os.makedirs, json.dump = saved[-2:]
"""

_SAMPLE = _HEAD + r"""
from mudiff_torch.parallel import init_mesh

mesh = init_mesh(-1, 1, "cpu")
results = {}
for tag, extra, batch, draws, rows in ARGS["runs"]:
    torch.nn.functional.linear = row_by_row(LINEAR) if rows else LINEAR
    cfg, a = args.parse_config(ARGS["argv"] + extra, mode="test")
    if draws is not None:
        draws = torch.load(draws)
    with writers_raise(not mesh.lead):
        out = slice_test.sample_and_test(
            cfg, ckpt_dir=ARGS["ckpt"], output_dir=os.path.join(ARGS["out"], tag),
            batch_size=batch, save_grids=True, seed=3, attn=a.attn, draws=draws, mesh=mesh)
    results[tag] = out
mesh.close()
torch.save(results, os.path.join(ARGS["out"], f"rank{RANK}.pt"))
print("OK", RANK)
"""

_CLIS = _HEAD + r"""
from mudiff_torch.cli import run, test
from mudiff_torch.sampler import Sampler

torch.nn.functional.linear = row_by_row(LINEAR)
rows, call = [], Sampler.__call__
Sampler.__call__ = lambda self, c1, *a, **k: rows.append(c1.shape[0]) or call(self, c1, *a, **k)
report = {"rank": RANK}
for tag, fn, argv in (("test", test.main, ARGS["test"]), ("run", run.main, ARGS["run"])):
    os.environ["MASTER_PORT"] = str(ARGS["ports"][tag])  # a rendezvous each
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), writers_raise(RANK != 0):
        out = fn(argv, device="cpu")
    report[tag] = {"printed": printed.getvalue(), "rows": rows[:],
                   "returned": None if out is None else sorted(out)}
    rows.clear()
print("RESULT", json.dumps(report))
print("OK", RANK)
"""


@pytest.fixture(scope="module")
def test_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("npy")
    rng = np.random.RandomState(5)
    (root / "test").mkdir()
    for mod in ("T1", "T2", "FLAIR", "T1CE"):
        np.save(root / "test" / f"{mod}.npy",
                rng.randn(N_SLICES, 64, 64).astype(np.float32))
    return str(root)


@pytest.fixture(scope="module")
def generators(tmp_path_factory):
    """Seeded non-trivial JAX generator params, and the port's checkpoint."""
    cfg = JaxConfig(**TINY)
    x = jnp.zeros((1, 64, 64, 1))
    t, z = jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8))
    g1, g2 = JaxGenerator(config=cfg), JaxGenerator(config=cfg, adaptive=True)
    p1 = random_flax_params(g1, x, x, x, x, t, z, seed=6)
    p2 = random_flax_params(g2, x, x, x, x, t, z, pseudo_target=x, seed=7)
    ckpt = tmp_path_factory.mktemp("ckpt")
    export_generators(p1, p2, str(ckpt))
    return (g1, g2, p1, p2), str(ckpt)


def _jax_draws(test_split, batch, seed):
    """The JAX slice test's draws of each global batch (its per-batch key
    splits, then the sampler's per-step splits), as torch tensors."""
    key, draws = jax.random.PRNGKey(seed), []
    for _ in range(0, N_SLICES, batch):
        key, k_init, k = jax.random.split(key, 3)
        x_init = torch.from_numpy(np.array(jax.random.normal(k_init, (batch, 64, 64, 1))))
        noise = []
        for _ in range(TINY["num_timesteps"]):
            k, kz, kp = jax.random.split(k, 3)
            noise.append((torch.from_numpy(np.array(jax.random.normal(kz, (batch, 8)))),
                          torch.from_numpy(np.array(jax.random.normal(kp, (batch, 64, 64,
                                                                           1))))))
        draws.append((x_init, noise))
    return draws


def _config(test_split, mode):
    return args.parse_config(ARCH + MODES[mode] + ["--input_path", test_split],
                             mode="test")


def _one_process(test_split, ckpt, out, mode, batch, mesh=None, draws=None):
    cfg, a = _config(test_split, mode)
    return sample_and_test(cfg, ckpt_dir=ckpt, output_dir=out, batch_size=batch,
                           save_grids=True, seed=3, device="cpu", attn=a.attn, draws=draws,
                           mesh=mesh)


@pytest.fixture(scope="module")
def two_ranks(generators, test_split, tmp_path_factory):
    """One spawn of 2 ranks: fp32 at batch 3 with seeded draws, then each
    mode so with ``ROW_BY_ROW``, then fp32 at batch 8 with the JAX run's
    draws; what each rank returned."""
    _, ckpt = generators
    root = tmp_path_factory.mktemp("ranks")
    draws = str(root / "jax_draws.pt")
    torch.save(_jax_draws(test_split, JAX_BATCH, seed=3), draws)
    runs = [["fp32", MODES["fp32"], BATCH, None, False]]
    runs += [[f"{mode}-rows", MODES[mode], BATCH, None, True] for mode in MODES]
    runs.append(["jax", MODES["fp32"], JAX_BATCH, draws, False])
    _spawn(_SAMPLE, 2, args={"argv": ARCH + ["--input_path", test_split], "ckpt": ckpt,
                             "out": str(root), "runs": runs})
    return root, [torch.load(str(root / f"rank{r}.pt"), weights_only=False)
                  for r in range(2)]


def _codes_within_one(got_dir, want, kind):
    for i in range(N_SLICES):
        got = png.read_gray8(os.path.join(got_dir, f"{kind}_{i:05d}.png")).astype(int)
        assert np.abs(got - want[i].astype(int)).max() <= 1, (kind, i)


def test_two_ranks_give_one_process_predictions(two_ranks, generators, test_split,
                                                tmp_path):
    """(a) batch 3 at world size 2 is the global batch 4 of one process."""
    _, ranks = two_ranks
    lead = ranks[0]["fp32"]
    assert lead["batch_size"] == 4 and lead["n_slices"] == N_SLICES
    want = _one_process(test_split, generators[1], str(tmp_path), "fp32", 4)
    assert want["pred"].std() > 1e-2
    np.testing.assert_allclose(lead["pred"], want["pred"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(lead["gt"], want["gt"])
    np.testing.assert_array_equal(ranks[1]["fp32"]["pred"], lead["pred"])  # gathered
    for kind in ("pred", "gt"):
        _codes_within_one(lead[f"{kind}_dir"], want[f"{kind}_u8"], kind)


@pytest.mark.parametrize("mode", list(MODES))
def test_two_ranks_give_one_process_bits_row_by_row(two_ranks, generators, test_split,
                                                    tmp_path, rows_alone, mode):
    """(a) with the dense GEMMs row by row on both sides: the bits."""
    _, ranks = two_ranks
    got = ranks[0][f"{mode}-rows"]
    want = _one_process(test_split, generators[1], str(tmp_path), mode, 4)
    assert got["batch_size"] == 4 and want["pred"].std() > 1e-2
    for k in ("pred", "gt", "pred_u8", "gt_u8"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(ranks[1][f"{mode}-rows"]["pred"], got["pred"])


@pytest.mark.parametrize("tag", ["fp32", "int8-rows"])
def test_only_the_lead_rank_writes(two_ranks, tag):
    """(b) the other rank's writers raised had it called them (the spawn
    passed); the files are the lead's set, the grids of the global
    batches."""
    root, ranks = two_ranks
    assert {"pred_dir", "gt_dir", "pred_u8", "gt_u8"} <= set(ranks[0][tag])
    assert not {"pred_dir", "gt_dir", "pred_u8", "gt_u8"} & set(ranks[1][tag])
    assert sorted(os.listdir(root / tag)) == ["grid_00000.png", "grid_00004.png",
                                              "grid_00008.png", "gt", "pred"]
    for kind in ("pred", "gt"):
        names = sorted(os.listdir(root / tag / kind))
        assert names == [f"{kind}_{i:05d}.png" for i in range(N_SLICES)]
        for i, name in enumerate(names):
            np.testing.assert_array_equal(png.read_gray8(str(root / tag / kind / name)),
                                          ranks[0][tag][f"{kind}_u8"][i])


def test_two_ranks_match_the_jax_mesh(two_ranks, generators, test_split, tmp_path,
                                      monkeypatch):
    """(c) the JAX package's ``use_mesh`` path over 8 devices, batch 8:
    its predictions (read where it exports them) and its PNG codes."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    _, ranks = two_ranks
    gens, _ = generators
    exported, export = {}, jslice.export_png_pairs
    monkeypatch.setattr(jslice, "export_png_pairs",
                        lambda pred, gt, *dirs: exported.update(pred=pred, gt=gt)
                        or export(pred, gt, *dirs))
    ref = jslice.sample_and_test(JaxConfig(input_path=test_split, **TINY),
                                 ckpt_dir=str(tmp_path), output_dir=str(tmp_path / "jax"),
                                 batch_size=JAX_BATCH, seed=3, generators=gens,
                                 use_mesh=True)
    got = ranks[0]["jax"]
    assert got["batch_size"] == JAX_BATCH and got["n_slices"] == ref["n_slices"] == N_SLICES
    assert exported["pred"].std() > 1e-2
    np.testing.assert_allclose(got["pred"], exported["pred"], atol=1e-3, rtol=1e-3)
    np.testing.assert_array_equal(got["gt"], exported["gt"])
    for kind in ("pred", "gt"):
        codes = np.stack([np.asarray(Image.open(os.path.join(ref[f"{kind}_dir"],
                                                             f"{kind}_{i:05d}.png")))
                          for i in range(N_SLICES)])
        _codes_within_one(got[f"{kind}_dir"], codes, kind)


def _write_yaml(root, test_split, ckpt_src):
    """A runner YAML whose experiment's test args are ``TINY`` in fp32,
    its generators copied under ``<root>/results/EXP/T1CE``."""
    exp_dir = os.path.join(root, "results", EXP, "T1CE")
    os.makedirs(exp_dir)
    for name in GENERATOR_FILES:
        shutil.copy(os.path.join(ckpt_src, name), exp_dir)
    test_args = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()}
    doc = {"data_path": test_split, "output_root": os.path.join(root, "results"),
           "experiments": [{"exp_name": EXP, "target": "T1CE", "train_args": test_args,
                            "test_args": test_args}]}
    path = os.path.join(root, "mesh.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    return path, exp_dir


@pytest.fixture(scope="module")
def two_rank_clis(generators, test_split, tmp_path_factory):
    """The ``test`` CLI (its default int8 mode, dynamic scales) and ``run
    --test-only`` on 2 ranks, each with a rendezvous of its own, under
    ``ROW_BY_ROW``."""
    _, ckpt = generators
    root = tmp_path_factory.mktemp("clis")
    path, exp_dir = _write_yaml(str(root), test_split, ckpt)
    test_argv = ARCH + ["--input_path", test_split, "--ckpt_dir", ckpt,
                        "--test_batch_size", "4"]
    outs = _spawn(_CLIS, 2, args={"test": test_argv, "run": ["-c", path, "-e", EXP,
                                                             "--test-only"],
                                  "ports": {"test": _free_port(), "run": _free_port()}})
    reports = [json.loads(line.split("RESULT ", 1)[1]) for out in outs
               for line in out.splitlines() if line.startswith("RESULT ")]
    return sorted(reports, key=lambda r: r["rank"]), test_argv, exp_dir


def test_test_cli_on_two_ranks_prints_once(two_rank_clis, capsys, rows_alone):
    """(d) the metrics once, on the lead, equal to one process's."""
    reports, test_argv, _ = two_rank_clis
    assert reports[1]["test"]["printed"] == "" and reports[1]["test"]["returned"] is None
    assert [r["test"]["rows"] for r in reports] == [[2, 2, 2]] * 2
    printed = json.loads(reports[0]["test"]["printed"])
    want = test_cli.main(test_argv, device="cpu")
    assert json.loads(capsys.readouterr().out) == printed
    assert printed["n_slices"] == N_SLICES and {"psnr", "ssim", "mae"} <= set(printed)
    assert printed == {k: v for k, v in want.items() if k not in ("pred_u8", "gt_u8",
                                                                  "seconds")}


def test_run_test_only_on_two_ranks_writes_metrics_once(two_rank_clis, tmp_path,
                                                        generators, test_split,
                                                        rows_alone):
    """(e) both ranks sample their rows of the global batch of 8; the
    lead alone writes ``test_metrics.json`` (the other rank's ``json.dump``
    raised had it been called), those of one process."""
    reports, _, exp_dir = two_rank_clis
    assert [r["run"]["rows"] for r in reports] == [[4, 4]] * 2
    assert reports[1]["run"]["printed"] == ""
    assert reports[0]["run"]["returned"] == ["exp_dir", "test"]
    assert reports[1]["run"]["returned"] == ["exp_dir"]
    with open(os.path.join(exp_dir, "test_metrics.json")) as f:
        got = json.load(f)
    assert json.loads(reports[0]["run"]["printed"]) == got
    assert set(os.listdir(exp_dir)) >= {"session_metadata.json", "test_metrics.json",
                                        "generated_samples"}
    path, _ = _write_yaml(str(tmp_path), test_split, generators[1])
    want = run_cli.main(["-c", path, "-e", EXP, "--test-only"], device="cpu")
    assert got == want["test"]["metrics"]


@pytest.mark.parametrize("mode", list(MODES))
def test_one_rank_mesh_gives_the_bits_of_no_mesh(generators, test_split, tmp_path, mode):
    """(f) an explicit one-rank gloo group: the mesh path's draws,
    slicing and gather change no bit."""
    _, ckpt = generators
    want = _one_process(test_split, ckpt, str(tmp_path / "plain"), mode, BATCH)
    mesh = init_mesh(-1, 1, "cpu", store=torch.distributed.HashStore(), rank=0,
                     world_size=1)
    try:
        got = _one_process(test_split, ckpt, str(tmp_path / "mesh"), mode, BATCH, mesh=mesh)
    finally:
        mesh.close()
    assert got["batch_size"] == want["batch_size"] == BATCH
    for k in ("pred", "gt", "pred_u8", "gt_u8"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sorted(os.listdir(tmp_path / "mesh")) == sorted(os.listdir(tmp_path / "plain"))


@pytest.mark.parametrize("launched", [False, True], ids=["alone", "torchrun"])
@pytest.mark.parametrize("cli", ["test", "run"])
def test_cuda_entry_points_raise_without_a_card(generators, test_split, tmp_path,
                                                monkeypatch, cli, launched):
    """No path goes on on the CPU or alone: without a card the CLIs'
    default device raises, under torchrun's environment too (before any
    rendezvous)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if launched:
        for k, v in {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "2",
                     "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}.items():
            monkeypatch.setenv(k, v)
    if cli == "test":
        argv = ARCH + ["--input_path", test_split, "--ckpt_dir", generators[1]]
        main = test_cli.main
    else:
        argv = ["-c", _write_yaml(str(tmp_path), test_split, generators[1])[0], "-e", EXP,
                "--test-only"]
        main = run_cli.main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    assert not torch.distributed.is_initialized()
    assert not os.path.exists(tmp_path / "results" / EXP / "T1CE" / "generated_samples")
