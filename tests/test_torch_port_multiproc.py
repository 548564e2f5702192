"""mudiff_torch's mesh across processes: gloo ranks on the CPU.

Each test spawns its ranks as torchrun would (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT`` on 127.0.0.1 with a
free port, ``OMP_NUM_THREADS=1``, as ``tests/test_multihost.py`` runs the
JAX package's processes), at tiny widths (nf 16, ch_mult (1, 2), fp32)
on 64² slices, the least the critic's six downsamples keep whole (at 16²
the JAX critic's last maps are empty).  What they hold:

* the minibatch-stddev feature at world size 2, local batch 2, equals the
  one-process function on the batch of 4, with its input gradient;
* one D (R1) + G iteration at (dp, fsdp) = (2, 1) and (1, 2), also with
  dropout under ``blocks`` remat, equals the one-process iteration on the
  concatenated batch (that iteration is held against the JAX step in
  ``test_torch_port_train.py``), within that file's fp32 tolerances
  (rtol 1e-5, atol 1e-6): the losses and the synced gradients against the
  one-process iteration's; every updated parameter, the Adam moments and
  the EMA against one process's updates from those gradients.  (Adam's
  first step sends a gradient within its eps = 1e-8 of zero to about
  +-lr / 2, so the ~3e-10 by which fp32 sums in another order move such
  an element moves its parameter by ~1e-6; the update is held on the
  gradients it was given, the gradients against the reference.)
* the loop at world size 2 for two epochs: the non-lead rank's artifact
  writers raise, the parameters end bit-identical on both ranks, and the
  ``content.pt`` it wrote resumes at world size 1 for a third epoch;
* a SIGTERM delivered to one rank stops both at the same step, with one
  checkpoint;
* a failed rendezvous raises; nothing goes on alone.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mudiff_torch.config import MuDiffConfig
from mudiff_torch.train import checkpoint as ckpt
from mudiff_torch.train import create_train_state, loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=64, num_channels=1, num_channels_dae=16, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(8,), z_emb_dim=32, t_emb_dim=32, nz=8,
            ngf=8, num_timesteps=4, r1_gamma=0.05, lazy_reg=2, use_bf16=False,
            use_ema=True, ema_decay=0.9)
LOOP = dict(TINY, num_timesteps=2, batch_size=1, num_epoch=2, log_every=1,
            save_content_every=1, save_ckpt_every=1, seed=7, exp="mesh",
            target_modality="T1CE")

# The workers' common head: torchrun's environment -> the mesh.
_HEAD = r"""
import json, os, signal
import numpy as np
import torch
import torch.distributed as dist
from mudiff_torch.config import MuDiffConfig
from mudiff_torch.parallel import init_mesh, rows_of
from mudiff_torch.parallel import mesh as mesh_module

mesh_module.BUCKET_ELEMENTS = 5000  # many buckets, some tensors alone
mesh = init_mesh(int(os.environ["T_DP"]), int(os.environ["T_FSDP"]), "cpu")
ARGS = json.loads(os.environ["T_ARGS"])


def config():
    return MuDiffConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in ARGS["config"].items()})
"""

_STDDEV = _HEAD + r"""
from mudiff_torch.models.critic import minibatch_stddev

rng = np.random.RandomState(0)
x = torch.from_numpy(rng.randn(4, 3, 3, 5).astype(np.float32))
w = torch.from_numpy(rng.randn(4, 3, 3, 6).astype(np.float32))
whole = x.clone().requires_grad_(True)
want = minibatch_stddev(whole)
(want_grad,) = torch.autograd.grad((want * w).sum(), whole)
rows = rows_of(4, mesh)
mine = x[rows].clone().requires_grad_(True)
got = minibatch_stddev(mine, mesh=mesh)
(got_grad,) = torch.autograd.grad((got * w[rows]).sum(), mine)
# the feature of the global batch: one group of four, not two of two
assert not torch.allclose(minibatch_stddev(x[rows]), want[rows])
torch.testing.assert_close(got, want[rows].detach(), rtol=1e-6, atol=1e-7)
torch.testing.assert_close(got_grad, want_grad[rows], rtol=1e-6, atol=1e-7)
print("OK", mesh.rank)
"""

_ITERATION = _HEAD + r"""
from mudiff_torch.train import TrainDraws, create_train_state, make_d_step, make_g_step
from mudiff_torch.train import checkpoint as ckpt

cfg = config()
gen = torch.Generator().manual_seed(1)
ref = create_train_state(cfg, seed=0, steps_per_epoch=10, device="cpu", attn="flash")
with torch.no_grad():  # seeded non-trivial weights, the zero-init convs too
    for m in (ref.g1, ref.g2, ref.d):
        for p in m.parameters():
            noise = torch.randn(p.shape, generator=gen)
            fan = p[..., 0].numel() if p.dim() == 4 else p.shape[-1] if p.dim() == 2 else 0
            p.copy_(noise / fan ** 0.5 if fan else p + 0.1 * noise)
ours = create_train_state(cfg, seed=0, steps_per_epoch=10, device="cpu", attn="flash",
                          mesh=mesh)
start = ckpt.content_payload(ref, 0, 0)
ckpt.load_payload(ours, start)
synced = {"ref": [], "ours": []}


def recording(tag, state):  # the synced gradients of each step, whole
    sync = state.sync_grads

    def sync_grads(name, grads):
        out = sync(name, grads)
        synced[tag].append([g.clone() for g in state.sharded[name].whole_tensors(out)])
        return out

    state.sync_grads = sync_grads


recording("ref", ref)
recording("ours", ours)
n = 4
rng = np.random.RandomState(0)
batch = [torch.from_numpy((rng.randn(n, 64, 64, 1) * 0.5).astype(np.float32))
         for _ in range(4)]
rows = rows_of(n, mesh)
local = [b[rows].clone() for b in batch]
d_step, g_step = make_d_step(), make_g_step()
g_ref, g_ours = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
aux_ref, aux = {}, {}
aux_ref.update(d_step(ref, batch, TrainDraws.draw(cfg, batch[3], g_ref), True))
aux.update(d_step(ours, local, TrainDraws.draw(cfg, local[3], g_ours, mesh), True))
aux_ref.update(g_step(ref, batch, TrainDraws.draw(cfg, batch[3], g_ref)))
aux.update(g_step(ours, local, TrainDraws.draw(cfg, local[3], g_ours, mesh)))
for k, v in aux_ref.items():
    np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)


def held(a, b, path):
    if torch.is_tensor(a):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6, err_msg=path)
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            held(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            held(x, y, f"{path}/{i}")
    else:
        assert a == b, (path, a, b)


held(synced["ours"], synced["ref"], "gradients")
# one process's updates from the mesh's gradients
again = create_train_state(cfg, seed=0, steps_per_epoch=10, device="cpu", attn="flash")
ckpt.load_payload(again, start)
again.apply_d_updates(synced["ours"][0])
again.apply_g_updates(*synced["ours"][1:])
want, got = ckpt.content_payload(again, 0, 1), ckpt.content_payload(ours, 0, 1)
assert want["opt_d"]["state"] and want["ema_g1"] is not None
held(got, want, "content")
print("OK", mesh.rank)
"""

_LOOP = _HEAD + r"""
from mudiff_torch.train import create_train_state, loop
from mudiff_torch.train import checkpoint as ckpt

if not mesh.lead:  # the lead's writers are load-bearing (test_multihost.py:218-224)
    def boom(*a, **k):
        raise AssertionError("a non-lead rank wrote an artifact")
    loop.save_image_grid = loop.epoch_visual_report = ckpt.atomic_save = boom
    np.save = json.dump = boom
cfg = config()
state = create_train_state(cfg, seed=cfg.seed, steps_per_epoch=ARGS["steps"], device="cpu",
                           attn="flash", mesh=mesh)
saves = []
save_content = ckpt.save_content
ckpt.save_content = lambda *a: saves.append(a[3]) or save_content(*a)


class Draws(loop.SeededDraws):
    calls = 0

    def iteration(self, real):
        if mesh.rank == ARGS.get("kill_rank") and self.calls == ARGS["kill_at"]:
            os.kill(os.getpid(), signal.SIGTERM)
        self.calls += 1
        return super().iteration(real)


out = loop.train(cfg, verbose=False, device="cpu", attn="flash", state=state, mesh=mesh,
                 draws=Draws(cfg, torch.device("cpu"), mesh))
state.materialize()
flat = torch.cat([p.detach().reshape(-1) for m in (state.g1, state.g2, state.d)
                  for p in m.parameters()])
both = [torch.empty_like(flat) for _ in range(mesh.world)]
dist.all_gather(both, flat)
assert torch.equal(both[0], both[1]), "the ranks' parameters differ"
print("RESULT", json.dumps({"rank": mesh.rank, "preempted": out.get("preempted", False),
                            "saves": saves, "r1_steps": out["r1_steps"]}))
print("OK", mesh.rank)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(src, world, dp=-1, fsdp=1, args=None, timeout=240):
    """Run ``src`` as ``world`` ranks; returns each rank's output."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
               "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "T_DP": str(dp),
               "T_FSDP": str(fsdp), "T_ARGS": json.dumps(args or {})}
        procs.append(subprocess.Popen([sys.executable, "-c", src], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        assert f"OK {rank}" in out, out[-4000:]
    return outs


def _results(outs):
    return [json.loads(line.split("RESULT ", 1)[1]) for out in outs
            for line in out.splitlines() if line.startswith("RESULT ")]


def test_minibatch_stddev_is_the_global_batchs():
    _spawn(_STDDEV, 2)


@pytest.mark.parametrize("dp,fsdp,over", [
    (2, 1, {}),
    (1, 2, {}),
    (2, 1, dict(dropout=0.1, use_grad_checkpoint=True, grad_checkpoint_policy="blocks")),
    (1, 2, dict(dropout=0.1, use_grad_checkpoint=True, grad_checkpoint_policy="blocks")),
], ids=["dp2", "fsdp2", "dp2-dropout-blocks", "fsdp2-dropout-blocks"])
def test_iteration_equals_world_size_one(dp, fsdp, over):
    config = {k: list(v) if isinstance(v, tuple) else v for k, v in {**TINY, **over}.items()}
    _spawn(_ITERATION, 2, dp, fsdp, {"config": config})


@pytest.fixture()
def slices(tmp_path):
    """As ``tests/test_multihost.py``'s noise: 64², 8 train and 4 val slices."""
    rng = np.random.RandomState(0)
    for split, n in (("train", 8), ("val", 4)):
        (tmp_path / split).mkdir()
        for mod in ("T1", "T2", "FLAIR", "T1CE"):
            np.save(tmp_path / split / f"{mod}.npy",
                    (rng.randn(n, 64, 64) * 2).astype(np.float32))
    return tmp_path


def _loop_config(slices, tmp_path, **over):
    cfg = dict(LOOP, input_path=str(slices), output_path=str(tmp_path / "out"), **over)
    return {k: list(v) if isinstance(v, tuple) else v for k, v in cfg.items()}


def test_loop_on_two_ranks_resumes_on_one(slices, tmp_path):
    config = _loop_config(slices, tmp_path, dp=2)
    outs = _spawn(_LOOP, 2, 2, 1, {"config": config, "steps": 4})
    res = _results(outs)
    assert [r["saves"] for r in res] == [[4, 8], [4, 8]]  # every rank took part
    assert res[0]["r1_steps"] == [0, 2, 4, 6]
    exp = os.path.join(config["output_path"], "mesh", "T1CE")
    files = set(os.listdir(exp))
    assert {"content.pt", "gen_diffusive_1.pt", "gen_diffusive_2_1.pt", "train_config.json",
            "training_history.json", "val_psnr_values.npy", "sample_epoch_1.png"} <= files
    assert np.load(os.path.join(exp, "val_psnr_values.npy")).shape == (3, 2)
    saved = ckpt.load_content(exp)
    assert (saved["epoch"], saved["global_step"], saved["step"]) == (1, 8, 8)

    # the file restores at world size 1, tensor for tensor
    cfg = MuDiffConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in
                          {**config, "dp": -1, "num_epoch": 3, "resume": True}.items()})
    state = create_train_state(cfg, seed=3, steps_per_epoch=8, device="cpu", attn="flash")
    ckpt.restore_content(exp, state)
    payload = ckpt.content_payload(state, saved["epoch"], saved["global_step"])
    for name in ("g1", "g2", "d", "opt_d", "ema_g2"):
        flat = lambda d: {k: v for k, v in d.items() if torch.is_tensor(v)}  # noqa: E731
        got = flat(payload[name]) if name[:3] != "opt" else {
            k: v["exp_avg"] for k, v in payload[name]["state"].items()}
        want = flat(saved[name]) if name[:3] != "opt" else {
            k: v["exp_avg"] for k, v in saved[name]["state"].items()}
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
    # ... and a third epoch runs on one process
    out = loop.train(cfg, verbose=False, device="cpu", attn="flash")
    with open(out["history"]) as f:
        assert [h["epoch"] for h in json.load(f)] == [0, 1, 2]
    resumed = ckpt.load_content(exp)
    assert (resumed["epoch"], resumed["global_step"]) == (2, 16)


def test_sigterm_on_one_rank_stops_both_at_one_step(slices, tmp_path):
    config = _loop_config(slices, tmp_path, dp=2)
    outs = _spawn(_LOOP, 2, 2, 1, {"config": config, "steps": 4, "kill_rank": 1,
                                   "kill_at": 2})
    res = _results(outs)
    # rank 1's flag is agreed at the end of its iteration 2: both stop at step 3
    assert [(r["preempted"], r["saves"]) for r in res] == [(True, [3]), (True, [3])]
    saved = ckpt.load_content(os.path.join(config["output_path"], "mesh", "T1CE"))
    assert (saved["epoch"], saved["global_step"]) == (0, 3)


_RENDEZVOUS = r"""
import datetime, os
from mudiff_torch.parallel import init_mesh
try:
    init_mesh(-1, 1, "cpu", timeout=datetime.timedelta(seconds=3))
except Exception as e:  # the rendezvous's own error type varies by cause
    print("RAISED", type(e).__name__, "OK 0")
else:
    print("went on alone")
"""


def test_a_failed_rendezvous_raises():
    """Rank 0 of a world of 2 whose rank 1 never comes."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1", "RANK": "0",
           "LOCAL_RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    out = subprocess.run([sys.executable, "-c", _RENDEZVOUS], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "RAISED" in out.stdout and "went on alone" not in out.stdout, out.stdout
