"""mudiff_torch's mesh in one process: the layout and loader rules against
the JAX package, the mesh's refusals, and the collectives at world size 1.

Across processes see ``test_torch_port_multiproc.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mudiff_tpu import config as jconfig
from mudiff_tpu.data.datasets import SliceDataset as JaxSliceDataset
from mudiff_tpu.data.loader import DeviceLoader as JaxDeviceLoader
from mudiff_tpu.models import DiscriminatorLarge as JaxCritic
from mudiff_tpu.models import NCSNppGenerator as JaxGenerator
from mudiff_tpu.parallel.mesh import _param_spec
from mudiff_torch import config
from mudiff_torch.convert import _convert_leaf, _flatten
from mudiff_torch.data import DeviceLoader, SliceDataset
from mudiff_torch.models import DiscriminatorLarge, NCSNppGenerator
from mudiff_torch.parallel import (average_grads, average_scalars, any_rank, gather_rows,
                                   gather_shards, init_mesh, mesh_shape, param_spec,
                                   reduce_scatter_grads, rows_of, shard)
from mudiff_torch.parallel import mesh as mesh_module

TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _flax_shapes(name):
    """The flax parameter tree of G1, G2 or the critic at the recipe's
    widths (nf=64), as ShapeDtypeStructs (nothing is computed)."""
    cfg = jconfig.brats_recipe(image_size=64)
    x = jnp.zeros((1, 64, 64, 1))
    t = jnp.zeros((1,), jnp.int32)
    z = jnp.zeros((1, cfg.nz))
    key = jax.random.PRNGKey(0)
    if name == "d":
        m = JaxCritic(ngf=cfg.ngf, t_emb_dim=cfg.t_emb_dim)
        return jax.eval_shape(m.init, key, x, t, x)["params"]
    m = JaxGenerator(config=cfg, adaptive=name == "g2")
    kw = {"pseudo_target": x} if name == "g2" else {}
    return jax.eval_shape(m.init, key, x, x, x, x, t, z, **kw)["params"]


def _port_shapes(name):
    cfg = config.brats_recipe(image_size=64)
    with torch.device("meta"):
        if name == "d":
            m = DiscriminatorLarge(ngf=cfg.ngf, t_emb_dim=cfg.t_emb_dim, device="meta")
        else:
            m = NCSNppGenerator(cfg, adaptive=name == "g2", device="meta")
    return {n: tuple(p.shape) for n, p in m.named_parameters()}


@pytest.mark.parametrize("name", ["g1", "g2", "d"])
def test_param_spec_shards_what_the_jax_mesh_shards(name):
    """Each parameter's slices hold the same elements as the JAX layout's
    (``_param_spec`` under ``shard_params``' 2**14 floor), after
    ``convert.py``'s name and layout mapping: each flax leaf is numbered
    0..n-1, carried over by the mapping, and cut by both rules."""
    ports = _port_shapes(name)
    seen = set()
    sharded = 0
    for path, leaf in _flatten(jax.tree_util.tree_map(
            lambda s: np.arange(int(np.prod(s.shape)), dtype=np.float64).reshape(s.shape),
            _flax_shapes(name))):
        key, arr = _convert_leaf(path, leaf)
        assert ports[key] == arr.shape, key
        seen.add(key)
        for f in (2, 4):
            spec = (tuple(_param_spec(leaf.shape, f)) if leaf.size >= 2 ** 14 else ())
            jax_axis = next((i for i, s in enumerate(spec) if s == "fsdp"), None)
            axis = param_spec(arr.shape, f)
            assert (axis is None) == (jax_axis is None), (key, f, spec, axis)
            if axis is None:
                continue
            sharded += 1
            for k in range(f):
                want = np.sort(np.array_split(leaf, f, axis=jax_axis)[k], axis=None)
                got = np.sort(np.array_split(arr, f, axis=axis)[k], axis=None)
                np.testing.assert_array_equal(got, want, err_msg=f"{key} F={f} slice {k}")
    assert seen == set(ports)
    assert sharded > 0


def test_param_spec_rules():
    assert param_spec((3, 3, 64, 64), 1) is None
    assert param_spec((3, 3, 8, 8), 2) is None  # under 2**14
    assert param_spec((3, 3, 64, 128), 2) == 3
    assert param_spec((3, 3, 128, 128), 4) == 2  # the first of equal axes
    assert param_spec((256, 256), 2) == 1  # (out, in): flax's first axis is in
    assert param_spec((3, 3, 128, 130), 4) == 2  # 130 is not divisible
    assert param_spec((3, 3, 127, 129), 2) is None


def test_mesh_shape_resolves_as_make_mesh():
    assert mesh_shape(-1, 1, 8) == (8, 1)
    assert mesh_shape(-1, 2, 8) == (4, 2)
    assert mesh_shape(2, 0, 2) == (2, 1)
    for dp, fsdp, world in ((2, 1, 1), (-1, 3, 8), (2, 2, 8)):
        with pytest.raises(ValueError):
            mesh_shape(dp, fsdp, world)
    assert rows_of(8, None) == slice(0, 8)


def test_init_mesh_without_a_launcher(monkeypatch):
    for k in TORCHRUN:
        monkeypatch.delenv(k, raising=False)
    assert init_mesh(-1, 1, "cpu") is None
    assert init_mesh(1, 1, "cpu") is None
    for dp, fsdp in ((2, 1), (-1, 2)):
        with pytest.raises(ValueError, match="processes"):
            init_mesh(dp, fsdp, "cpu")
    assert not dist.is_initialized()


def test_init_mesh_refuses_before_the_rendezvous(monkeypatch):
    """A mesh that does not fit the world, or an incomplete environment,
    raises at once: no rank waits for a rendezvous that cannot be right."""
    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for dp, fsdp in ((3, 1), (1, 1), (-1, 4), (2, 2)):
        with pytest.raises(ValueError, match="processes"):
            init_mesh(dp, fsdp, "cpu")
    monkeypatch.delenv("MASTER_ADDR")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        init_mesh(2, 1, "cpu")
    with pytest.raises(ValueError, match="rank and world_size"):
        init_mesh(1, 1, "cpu", store=dist.HashStore())
    assert not dist.is_initialized()


@pytest.fixture()
def one_rank(monkeypatch):
    """A one-rank gloo mesh on an in-process store."""
    monkeypatch.setattr(mesh_module, "BUCKET_ELEMENTS", 40)
    mesh = init_mesh(1, 1, "cpu", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield mesh
    finally:
        mesh.close()


def test_collectives_at_world_size_one_keep_the_bits(one_rank):
    mesh = one_rank
    assert (mesh.rank, mesh.dp, mesh.fsdp, mesh.data_index, mesh.fsdp_index) == (0, 1, 1, 0, 0)
    assert mesh.lead and mesh.device == torch.device("cpu")
    g = torch.Generator().manual_seed(0)
    grads = [torch.randn(s, generator=g) for s in ((3, 3, 2, 4), (50,), (7, 5), (1,))]
    out = average_grads(grads, mesh)  # four buckets, one tensor alone
    assert all(torch.equal(a, b) for a, b in zip(out, grads))
    axes = [None, 0, 1, None]
    assert reduce_scatter_grads(grads, axes, mesh) == grads
    assert gather_shards(grads, axes, mesh) == grads
    assert shard(grads[0], None, mesh) is grads[0]
    assert torch.equal(shard(grads[1], 0, mesh), grads[1])
    x = torch.randn(2, 3, 3, 4, generator=g, requires_grad=True)
    y = gather_rows(x, mesh)
    assert torch.equal(y, x)
    (gx,) = torch.autograd.grad((y * y).sum(), x, create_graph=True)
    (ggx,) = torch.autograd.grad(gx.sum(), x)
    assert torch.equal(gx, 2 * x) and torch.equal(ggx, torch.full_like(x, 2.0))
    losses = {"a": torch.tensor(1.5), "b": torch.tensor(-2.0)}
    assert {k: float(v) for k, v in average_scalars(losses, mesh).items()} == {"a": 1.5,
                                                                              "b": -2.0}
    assert any_rank(True, mesh) and not any_rank(False, mesh)
    mesh.barrier()


@pytest.fixture(scope="module")
def split_root(tmp_path_factory):
    """11 train and 5 val slices of 8²: odd counts, so the floor cut and
    the padding both act."""
    root = tmp_path_factory.mktemp("split")
    rng = np.random.RandomState(0)
    for split, n in (("train", 11), ("val", 5)):
        (root / split).mkdir()
        for mod in ("T1", "T2", "FLAIR", "T1CE"):
            np.save(root / split / f"{mod}.npy", rng.randn(n, 8, 8).astype(np.float32))
    return str(root)


@pytest.mark.parametrize("split,kw", [
    ("train", dict(shuffle=True)),
    ("val", dict(shuffle=False, pad_last=True)),
], ids=["train-shuffled", "val-padded"])
def test_loader_rows_equal_the_jax_loaders(split_root, split, kw):
    """At P = 2 each rank's rows of every global batch (global batch 4)
    are the JAX loader's for that ``process_index``, and the global batch
    is their concatenation."""
    port_ds = SliceDataset(split, split_root, "T1CE")
    jax_ds = JaxSliceDataset(split, split_root, "T1CE")
    for epoch in (0, 3):
        ranks = []
        for p in range(2):
            ours = DeviceLoader(port_ds, 4, seed=5, device="cpu", process_index=p,
                                process_count=2, **kw)
            ref = JaxDeviceLoader(jax_ds, 4, seed=5, process_index=p, process_count=2, **kw)
            assert len(ours) == len(ref)
            np.testing.assert_array_equal(ours.epoch_indices(epoch), ref._epoch_indices(epoch))
            got = [[t.numpy() for t in b] for b in ours.epoch(epoch)]
            want = [[np.asarray(a) for a in b] for b in ref.epoch(epoch)]
            assert len(got) == len(want) == len(ours)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)
            ranks.append(got)
        whole = [[np.concatenate([ranks[0][i][j], ranks[1][i][j]]) for j in range(4)]
                 for i in range(len(ranks[0]))]
        assert all(b[3].shape[0] == 4 for b in whole)
