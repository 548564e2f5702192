"""The (data, fsdp) mesh of processes and the collectives of the training step.

The port of ``mudiff_tpu/parallel/mesh.py``.  The JAX package builds one
``jax.sharding.Mesh`` with axes ``data`` (the batch) and ``fsdp`` (each
large parameter sharded along its largest divisible axis) and lets the
partitioner insert the collectives.  Here the mesh is a set of processes,
one per GPU, launched by ``torchrun``, and the step makes its collectives
itself (``train/steps.py``, ``train/state.py``):

* rank ``r`` sits at ``(data_index, fsdp_index) = (r // fsdp, r % fsdp)``,
  as ``np.asarray(devices).reshape(dp, fsdp)`` places devices
  (``mesh.py:46-47``);
* the **data group** of a rank is its column: the ``dp`` ranks of its
  ``fsdp_index``, in data order.  Gradients are averaged over it, and the
  critic's minibatch-stddev feature gathers the batch over it
  (``gather_rows``);
* the **fsdp group** is its row: the ``fsdp`` ranks of its
  ``data_index``, which read the same batch rows.  A tensor that
  ``param_spec`` shards is kept by each of them as one slice, and its
  gradient is reduce-scattered over them.

DDP and ``fully_shard`` are not used: the step takes its gradients with
``torch.autograd.grad`` (R1's grad-of-grad included), which never runs the
``AccumulateGrad`` hooks those wrappers synchronise on.  Every collective
here is blocking and runs on torch's current stream.  With a mesh the
collectives run whatever its sizes (a one-rank group copies); a run not
launched by ``torchrun`` has no mesh (``None``) and makes none.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# tensors under this many elements are replicated (``mesh.py:72-90``)
MIN_SHARD_SIZE = 2 ** 14
# elements flattened into one collective (128 MiB of fp32)
BUCKET_ELEMENTS = 2 ** 25
# torchrun's rendezvous protocol
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def mesh_shape(dp: int, fsdp: int, world: int) -> Tuple[int, int]:
    """``(dp, fsdp)`` for ``world`` processes, as ``make_mesh`` resolves
    them (``mesh.py:35-45``): ``fsdp <= 0`` is 1, ``dp <= 0`` is
    ``world / fsdp``; raises unless ``dp * fsdp == world``."""
    fsdp = fsdp if fsdp > 0 else 1
    if dp <= 0:
        if world % fsdp:
            raise ValueError(f"{world} processes are not divisible by fsdp={fsdp}")
        dp = world // fsdp
    if dp * fsdp != world:
        raise ValueError(f"mesh {dp}x{fsdp} != {world} processes; pass dp and fsdp that "
                         "multiply to the world size (torchrun's --nproc_per_node x nodes)")
    return dp, fsdp


@dataclass(eq=False)
class Mesh:
    """This process's place on the mesh and its two groups."""

    rank: int
    world: int
    dp: int
    fsdp: int
    device: torch.device
    data_group: Any
    fsdp_group: Any

    @property
    def data_index(self) -> int:
        return self.rank // self.fsdp

    @property
    def fsdp_index(self) -> int:
        return self.rank % self.fsdp

    @property
    def lead(self) -> bool:
        """Rank 0, which alone writes files and logs."""
        return self.rank == 0

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def close(self) -> None:
        """Leave the process group (every rank)."""
        dist.destroy_process_group()


def init_mesh(dp: int = -1, fsdp: int = 1, device=None, *, store=None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              timeout: timedelta = timedelta(minutes=10)) -> Optional[Mesh]:
    """Join the process group and build the mesh; None without a launcher.

    The group comes from torchrun's rendezvous environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or
    from an explicit ``store`` with ``rank`` and ``world_size``.  Without
    either the world is this one process: ``dp * fsdp`` must be 1 and no
    group is made.  The backend follows ``device`` (default the card):
    NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU.  Raises when ``dp *
    fsdp`` is not the world size, when the environment is incomplete and
    when the rendezvous fails (after ``timeout``); a run never goes on
    alone.
    """
    env = os.environ
    if store is None and "RANK" not in env and "WORLD_SIZE" not in env:
        mesh_shape(dp, fsdp, 1)
        return None
    if store is None:
        missing = [k for k in TORCHRUN_ENV if k not in env]
        if missing:
            raise RuntimeError(f"incomplete torchrun environment: {missing} not set")
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env["LOCAL_RANK"])
    else:
        if rank is None or world_size is None:
            raise ValueError("an explicit store needs rank and world_size")
        local_rank = rank
    dp, fsdp = mesh_shape(dp, fsdp, world_size)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_mesh: CUDA is not available; pass device='cpu' for gloo")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    kw: Dict[str, Any] = {"backend": backend, "timeout": timeout, "rank": rank,
                          "world_size": world_size}
    if store is None:
        kw["init_method"] = "env://"
    else:
        kw["store"] = store
    dist.init_process_group(**kw)
    # every rank makes every group, in the same order
    rows = [list(range(d * fsdp, (d + 1) * fsdp)) for d in range(dp)]
    cols = [list(range(f, world_size, fsdp)) for f in range(fsdp)]
    fsdp_group, _ = dist.new_subgroups_by_enumeration(rows, backend=backend)
    data_group, _ = dist.new_subgroups_by_enumeration(cols, backend=backend)
    return Mesh(rank, world_size, dp, fsdp, device, data_group, fsdp_group)


def data_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh of ``mesh``'s ranks all on the data axis, ``(world, 1)``,
    over the same process group: what sampling takes (``make_mesh(dp=-1,
    fsdp=1)`` in the JAX package).  ``mesh`` itself when its fsdp is 1;
    else every rank must call it, and closing either mesh closes both."""
    if mesh is None or mesh.fsdp == 1:
        return mesh
    backend = dist.get_backend()
    fsdp_group, _ = dist.new_subgroups_by_enumeration([[r] for r in range(mesh.world)],
                                                      backend=backend)
    data_group, _ = dist.new_subgroups_by_enumeration([list(range(mesh.world))],
                                                      backend=backend)
    return Mesh(mesh.rank, mesh.world, mesh.world, 1, mesh.device, data_group, fsdp_group)


def param_spec(shape: Sequence[int], fsdp: int,
               min_size: int = MIN_SHARD_SIZE) -> Optional[int]:
    """The axis of a tensor that fsdp shards, or None (replicated).

    A twin of ``_param_spec`` as ``shard_params`` applies it
    (``mesh.py:59-90``): a tensor under ``min_size`` elements is
    replicated; else the largest axis that ``fsdp`` divides, the first of
    equal ones.  The port's matrices (dense, 1x1 and NIN weights) are the
    transposes of flax's (``convert.py``), so their axes are ranked in
    flax's order and the same weights are sharded along the same axis.
    """
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if fsdp <= 1 or not shape or n < min_size:
        return None
    axes = list(range(len(shape)))
    if len(shape) == 2:
        axes.reverse()  # flax (in, out) order
    for ax in sorted(axes, key=lambda i: -shape[i]):
        if shape[ax] >= fsdp and shape[ax] % fsdp == 0:
            return ax
    return None


def shard(t: torch.Tensor, axis: Optional[int], mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's slice of ``t`` along ``axis`` (a contiguous copy), or
    ``t`` itself when it is replicated."""
    if axis is None or mesh is None:
        return t
    return t.chunk(mesh.fsdp, dim=axis)[mesh.fsdp_index].clone()


def _buckets(tensors: Sequence[torch.Tensor], index: Sequence[int]) -> List[List[int]]:
    """``index`` cut into runs of one dtype of at most BUCKET_ELEMENTS
    (a larger tensor alone)."""
    out: List[List[int]] = []
    size = 0
    for i in index:
        n = tensors[i].numel()
        if out and tensors[out[-1][0]].dtype == tensors[i].dtype and size + n <= BUCKET_ELEMENTS:
            out[-1].append(i)
            size += n
        else:
            out.append([i])
            size = n
    return out


def _unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [p.view(t.shape) for p, t in zip(flat.split([t.numel() for t in like]), like)]


def _all_reduce_mean(tensors: Sequence[torch.Tensor], index: Sequence[int], group,
                     size: int) -> List[torch.Tensor]:
    out = list(tensors)
    for bucket in _buckets(tensors, index):
        like = [tensors[i] for i in bucket]
        flat = torch.cat([t.reshape(-1) for t in like])
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        for i, t in zip(bucket, _unflatten(flat, like)):
            out[i] = t
    return out


def average_grads(grads: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """The mean of each gradient over the data group (the per-rank means
    of the loss become the global batch's), flattened into buckets."""
    if mesh is None:
        return list(grads)
    return _all_reduce_mean(grads, range(len(grads)), mesh.data_group, mesh.dp)


def reduce_scatter_grads(grads: Sequence[torch.Tensor], axes: Sequence[Optional[int]],
                         mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """Over the fsdp group: the mean of each sharded gradient,
    reduce-scattered to this rank's slice; the mean of each replicated
    one.  The ranks of a row read the same rows, so both means keep what
    they computed and hold the row's copies equal."""
    if mesh is None or mesh.fsdp == 1:
        return list(grads)
    f = mesh.fsdp
    sharded = [i for i, a in enumerate(axes) if a is not None]
    replicated = [i for i, a in enumerate(axes) if a is None]
    out = _all_reduce_mean(grads, replicated, mesh.fsdp_group, f)
    for bucket in _buckets(grads, sharded):
        pieces = [grads[i].chunk(f, dim=axes[i]) for i in bucket]
        flat = torch.cat([p[k].reshape(-1) for k in range(f) for p in pieces])
        mine = flat.new_empty(flat.numel() // f)
        dist.reduce_scatter_tensor(mine, flat, group=mesh.fsdp_group)
        mine.div_(f)
        for i, t in zip(bucket, _unflatten(mine, [p[0] for p in pieces])):
            out[i] = t
    return out


def gather_shards(shards: Sequence[torch.Tensor], axes: Sequence[Optional[int]],
                  mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """The whole tensors of ``shards`` (each rank's slice joined along its
    axis over the fsdp group); replicated entries come back as they are."""
    if mesh is None or mesh.fsdp == 1:
        return list(shards)
    f = mesh.fsdp
    out = list(shards)
    sharded = [i for i, a in enumerate(axes) if a is not None]
    for bucket in _buckets(shards, sharded):
        like = [shards[i] for i in bucket]
        flat = torch.cat([t.reshape(-1) for t in like])
        whole = flat.new_empty(f * flat.numel())
        dist.all_gather_into_tensor(whole, flat, group=mesh.fsdp_group)
        per_rank = [_unflatten(row, like) for row in whole.view(f, -1)]
        for j, i in enumerate(bucket):
            out[i] = torch.cat([per_rank[k][j] for k in range(f)], dim=axes[i])
    return out


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0; its adjoint is ``_SumScatterRows``."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        out = x.new_empty((size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _SumScatterRows.apply(grad, ctx.group, ctx.size), None, None


class _SumScatterRows(torch.autograd.Function):
    """Reduce-scatter (sum) along dim 0; its adjoint is ``_GatherRows``."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        out = x.new_empty((x.shape[0] // size, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _GatherRows.apply(grad, ctx.group, ctx.size), None, None


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The batch of ``x`` over the data group, in rank order (the global
    batch).  Differentiable to any order: the backward sums each rank's
    gradient of these rows over the group (a reduce-scatter), whose
    backward is the gather again (R1's grad-of-grad).  (torch's
    ``distributed.nn.functional.all_gather`` is not used: its gloo
    backward addresses global ranks and fails on a subgroup.)"""
    if mesh is None:
        return x
    return _GatherRows.apply(x, mesh.data_group, mesh.dp)


def rows_of(n: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a global batch of ``n``."""
    if mesh is None:
        return slice(0, n)
    b = n // mesh.dp
    return slice(mesh.data_index * b, (mesh.data_index + 1) * b)


def average_scalars(values: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                    ) -> Dict[str, torch.Tensor]:
    """Each scalar's mean over the data group (a loss of the global batch
    from the per-rank means)."""
    if mesh is None or not values:
        return dict(values)
    keys = list(values)
    flat = torch.stack([values[k].detach().to(torch.float32) for k in keys])
    dist.all_reduce(flat, group=mesh.data_group)
    flat.div_(mesh.dp)
    return dict(zip(keys, flat.unbind()))


def any_rank(flag: bool, mesh: Optional[Mesh]) -> bool:
    """Whether ``flag`` is set on any rank (a MAX all-reduce)."""
    if mesh is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
