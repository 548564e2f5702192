"""Training on a (data, fsdp) mesh of processes launched by torchrun
(``mesh.py``)."""

from mudiff_torch.parallel.mesh import (
    Mesh,
    any_rank,
    average_grads,
    average_scalars,
    data_mesh,
    gather_rows,
    gather_shards,
    init_mesh,
    mesh_shape,
    param_spec,
    reduce_scatter_grads,
    rows_of,
    shard,
)

__all__ = ["Mesh", "any_rank", "average_grads", "average_scalars", "data_mesh",
           "gather_rows", "gather_shards", "init_mesh", "mesh_shape", "param_spec",
           "reduce_scatter_grads", "rows_of", "shard"]
