"""The device mesh over the ranks of a run, and its sharding helpers.

Counterpart of `rails_tpu/core/mesh.py`: `make_mesh` (:29-71), `batch_axes`
(:74-79), `shard_batch` (:96-99) and `replicate` (:102-104). The mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the run's processes, one per
GPU, with the axes `(slice, data, item)` in that order (rank-major, `item`
fastest) or `(data, item)` with one slice:
  - `slice` and `data` shard the batch: each rank computes its rows, and the
    gradients sum over the batch group (`batch_group`);
  - `item` shards the corpus: each rank holds one slab of the item tables,
    and the per-shard top-k lists merge over the item group (`item_group`).
JAX's `NamedSharding` helpers become the mesh's process groups: a tensor a
rank holds is its shard, and `replicate` broadcasts rank 0's copy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from rails_tpu_torch.core import distributed
from rails_tpu_torch.core.config import MeshConfig

SLICE_AXIS = "slice"
DATA_AXIS = "data"
ITEM_AXIS = "item"

_BATCH_GROUPS: Dict[int, dist.ProcessGroup] = {}


def make_mesh(cfg: Optional[MeshConfig] = None) -> DeviceMesh:
    """The run's mesh: `num_slices` x `data_parallel` x `item_parallel`
    ranks, `data_parallel` -1 taking what the others leave. Every rank calls
    it (it makes the axes' process groups); `core.distributed.initialize`
    runs first."""
    cfg = cfg or MeshConfig()
    if (cfg.slice_axis, cfg.data_axis, cfg.item_axis) != (SLICE_AXIS, DATA_AXIS, ITEM_AXIS):
        raise ValueError("custom mesh axis names are not supported: every sharding helper "
                         f"keys on ({SLICE_AXIS!r}, {DATA_AXIS!r}, {ITEM_AXIS!r})")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "rails_tpu_torch.core.distributed.initialize() first")
    n = dist.get_world_size()
    item = max(1, cfg.item_parallel)
    slices = max(1, cfg.num_slices)
    data = cfg.data_parallel if cfg.data_parallel > 0 else n // (item * slices)
    if data * item * slices != n:
        raise ValueError(f"mesh {slices}x{data}x{item} does not cover {n} processes; set "
                         "MeshConfig.num_slices/data_parallel/item_parallel to factor the "
                         "process count")
    device_type = distributed.device().type
    if slices > 1:
        return init_device_mesh(device_type, (slices, data, item),
                                mesh_dim_names=(SLICE_AXIS, DATA_AXIS, ITEM_AXIS))
    return init_device_mesh(device_type, (data, item), mesh_dim_names=(DATA_AXIS, ITEM_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on `axis` (0 on an axis the mesh lacks)."""
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def batch_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The axes the batch shards over: (slice, data) on a multi-slice mesh,
    (data,) otherwise."""
    if SLICE_AXIS in mesh.mesh_dim_names:
        return (SLICE_AXIS, DATA_AXIS)
    return (DATA_AXIS,)


def batch_size(mesh: DeviceMesh) -> int:
    """How many ranks' row blocks make the global batch."""
    return axis_size(mesh, SLICE_AXIS) * axis_size(mesh, DATA_AXIS)


def batch_rank(mesh: DeviceMesh) -> int:
    """This rank's row block in the global batch: slice-major, then data."""
    return axis_index(mesh, SLICE_AXIS) * axis_size(mesh, DATA_AXIS) + axis_index(mesh, DATA_AXIS)


def batch_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The process group the gradients sum over: the ranks of this rank's
    item coordinate along the batch axes. On a multi-slice mesh the first
    call on every rank makes the (slice, data) groups, as a collective."""
    if SLICE_AXIS not in mesh.mesh_dim_names:
        return mesh.get_group(DATA_AXIS)
    key = id(mesh)
    if key not in _BATCH_GROUPS:
        ranks = mesh.mesh.reshape(-1, axis_size(mesh, ITEM_AXIS))
        for col in range(ranks.shape[1]):
            g = dist.new_group(ranks[:, col].tolist())
            if col == axis_index(mesh, ITEM_AXIS):
                _BATCH_GROUPS[key] = g
    return _BATCH_GROUPS[key]


def item_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The process group of this rank's corpus shards (the `item` axis)."""
    return mesh.get_group(ITEM_AXIS)


def shard_batch(batch, mesh: DeviceMesh):
    """This rank's rows of a global batch (every rank holds the whole batch),
    on the rank's device: block `batch_rank` of `batch_size` equal blocks."""
    n = batch_size(mesh)
    i = batch_rank(mesh)

    def rows(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.shape[0] % n:
            raise ValueError(f"a batch of {t.shape[0]} rows does not split over {n} ranks")
        b = t.shape[0] // n
        return t[i * b : (i + 1) * b].to(distributed.device())

    return _tree_map(rows, batch)


def replicate(tree, mesh: Optional[DeviceMesh] = None):
    """Rank 0's copy of every tensor of `tree` (a module's parameters and
    buffers, or a tensor tree) on every rank, broadcast in a fixed order
    over the whole run; returns `tree`."""
    if dist.get_world_size() == 1:
        return tree
    tensors = (list(tree.parameters()) + list(tree.buffers()) if isinstance(tree, torch.nn.Module)
               else _leaves(tree))
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src=0)
    return tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    out = []
    _tree_map(lambda t: out.append(t) if isinstance(t, torch.Tensor) else None, tree)
    return out
