"""Multi-process execution: one process per GPU on `torch.distributed`.

Counterpart of `rails_tpu/core/distributed.py`: `initialize` (:26-56, same
arguments), `process_count`, `process_index`, `is_primary` (:59-70),
`make_global_batch` (:73-93), `fetch_replicated` (:96-112) and
`all_reduce_mean_metrics` (:115-134). JAX runs one controller per host and
one global program; the port runs one process per GPU, and a collective
joins them where JAX's partitioner inserts one.

The backend is explicit: `nccl` for a CUDA rank device and `gloo` for a CPU
one, unless the caller names it. `gloo` also takes CUDA tensors (it stages
them through the host), which is how several ranks share one card in
`chip_smoke.py`. Nothing switches backend, or moves work to the CPU, when
NCCL or CUDA is missing or fails. Each rank's device is `cuda:{LOCAL_RANK}`
unless the caller names one.

A data-parallel rank computes its rows of the global batch under a
`RowShard` (`row_shard`): every random draw whose leading axis runs over the
batch's rows draws the global batch's shape from the generator every rank
shares and keeps this rank's rows (`draw_rows`), the losses divide by the
global batch's weights (`global_sum`), and the hash dropout streams number a
row by its index in the global batch (`row_span`). The leading-axis
lengths that run over the rows are named where the batch enters
(`RowShard.per_row`); a tensor that every rank holds whole is marked
`replicated_rows()`, and any other length raises. So a step over the ranks'
rows computes what one process computes over the global batch, up to the
order of the sums. `run_ranks` starts ranks on one host and joins them
with a time limit.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from rails_tpu_torch.core.device import require_cuda

Device = Union[str, torch.device, None]

_device: Optional[torch.device] = None
_store_dir: Optional[tempfile.TemporaryDirectory] = None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def rank_device(device: Device = None) -> torch.device:
    """`device`, or this rank's card `cuda:{LOCAL_RANK}` (LOCAL_RANK 0 when
    unset) when it is None."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", _env_int("LOCAL_RANK") or 0)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Device = None,
) -> bool:
    """Join this process to the run's process group (idempotent) and return
    whether the run has more than one process.

    `coordinator_address` is a `torch.distributed` init method
    (`tcp://host:port`, `file:///path`) or a bare `host:port`. With none of
    the three arguments, torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) names the group; without that environment the
    run is one process, and a one-rank group over a store in a temporary
    directory is made, so the mesh and every collective run unchanged.
    `backend` defaults to nccl for a CUDA `device` and gloo for a CPU one;
    `device` defaults to `cuda:{LOCAL_RANK}`."""
    global _device, _store_dir
    dev = rank_device(device)
    if dist.is_initialized():
        _device = _device or dev
        return dist.get_world_size() > 1
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        require_cuda()
        torch.cuda.set_device(dev)
    if coordinator_address is None and num_processes is None and process_id is None:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            init_method = "env://"
            num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        else:
            _store_dir = tempfile.TemporaryDirectory(prefix="rails_store_")
            init_method = f"file://{os.path.join(_store_dir.name, 'store')}"
            num_processes, process_id = 1, 0
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("coordinator_address, num_processes and process_id go together")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    _device = dev
    return num_processes > 1


def shutdown() -> None:
    """Leave the process group (every rank calls it)."""
    global _device, _store_dir
    if dist.is_initialized():
        dist.destroy_process_group()
    if _store_dir is not None:
        _store_dir.cleanup()
    _device, _store_dir = None, None


def device() -> torch.device:
    """This rank's device, as `initialize` set it."""
    if _device is None:
        raise RuntimeError("core.distributed.initialize() has not run in this process")
    return _device


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns logging and checkpoints (rank 0)."""
    return process_index() == 0


def collective_device() -> torch.device:
    """Where a collective's buffers live: the rank's device for nccl, which
    takes only CUDA tensors, and the CPU for gloo's host-side values."""
    return device() if dist.get_backend() == "nccl" else torch.device("cpu")


class RowShard(NamedTuple):
    """This rank's rows of a global batch of `total` rows: rows
    [offset, offset + rows), summed over `group`. `per_row` names, where
    the batch enters, the tensors that run over its rows: those whose
    leading axis is `rows` times one of these (1, a row each; N - 1 for
    sequences of N, a scored position each)."""

    offset: int
    rows: int
    total: int
    group: Optional[dist.ProcessGroup] = None
    per_row: Tuple[int, ...] = (1,)


_ROW_SHARD: Optional[RowShard] = None
_REPLICATED_DEPTH = 0


@contextlib.contextmanager
def row_shard(shard: Optional[RowShard]) -> Iterator[None]:
    """Run the body as rows [offset, offset + rows) of the global batch
    (None: the whole batch)."""
    global _ROW_SHARD
    prev, _ROW_SHARD = _ROW_SHARD, shard
    try:
        yield
    finally:
        _ROW_SHARD = prev


@contextlib.contextmanager
def replicated_rows() -> Iterator[None]:
    """A region whose tensors every rank holds whole (the shared negatives'
    item side): its draws take no rows."""
    global _REPLICATED_DEPTH
    _REPLICATED_DEPTH += 1
    try:
        yield
    finally:
        _REPLICATED_DEPTH -= 1


def current_row_shard() -> Optional[RowShard]:
    return None if _REPLICATED_DEPTH else _ROW_SHARD


def row_span(n: int) -> Tuple[int, int]:
    """(offset, total) of a leading axis of `n` local rows, `rows` times one
    of the row shard's `per_row` factors: (0, n) outside a row shard. Any
    other length raises, a multiple of the rows too: a tensor that every
    rank holds whole must be marked with `replicated_rows()`, never sliced
    because its length happens to divide."""
    s = current_row_shard()
    if s is None:
        return 0, n
    f = n // s.rows
    if n % s.rows or f not in s.per_row:
        raise ValueError(f"a leading axis of {n} rows is not {s.per_row} times this rank's "
                         f"{s.rows} batch rows; mark replicated tensors with replicated_rows()")
    return s.offset * f, s.total * f


def draw_rows(draw: Callable[[Tuple[int, ...]], torch.Tensor], shape: Sequence[int]):
    """`draw(shape)`, or inside a row shard this rank's rows of
    `draw(global shape)` (of each tensor, where it returns a tuple): every
    rank advances the shared generator as one process over the global batch
    would."""
    shape = tuple(int(v) for v in shape)
    off, tot = row_span(shape[0])
    if tot == shape[0]:
        return draw(shape)
    out = draw((tot,) + shape[1:])
    if isinstance(out, tuple):
        return tuple(t[off : off + shape[0]] for t in out)
    return out[off : off + shape[0]]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the row shard's ranks of a tensor that carries no
    gradient (a loss's weights); `t` itself outside a row shard."""
    s = current_row_shard()
    if s is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=s.group)
    return out


def global_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """The sum over the row shard's ranks, differentiable: the backward sums
    the ranks' gradients, so a term nonlinear in a global mean (the MI
    loss's utilisation entropy) back-propagates into every rank's rows."""
    s = current_row_shard()
    if s is None:
        return t
    return _SumOverRanks.apply(t, s.group)


class _SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) whose backward is all_reduce(SUM) of the gradient."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = t.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.detach().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def rank_share() -> float:
    """1 / the row shard's rank count: a rank's share of a term that every
    rank computes whole (1 outside a row shard)."""
    s = current_row_shard()
    return 1.0 if s is None else 1.0 / dist.get_world_size(s.group)


def make_global_batch(batch, mesh):
    """This rank's local batch on its device and its `RowShard` of the
    global batch: rows [i * b, (i + 1) * b) for this rank's index i on the
    mesh's batch axes, each rank contributing b rows, as JAX's process-local
    data makes one global array (`distributed.py:73-93`)."""
    from rails_tpu_torch.core.mesh import batch_group, batch_rank, batch_size

    local = tree_to(batch, device())
    b, n = (int(v) for v in local.features.ids.shape)
    return local, RowShard(batch_rank(mesh) * b, b, batch_size(mesh) * b, batch_group(mesh),
                           (1, n - 1))


def tree_to(tree, dev: torch.device):
    """Every tensor of a (named)tuple, list or dict tree moved to `dev`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_to(v, dev) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, dev) for v in tree)
    return tree


def fetch_replicated(tree):
    """Tensors of a (nested dict, list or tuple) tree as host numpy arrays:
    the ranks' replicated parameters for host-side use."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: fetch_replicated(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(fetch_replicated(v) for v in tree)
    return tree


def all_reduce_mean_metrics(metrics: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Mean of per-example metric vectors over every process: one all-reduce
    of each metric's [sum, count] in float64 (`_avg`, the reference's
    `data/eval.py:271-275`); a plain mean in a single process."""
    keys = sorted(metrics)
    local = np.array([[float(np.sum(np.asarray(metrics[k], np.float64))),
                       float(np.size(metrics[k]))] for k in keys], np.float64).reshape(-1, 2)
    if process_count() > 1:
        t = torch.from_numpy(local).to(collective_device())
        dist.all_reduce(t)
        local = t.cpu().numpy()
    return {k: float(s / c) if c else float("nan") for k, (s, c) in zip(keys, local)}


def run_ranks(fn: Callable, world_size: int, args: tuple = (), timeout: float = 600.0) -> None:
    """Run fn(rank, *args) in `world_size` spawned processes and join them
    within `timeout` seconds. The first rank to fail, by an exception or a
    non-zero exit, ends the others, and its error (with its traceback)
    raises here; a run past the limit ends every rank and raises
    TimeoutError. `fn` must be importable by name (a module-level
    function)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=world_size, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, min(2.0, deadline - time.monotonic()))):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{world_size} ranks of {fn.__name__} did not finish "
                               f"within {timeout} s")
