"""Top-k over an item-sharded corpus: each rank scores its slab, one
all-gather merges.

Counterpart of `rails_tpu/index/sharded.py`: `pad_and_shard_state`
(:38-120), `_merge_local_topk` (:122-130) and `make_sharded_top_k_fn`
(:132-324) for every method it accepts. The corpus pads to a multiple of
`shards * fused_block_x` (256, the kernels' tile) when the state carries
kernel-layout tables, of `shards` otherwise, and rank i of the mesh's `item`
axis keeps slab i: the slab boundaries are JAX's, so each shard's
approximate method sees what JAX's shard sees. Pad rows carry id 0 and zero
tables (int8 pad scales 1) and score NEG_PAD before any local select; a
zero-length table (the `fused_only` sentinel) stays zero-length, since a
padded one would flip the methods' layout dispatch. `build_shard_state`
builds a rank's `fused_only` slab directly, for a corpus that no one card or
host holds whole.

Each rank runs the single-device method on its slab with its budgets
capped at the slab's size (K1 to encode, K2 with its tile maxima, K8, K9 and
K10 as the method needs), masks its pad rows, pads its list to k columns,
and all-gathers the (B, k) lists over the item group in rank order; every
rank takes the top k of the same gathered lists, so every rank returns the
same merged list. Brute force is exact; each approximate method spends its
full budget on every shard, so its recall is at least the single-device
method's at the same per-shard budget.

Where the port differs: `MoLBruteForceTopKFusedApprox` selects exactly
(torch has no approximate select; JAX's `approx_max_k` runs only on a TPU),
and the merge's `torch.topk` may break a tie between equal scores to another
column than `lax.top_k`'s lowest-index rule.
"""

from __future__ import annotations

import re
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rails_tpu_torch.core import distributed
from rails_tpu_torch.core.mesh import ITEM_AXIS, axis_index, axis_size, item_group
from rails_tpu_torch.index import top_k as tk
from rails_tpu_torch.index.factory import parse_top_k_budgets
from rails_tpu_torch.index.ivf import IVFIndex, mol_ivf_top_k
from rails_tpu_torch.ops.mol_scoring import BLOCK_X, FusedCorpusTables
from rails_tpu_torch.similarity.mol import MoLItemTables

_FUSED = ("MoLBruteForceTopKFused", "MoLBruteForceTopKFusedApprox",
          "MoLBruteForceTopKFusedInt8", "MoLBruteForceTopKFusedInt8Approx")


def shard_unit(state: tk.MoLTopKState, shards: int) -> int:
    """The corpus pads to a multiple of this (`sharded.py:50-53`): shards
    times the kernels' BLOCK_X-item tile when the state carries
    kernel-layout tables (JAX's default `fused_block_x`), shards otherwise."""
    return shards * BLOCK_X if state.fused_tables is not None else shards


def _slab(t, axis: int, lo: int, hi: int, dev: torch.device, fill: float = 0.0):
    """Columns [lo, hi) of `t` (a tensor or a numpy array) along `axis` on
    `dev`, the part past its end filled with `fill`; only the slab moves."""
    if t is None:
        return None
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(t)
    n = t.shape[axis]
    # A copy of the slab, contiguous as the kernels read it.
    part = t.narrow(axis, min(lo, n), max(0, min(hi, n) - lo)).to(dev).contiguous()
    short = (hi - lo) - part.shape[axis]
    if short == 0:
        return part
    shape = list(part.shape)
    shape[axis] = short
    return torch.cat([part, torch.full(shape, fill, dtype=part.dtype, device=dev)], dim=axis)


def slab_span(num_items: int, unit: int, shards: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of slab `index` of `shards` equal slabs of `num_items`
    padded to a multiple of `unit`; hi may pass `num_items`."""
    per = (num_items + (-num_items) % unit) // shards
    return index * per, (index + 1) * per


def pad_and_shard_state(state: tk.MoLTopKState, mesh) -> tk.MoLTopKState:
    """This rank's slab of a corpus state (host numpy, CPU or card tensors)
    on the rank's device: slab `item` index of `item` equal slabs of the
    corpus padded to `shard_unit`. Only the slab is copied to the device. A
    stacked IVF index (`ivf.build_sharded_ivf`) contributes this rank's
    index."""
    s = axis_size(mesh, ITEM_AXIS)
    si = axis_index(mesh, ITEM_AXIS)
    dev = distributed.device()
    lo, hi = slab_span(int(state.item_ids.shape[0]), shard_unit(state, s), s, si)

    def rows(t, fill=0.0):
        if t is None:
            return None
        if t.shape[0] == 0:   # the fused_only sentinel stays zero-length
            return (torch.from_numpy(t) if isinstance(t, np.ndarray) else t).to(dev)
        return _slab(t, 0, lo, hi, dev, fill)

    fused = None
    if state.fused_tables is not None:
        ft = state.fused_tables
        fused = FusedCorpusTables(
            item_comp_t=_slab(ft.item_comp_t, 2, lo, hi, dev),
            item_partial_t=_slab(ft.item_partial_t, 1, lo, hi, dev),
            num_items=ft.num_items,
            comp_scale=_slab(ft.comp_scale, 1, lo, hi, dev, 1.0),
            partial_scale=_slab(ft.partial_scale, 1, lo, hi, dev, 1.0),
        )
    ivf = None
    if state.ivf is not None:
        if state.ivf.centroids.ndim != 3:
            raise ValueError("sharded states need a stacked per-shard IVF index; build it with "
                             "rails_tpu_torch.index.ivf.build_sharded_ivf(state, num_shards)")
        ivf = IVFIndex(*(None if a is None else torch.as_tensor(a[si]).to(dev)
                         for a in state.ivf))
    it = state.item_tables
    return tk.MoLTopKState(
        item_ids=rows(state.item_ids),
        item_tables=MoLItemTables(component_embeddings=rows(it.component_embeddings),
                                  gating_partial=rows(it.gating_partial)),
        avg_component=rows(state.avg_component),
        fused_tables=fused,
        ivf=ivf,
    )


def build_shard_state(
    model,
    num_items: int,
    embed_chunk_fn: Callable[[int, torch.Tensor], torch.Tensor],  # (start, ids) -> (C, D)
    mesh,
    quantize: bool = False,
    chunk_size: int = tk.BUILD_CHUNK,
    table_dtype: torch.dtype = torch.bfloat16,
) -> tk.MoLTopKState:
    """This rank's slab of the `fused_only` corpus of items 1..num_items,
    built on the rank's device: what `pad_and_shard_state` cuts from
    `build_fused_state_chunked_on_device`'s whole build (int8 pad scales
    aside, which no select reads), with only the chunks that meet the slab
    run. So no rank, and no host, holds more of the corpus than its slab:
    the port's counterpart of JAX's host-staged build sliced by
    `pad_and_shard_state` (`shard_bench.py:187-197`)."""
    s = axis_size(mesh, ITEM_AXIS)
    span = slab_span(num_items, s * BLOCK_X, s, axis_index(mesh, ITEM_AXIS))
    ids = torch.arange(1, num_items + 1, dtype=torch.int32, device=distributed.device())
    return tk.build_fused_state_chunked_on_device(model, ids, embed_chunk_fn, chunk_size,
                                                  table_dtype, quantize=quantize, span=span)


def _merge_local_topk(scores: torch.Tensor, ids: torch.Tensor, k: int,
                      group: Optional[dist.ProcessGroup]) -> tk.TopKResult:
    """All-gather the shards' (B, k) lists over `group` in rank order, then
    the top k of the (B, S * k) columns (`sharded.py:122-130`)."""
    if group is not None and dist.get_world_size(group) > 1:
        n = dist.get_world_size(group)
        gs = [torch.empty_like(scores) for _ in range(n)]
        gi = [torch.empty_like(ids) for _ in range(n)]
        dist.all_gather(gs, scores.contiguous(), group=group)
        dist.all_gather(gi, ids.contiguous(), group=group)
        scores, ids = torch.cat(gs, dim=1), torch.cat(gi, dim=1)
    top, pos = torch.topk(scores, k, dim=1)
    return tk.TopKResult(scores=top, ids=ids.gather(1, pos))


def local_top_k(
    top_k_method: str, model, state_l: tk.MoLTopKState, q: torch.Tensor, k: int,
    user_ids: Optional[torch.Tensor], k_per_group: int, avg_top_k: int, budgets: dict,
) -> tk.TopKResult:
    """One shard's list: the single-device method on the slab, its budgets
    capped at the slab's size (`sharded.py:164-266`)."""
    x_local = int(state_l.item_ids.shape[0])
    k_local = min(k, x_local)
    if top_k_method in _FUSED:
        if state_l.fused_tables is None:
            raise ValueError("pad_and_shard_state needs fused tables for " + top_k_method)
        return tk.mol_brute_force_top_k_fused(model, state_l, q, k_local, user_ids)
    if top_k_method == "MoLBruteForceTopK":
        return tk.mol_brute_force_top_k(model, state_l, q, k_local, user_ids)
    if top_k_method.startswith("MoLNaive"):
        return tk.mol_naive_top_k(model, state_l, q, k_local, min(k_per_group, x_local), user_ids)
    if top_k_method.startswith("MoLAvg"):
        return tk.mol_avg_top_k(model, state_l, q, k_local, min(avg_top_k, x_local), user_ids)
    if top_k_method.startswith("MoLComb"):
        return tk.mol_comb_top_k(model, state_l, q, k_local, min(avg_top_k, x_local),
                                 min(k_per_group, x_local), user_ids)
    if top_k_method.startswith("MoLCertTopK"):
        return tk.mol_certified_top_k(model, state_l, q, k_local,
                                      min(budgets["cand_budget"], x_local), user_ids)[0]
    if top_k_method.startswith("MoLTileTopK"):
        return tk.mol_tile_top_k_shared(model, state_l, q, k_local, budgets["tiles_per_group"],
                                        user_ids, tile_budget=budgets.get("tile_budget"))
    if top_k_method.startswith("MoLIVF"):
        m = re.fullmatch(r"MoLIVFTopK(\d+)", top_k_method)
        if m is None:
            raise ValueError(f"bad IVF method spelling {top_k_method!r}")
        if state_l.ivf is None:
            raise ValueError("sharded IVF needs build_sharded_ivf attached to the state")
        return mol_ivf_top_k(model, state_l, q, k_local, nprobe=int(m.group(1)),
                             user_ids=user_ids)
    raise ValueError(f"Unknown top_k_method {top_k_method!r}")


def make_sharded_top_k_fn(
    top_k_method: str,
    model,
    state: tk.MoLTopKState,       # this rank's slab, from pad_and_shard_state
    mesh,
    k: int,
    k_per_group: int = 50,
    avg_top_k: int = 200,
) -> Callable:
    """fn(query_embeddings, user_ids=None) -> TopKResult, the same merged
    (B, k) list on every rank of the item group. Every rank passes the same
    queries. Budgets in the method's name (MoLNaiveTopK100, MoLAvgTopK800,
    MoLCombTopK50_500, MoLCertTopK4096, MoLTileTopK8) take precedence over
    `k_per_group` / `avg_top_k`, as in the unsharded factory. The model's
    weights score the queries; the slab's tables are as built."""
    budgets = parse_top_k_budgets(top_k_method)
    k_per_group = budgets.get("k_per_group", k_per_group)
    avg_top_k = budgets.get("avg_top_k", avg_top_k)
    group = item_group(mesh)

    @torch.inference_mode()
    def fn(query_embeddings: torch.Tensor, user_ids: Optional[torch.Tensor] = None
           ) -> tk.TopKResult:
        res = local_top_k(top_k_method, model, state, query_embeddings, k, user_ids,
                          k_per_group, avg_top_k, budgets)
        # Mask pad rows (id 0), then pad the list to k columns so every
        # shard's list has one shape.
        scores = torch.where(res.ids == 0, tk.NEG_PAD, res.scores.float())
        ids = res.ids
        if scores.shape[1] < k:
            pad = k - scores.shape[1]
            scores = torch.nn.functional.pad(scores, (0, pad), value=tk.NEG_PAD)
            ids = torch.nn.functional.pad(ids, (0, pad))
        return _merge_local_topk(scores, ids, k, group)

    return fn
