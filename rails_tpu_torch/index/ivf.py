"""IVF (inverted-file) approximate top-k over a MoL corpus.

Counterpart of `rails_tpu/index/ivf.py`: `IVFIndex` (:49-69), the k-means++
seeding `_kmeanspp_init` (:76-122), Lloyd's `kmeans` with its empty-cluster
split (:125-221), `assign_choices` and the host-side `_balanced_fill`
(:224-300), the per-cluster MoL means `_mol_cluster_means` (:303-408),
`build_ivf_index` with its cluster-order permutation (:411-497), and the
query path `ivf_candidates` and `mol_ivf_top_k` (:500-613). Plain torch: the
JAX module is XLA, no Pallas kernel, and so is this one; the rerank is the
shared exact-MoL dedup tail (`top_k.dedup_rerank_top_k`).

Where the port differs:
- random draws: the seeding draws from a `torch.Generator` seeded by `seed`
  (JAX's `jax.random` bits cannot be reproduced); the Lloyd iterations from
  equal initial centroids agree with JAX's;
- per-cluster sums: a (chunk, nlist) one-hot matrix times the chunk, as
  JAX's k-means sums, for the MoL means too (JAX there uses `segment_sum`):
  on the card a float `index_add_` sums in another order on every run, and
  the one-hot product does not;
- the last chunk is a shorter slice, where JAX re-covers the tail with a
  clamped slice and masks the re-covered rows;
- the fused gating rows are already in the model's n-major logit order, so
  the MoL means need no inverse of JAX's m-major permutation (:404-407);
- the rerank's query-batch split is a Python loop: JAX's optimization
  barrier between the sub-batches is a TPU scheduling workaround.

`build_sharded_ivf` (:616-725) builds one index per corpus slab of
`index/sharded.py`, with slab-local positions, stacked on a leading shard
axis and padded to the largest shard's lists; one shard indexes the corpus
in place with the MoL-aware probes, several shards without them, as in JAX.
`build_rank_ivf` builds one rank's index of that stack from the rank's own
slab (`sharded.build_shard_state`), which is all a rank holds of a corpus
larger than one card.

Invariants (tests/test_torch_port_ivf.py, and `[ivf]` of chip_smoke.py on
the card): every real corpus position appears exactly once across buckets
and overflow; probing every list reproduces brute force; empty bucket slots
point at position 0, a real item the rerank's dedup collapses.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rails_tpu_torch.index import top_k as tk
from rails_tpu_torch.similarity.mol import MoLItemTables


class IVFIndex(NamedTuple):
    """Inverted-file index over corpus positions, on the state's device.

    `buckets[c]` holds the positions assigned to cluster c, slots past its
    fill pointing at position 0; `overflow` holds the positions that found
    room in none of their top-R clusters and is appended to every query's
    candidates. With `comp_centroids`, lists rank by the exact MoL score of
    each cluster's mean member tables (n-major gating) instead of the
    summed-component dot product."""

    centroids: torch.Tensor    # (nlist, d) f32
    buckets: torch.Tensor      # (nlist, cap) int32 corpus positions
    overflow: torch.Tensor     # (O,) int32 corpus positions, O a multiple of 8
    comp_centroids: Optional[torch.Tensor] = None     # (nlist, P_X, d_P) f32
    gating_centroids: Optional[torch.Tensor] = None   # (nlist, L) f32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _kmeanspp_init(
    data: torch.Tensor, nlist: int, generator: torch.Generator, sample_factor: int = 16,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """k-means++ seeding on a subsample of S = max(16 nlist, 1024) rows
    (`ivf.py:76-122`): each step samples the next seed proportionally to its
    squared distance from the nearest seed, by the Gumbel-argmax trick."""
    x, d = data.shape
    s = min(x, max(sample_factor * nlist, 1024))
    dev = data.device
    if valid is not None:
        p = valid.float()
        n_valid = int(p.sum().item())
        pos = torch.multinomial(p, s, replacement=s >= n_valid, generator=generator)
    elif s < x:
        pos = torch.randperm(x, generator=generator, device=dev)[:s]
    else:
        pos = torch.arange(x, device=dev)
    sample = data[pos].float()
    first = sample[torch.randint(0, s, (), generator=generator, device=dev)]
    seeds = torch.zeros(nlist, d, dtype=torch.float32, device=dev)
    seeds[0] = first
    mind = (sample - first).pow(2).sum(dim=1)
    for i in range(1, nlist):
        u = torch.rand(s, generator=generator, device=dev).clamp_(min=1e-20)
        gumbel = -torch.log(-torch.log(u))
        c = sample[torch.argmax(torch.log(mind + 1e-30) + gumbel)]
        seeds[i] = c
        mind = torch.minimum(mind, (sample - c).pow(2).sum(dim=1))
    return seeds


def _cluster_sums(assign: torch.Tensor, rows: torch.Tensor, nlist: int,
                  weight: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sums (nlist, d) and counts (nlist,) of f32 `rows` by
    cluster id `assign` (ids outside [0, nlist) count nowhere), through a
    one-hot product: the same sums on every run, on the card too."""
    onehot = (assign[:, None] == torch.arange(nlist, device=assign.device)).float()
    if weight is not None:
        onehot = onehot * weight[:, None]
    return onehot.T @ rows, onehot.sum(dim=0)


def _lloyd_step(cent: torch.Tensor, data: torch.Tensor, valid: Optional[torch.Tensor],
                chunk: int) -> torch.Tensor:
    """One Lloyd iteration with the empty-cluster split (`ivf.py:162-217`):
    the i-th empty cluster takes the i-th most populated non-empty cluster's
    centroid times (1 + eps), and that donor shrinks by (1 - eps) once for
    every empty cluster it serves."""
    x, d = data.shape
    nlist = cent.shape[0]
    half_norm = 0.5 * (cent * cent).sum(dim=1)
    sums = torch.zeros(nlist, d, dtype=torch.float32, device=cent.device)
    counts = torch.zeros(nlist, dtype=torch.float32, device=cent.device)
    for start in range(0, x, chunk):
        blk = data[start : start + chunk].float()
        assign = torch.argmax(blk @ cent.T - half_norm, dim=1)
        w = None if valid is None else valid[start : start + chunk].float()
        s, c = _cluster_sums(assign, blk, nlist, w)
        sums += s
        counts += c
    new = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None], cent)
    empty = counts == 0
    eps = 1.0 / 1024.0
    donors = torch.argsort(-counts, stable=True)
    erank = torch.cumsum(empty.to(torch.int64), dim=0) - 1
    num_nonempty = torch.clamp((~empty).sum(), min=1)
    donor_of = donors[erank % num_nonempty]
    stolen = new[donor_of] * (1.0 + eps)
    # A donor shared by h empty clusters is multiplied h times, in turn, as
    # JAX's scatter-multiply does.
    hits = torch.zeros(nlist, dtype=torch.int64, device=cent.device).index_add_(
        0, donor_of[empty], torch.ones_like(donor_of[empty]))
    for j in range(int(hits.max().item())):
        new = torch.where((hits > j)[:, None], new * (1.0 - eps), new)
    return torch.where(empty[:, None], stolen, new)


@torch.inference_mode()
def kmeans(
    data: torch.Tensor,                      # (X, d) any float dtype
    nlist: int,
    num_iters: int = 10,
    seed: int = 0,
    chunk: int = 65_536,
    valid: Optional[torch.Tensor] = None,    # (X,) bool; None = all valid
) -> torch.Tensor:
    """L2 Lloyd's k-means on `data`'s device; (min(nlist, X), d) f32
    centroids. The corpus streams in `chunk`-row blocks: per block one
    (C, d) x (d, nlist) product picks the nearest centroid (argmax of x.c -
    |c|^2 / 2) and a one-hot product sums the clusters; `valid=False` rows
    count nowhere."""
    x = data.shape[0]
    nlist = min(nlist, x)
    gen = torch.Generator(device=data.device).manual_seed(seed)
    centroids = _kmeanspp_init(data, nlist, gen, valid=valid)
    for _ in range(num_iters):
        centroids = _lloyd_step(centroids, data, valid, min(chunk, x))
    return centroids


@torch.inference_mode()
def assign_choices(
    data: torch.Tensor,           # (X, d)
    centroids: torch.Tensor,      # (nlist, d) f32
    num_choices: int,
    chunk: int = 65_536,
) -> Tuple[np.ndarray, np.ndarray]:
    """Each item's `num_choices` nearest clusters, nearest first, and their
    |c|^2/2-shifted inner products, as host arrays ((X, R) int32, (X, R)
    f32). Equal similarities may rank in another order than JAX's
    `lax.top_k`, which puts the lower cluster first."""
    r = min(num_choices, centroids.shape[0])
    half_norm = 0.5 * (centroids * centroids).sum(dim=1)
    vals, idxs = [], []
    for start in range(0, data.shape[0], chunk):
        v, i = torch.topk(data[start : start + chunk].float() @ centroids.T - half_norm, r, dim=1)
        vals.append(v)
        idxs.append(i.to(torch.int32))
    return torch.cat(idxs).cpu().numpy(), torch.cat(vals).cpu().numpy()


def _balanced_fill(
    choices: np.ndarray,         # (X, R) ranked cluster ids
    sims: np.ndarray,            # (X, R) matching similarities
    nlist: int,
    cap: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Assign each item to its best-ranked cluster with room (`ivf.py:
    258-300`, host numpy, copied as it is). Rounds over the choice rank:
    within a round, closer items win contested slots. Returns (bucket_of (X,)
    int32 with -1 for overflow, buckets (nlist, cap) int32 padded with 0,
    overflow positions (O,) int32)."""
    x, r = choices.shape
    bucket_of = np.full(x, -1, np.int32)
    space = np.full(nlist, cap, np.int64)
    remaining = np.ones(x, bool)
    for rank in range(r):
        idx = np.nonzero(remaining)[0]
        if idx.size == 0:
            break
        c = choices[idx, rank].astype(np.int64)
        order = np.lexsort((-sims[idx, rank], c))    # cluster-major, closest first
        cs = c[order]
        first = np.searchsorted(cs, np.arange(nlist))
        within = np.arange(cs.size) - first[cs]
        ok = within < space[cs]
        chosen = idx[order[ok]]
        bucket_of[chosen] = cs[ok].astype(np.int32)
        space -= np.bincount(cs[ok], minlength=nlist)
        remaining[chosen] = False

    assigned = np.nonzero(bucket_of >= 0)[0]
    b = bucket_of[assigned].astype(np.int64)
    order = np.argsort(b, kind="stable")
    bs = b[order]
    pos = assigned[order]
    first = np.searchsorted(bs, np.arange(nlist))
    within = np.arange(bs.size) - first[bs]
    buckets = np.zeros((nlist, cap), np.int32)
    buckets[bs, within] = pos
    overflow = np.nonzero(remaining)[0].astype(np.int32)
    return bucket_of, buckets, overflow


@torch.inference_mode()
def _mol_cluster_means(
    state, assign_full: np.ndarray, nlist: int, chunk: int = 65_536,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-cluster means of the member items' component (nlist, P_X, d_P)
    and gating (nlist, L) tables in f32, read chunk by chunk from whichever
    layout the state holds (`ivf.py:303-408`). `assign_full` holds a cluster
    id per corpus position, -1 for excluded rows (pads, overflow); columns
    past it (the kernel layout's pad) count nowhere. int8 columns dequantize
    by their scales."""
    it, ft = state.item_tables, state.fused_tables
    standard = it.component_embeddings.shape[0] > 0
    if standard:
        x, p_x, d_p = it.component_embeddings.shape
        dev = it.component_embeddings.device
    else:
        if ft is None:
            raise ValueError("the state holds neither standard nor fused tables")
        p_x, d_p, x = ft.item_comp_t.shape
        dev = ft.item_comp_t.device
    assign = np.full(x, -1, np.int64)
    assign[: assign_full.shape[0]] = assign_full
    assign = torch.as_tensor(assign, device=dev)
    c_sum = g_sum = cnt = None
    for start in range(0, x, chunk):
        end = min(start + chunk, x)
        if standard:
            comp = it.component_embeddings[start:end].float().reshape(end - start, p_x * d_p)
            gp = None if it.gating_partial is None else it.gating_partial[start:end].float()
        else:
            comp = ft.item_comp_t[:, :, start:end].float()
            gp = ft.item_partial_t[:, start:end].float()
            if ft.comp_scale is not None:
                comp = comp * ft.comp_scale[:, None, start:end]
                gp = gp * ft.partial_scale[:, start:end]
            comp = comp.permute(2, 0, 1).reshape(end - start, p_x * d_p)
            gp = gp.T
        rows = comp if gp is None else torch.cat([comp, gp], dim=1)
        s, c = _cluster_sums(assign[start:end], rows, nlist)
        c_sum = s if c_sum is None else c_sum + s
        cnt = c if cnt is None else cnt + c
    means = c_sum / cnt.clamp(min=1.0)[:, None]
    comp_cent = means[:, : p_x * d_p].reshape(nlist, p_x, d_p)
    g_cent = means[:, p_x * d_p :] if means.shape[1] > p_x * d_p else None
    return comp_cent, g_cent


@torch.inference_mode()
def build_ivf_index(
    avg_component: torch.Tensor,   # (X, d_P): MoLTopKState.avg_component
    item_ids: torch.Tensor,        # (X,) int32; pad rows (id 0) are excluded
    nlist: int,
    num_iters: int = 10,
    cap_factor: float = 2.0,
    num_choices: int = 4,
    seed: int = 0,
    chunk: int = 65_536,
    mol_state=None,                # MoLTopKState: MoL-aware probe centroids
    return_cluster_perm: bool = False,
):
    """k-means over the summed-component table and balanced inverted lists
    (`ivf.py:411-497`), on `avg_component`'s device. Pad rows (id 0) take
    part in neither. cap = round_up(ceil(cap_factor X_real / nlist), 8); the
    overflow list is zero-padded to a multiple of 8. With `mol_state`, the
    per-cluster MoL means rank the probes. With `return_cluster_perm`, also
    the cluster-order permutation (new position -> old position, int64
    numpy): each cluster's members contiguous in their old order, then the
    overflow, then the pad rows."""
    ids_np = item_ids.cpu().numpy()
    real = np.nonzero(ids_np != 0)[0].astype(np.int64)
    x = int(real.size)
    if x == 0:
        raise ValueError("empty corpus")
    nlist = min(nlist, x)
    dev = avg_component.device
    centroids = kmeans(avg_component, nlist, num_iters=num_iters, seed=seed, chunk=chunk,
                       valid=item_ids.to(dev) != 0)
    nlist = int(centroids.shape[0])
    cap = _round_up(max(1, int(np.ceil(cap_factor * x / nlist))), 8)
    choices, sims = assign_choices(avg_component, centroids, num_choices, chunk=chunk)
    bucket_of, buckets, overflow_local = _balanced_fill(choices[real], sims[real], nlist, cap)
    buckets = real[buckets].astype(np.int32)
    overflow = np.zeros(_round_up(overflow_local.size, 8), np.int32)
    overflow[: overflow_local.size] = real[overflow_local]
    comp_cent = gating_cent = None
    if mol_state is not None:
        assign_full = np.full(ids_np.shape[0], -1, np.int32)
        assign_full[real] = bucket_of        # overflow rows stay -1
        comp_cent, gating_cent = _mol_cluster_means(mol_state, assign_full, nlist, chunk=chunk)
    index = IVFIndex(
        centroids=centroids,
        buckets=torch.as_tensor(buckets, device=dev),
        overflow=torch.as_tensor(overflow, device=dev),
        comp_centroids=comp_cent,
        gating_centroids=gating_cent,
    )
    if not return_cluster_perm:
        return index
    xfull = int(ids_np.shape[0])
    order_key = np.full(xfull, nlist + 1, np.int64)          # pad rows last
    order_key[real] = np.where(bucket_of >= 0, bucket_of, nlist)
    return index, np.lexsort((np.arange(xfull), order_key))


def ivf_candidates(
    model, ivf: IVFIndex,
    query_embeddings: torch.Tensor,            # (B, D)
    nprobe: int,
    user_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, nprobe * cap + O) corpus positions of the `nprobe` best lists
    (`ivf.py:500-541`): ranked by the MoL score of the cluster means
    (`score_precomputed`) when the index has them, else by the summed query
    components' dot product with the centroids."""
    nprobe = min(nprobe, ivf.centroids.shape[0])
    if ivf.comp_centroids is not None:
        cscores = model.score_precomputed(
            query_embeddings, MoLItemTables(ivf.comp_centroids, ivf.gating_centroids), user_ids)
    else:
        q_avg = model.query_components(query_embeddings, user_ids).sum(dim=1).float()
        cscores = q_avg @ ivf.centroids.T
    probe = torch.topk(cscores.float(), nprobe, dim=1).indices
    b = probe.shape[0]
    cand = ivf.buckets[probe].reshape(b, -1)
    if ivf.overflow.shape[0]:
        cand = torch.cat([cand, ivf.overflow.expand(b, -1)], dim=1)
    return cand


def mol_ivf_top_k(
    model, state,                              # MoLTopKState with .ivf set
    query_embeddings: torch.Tensor,            # (B, D)
    k: int,
    nprobe: int,
    user_ids: Optional[torch.Tensor] = None,
    cand_chunk: int = 8192,
    pool_budget_bytes: int = 2 << 30,
):
    """`MoLIVFTopK{nprobe}` (`ivf.py:544-613`): probe the `nprobe` best
    lists, exact-MoL rerank of their members `cand_chunk` at a time. Over
    fused tables the query batch splits in halves while the candidate pool's
    table bytes exceed `pool_budget_bytes` (and the batch divides)."""
    if state.ivf is None:
        raise ValueError("MoLTopKState.ivf is not set: build_ivf_index(...) and attach it "
                         "with state._replace(ivf=...)")
    cand = ivf_candidates(model, state.ivf, query_embeddings, nprobe, user_ids)
    b, c = cand.shape
    ft = state.fused_tables
    splits = 1
    if ft is not None:
        m, d, _ = ft.item_comp_t.shape
        l = ft.item_partial_t.shape[0]
        per_bc = m * d * ft.item_comp_t.element_size() + 4 * (l + m + 1)
        pool_bytes = b * c * per_bc
        while splits < b and b % (splits * 2) == 0 and pool_bytes // splits > pool_budget_bytes:
            splits *= 2
    rows = b // splits
    outs = [
        tk.dedup_rerank_top_k(
            model, state, query_embeddings[s : s + rows], cand[s : s + rows], k,
            None if user_ids is None else user_ids[s : s + rows], cand_chunk=cand_chunk)
        for s in range(0, b, rows)
    ]
    if len(outs) == 1:
        return outs[0]
    return tk.TopKResult(scores=torch.cat([r.scores for r in outs]),
                         ids=torch.cat([r.ids for r in outs]))


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _slab_index(avg_l: torch.Tensor, ids_l: torch.Tensor, seed: int, nlist: int,
                num_iters: int, cap_factor: float, num_choices: int, chunk: int) -> IVFIndex:
    """One shard's index over its slab's avg rows and ids (0 for padding),
    without the MoL-aware probes; a slab of pad rows only gets one zero
    list."""
    dev = avg_l.device
    if bool((ids_l != 0).any()):
        return build_ivf_index(avg_l, ids_l, nlist=nlist, num_iters=num_iters,
                               cap_factor=cap_factor, num_choices=num_choices, seed=seed,
                               chunk=chunk)
    return IVFIndex(
        centroids=torch.zeros(min(nlist, 1), avg_l.shape[1], dtype=torch.float32, device=dev),
        buckets=torch.zeros(min(nlist, 1), 8, dtype=torch.int32, device=dev),
        overflow=torch.zeros(0, dtype=torch.int32, device=dev))


def _pad_index(p: IVFIndex, nl: int, cap: int, o: int) -> IVFIndex:
    """`p` with nl lists of cap slots and o overflow slots, the new slots
    pointing at local position 0."""

    def pad(t: torch.Tensor, shape) -> torch.Tensor:
        out = torch.zeros(shape, dtype=t.dtype, device=t.device)
        out[tuple(slice(0, n) for n in t.shape)] = t
        return out

    return IVFIndex(centroids=pad(p.centroids, (nl, p.centroids.shape[1])),
                    buckets=pad(p.buckets, (nl, cap)), overflow=pad(p.overflow, (o,)))


def build_sharded_ivf(
    state: "tk.MoLTopKState",     # the unsharded state, on the host or a device
    num_shards: int,
    nlist: int = 1024,
    num_iters: int = 10,
    cap_factor: float = 2.0,
    num_choices: int = 4,
    seed: int = 0,
    chunk: int = 65_536,
    device=None,
) -> IVFIndex:
    """Per-shard IVF indexes stacked on a leading shard axis
    (`ivf.py:616-725`): shard i indexes its slab of the corpus padded to
    `sharded.shard_unit` with seed `seed + i`, its buckets holding
    slab-local positions; lists, caps and overflow lengths pad to the
    largest shard's (pad slots point at local position 0, the extra
    candidate the rerank's dedup collapses). A slab of pad rows only gets
    one zero list. The indexes are built on `device` (the avg table's by
    default); `pad_and_shard_state` hands each rank its own."""
    s = num_shards
    avg = state.avg_component
    if isinstance(avg, np.ndarray):
        avg = torch.from_numpy(avg)
    dev = avg.device if device is None else torch.device(device)
    if s == 1:
        ivf = build_ivf_index(avg.to(dev), torch.as_tensor(_host(state.item_ids)).to(dev),
                              nlist=nlist, num_iters=num_iters, cap_factor=cap_factor,
                              num_choices=num_choices, seed=seed, chunk=chunk, mol_state=state)
        return IVFIndex(*(None if a is None else a[None] for a in ivf))
    from rails_tpu_torch.index.sharded import shard_unit, slab_span

    x = int(state.item_ids.shape[0])
    ids_np = _host(state.item_ids)
    parts = []
    for si in range(s):
        lo, hi = slab_span(x, shard_unit(state, s), s, si)
        ids_l = np.zeros(hi - lo, np.int32)
        avg_l = torch.zeros(hi - lo, avg.shape[1], dtype=avg.dtype, device=dev)
        n, n_avg = max(0, min(hi, x) - lo), max(0, min(hi, avg.shape[0]) - lo)
        ids_l[:n] = ids_np[lo : lo + n]
        avg_l[:n_avg] = avg[lo : lo + n_avg].to(dev)
        parts.append(_slab_index(avg_l, torch.as_tensor(ids_l, device=dev), seed + si, nlist,
                                 num_iters, cap_factor, num_choices, chunk))
    sizes = (max(p.centroids.shape[0] for p in parts), max(p.buckets.shape[1] for p in parts),
             max(p.overflow.shape[0] for p in parts))
    padded = [_pad_index(p, *sizes) for p in parts]
    return IVFIndex(*(torch.stack([getattr(p, f) for p in padded])
                      for f in ("centroids", "buckets", "overflow")))


def build_rank_ivf(
    state_l: "tk.MoLTopKState",   # this rank's slab, from sharded.build_shard_state
    mesh,
    nlist: int = 1024,
    num_iters: int = 10,
    cap_factor: float = 2.0,
    num_choices: int = 4,
    seed: int = 0,
    chunk: int = 65_536,
) -> IVFIndex:
    """This rank's index of `build_sharded_ivf`, built from its own slab on
    its device: the same slab, seed `seed + i` and padding to the largest
    shard's lists, whose sizes one all-reduce over the item group finds. One
    shard indexes its state with the MoL-aware probes, as there."""
    import torch.distributed as dist

    from rails_tpu_torch.core.distributed import collective_device
    from rails_tpu_torch.core.mesh import ITEM_AXIS, axis_index, axis_size, item_group

    kw = dict(nlist=nlist, num_iters=num_iters, cap_factor=cap_factor, num_choices=num_choices,
              chunk=chunk)
    if axis_size(mesh, ITEM_AXIS) == 1:
        return build_ivf_index(state_l.avg_component, state_l.item_ids, seed=seed,
                               mol_state=state_l, **kw)
    p = _slab_index(state_l.avg_component, state_l.item_ids, seed + axis_index(mesh, ITEM_AXIS),
                    **kw)
    sizes = torch.tensor([p.centroids.shape[0], p.buckets.shape[1], p.overflow.shape[0]],
                         dtype=torch.int64, device=collective_device())
    dist.all_reduce(sizes, op=dist.ReduceOp.MAX, group=item_group(mesh))
    return _pad_index(p, *(int(v) for v in sizes.tolist()))
