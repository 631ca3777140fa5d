"""Exact and approximate MoL top-k over a corpus.

Counterpart of `rails_tpu/index/top_k.py`: `NEG_DUP`, `NEG_PAD`,
`_CHUNK_MAX_X`, `BUILD_CHUNK` and `_mask_pad_rows` (:39-61), `TopKResult`,
`MoLTopKState`, `build_mol_topk_state` with `quantize_fused` (:107-208), the
chunked on-device corpus build `build_fused_state_chunked_on_device`
(:293-411), which with `span` also builds one rank's slab in place of the
host-staged `build_fused_state_chunked(keep_on_host=True)` (:211-290), the
exact select `hierarchical_top_k` and `chunked_top_k`
(:507-630), the exact methods `mol_brute_force_top_k` (:633-649),
`mol_brute_force_top_k_fused` (:652-737, K2 with its tile maxima above
`_CHUNK_MAX_X` items) and `mol_brute_force_top_k_fused_approx` (:740-763),
and approximate retrieval: the certificates and `mol_certified_top_k`
(:766-884, K8), `mol_tile_top_k` (:887-994, K9) and `mol_tile_top_k_shared`
(:997-1142, K9 + K10), `mips_brute_force_top_k` (:1145-1158), the candidate
gather with int8 dequantization and `dedup_rerank_top_k` (:1182-1431),
Naive, Avg and Comb (:1438-1741), and `permute_state_items` (:414-499), the
cluster-order relayout of IVF (`index/ivf.py`, whose index rides on the
state). Every method takes int8 fused tables: the kernels read the scales,
the gathers and the Naive walk dequantize.

Up to `_CHUNK_MAX_X` columns the select is `torch.topk`; ties may resolve to
other indices than `lax.top_k`'s lowest-index rule. Above it
`hierarchical_top_k` selects exactly in the score multiset, as in JAX.

Not ported, because they work around the TPU or XLA rather than state the
algorithm: `chunked_top_k`'s per-chunk-then-merge select below
`_CHUNK_MAX_X` (`top_k.py:595-603`, a TPU speed trade), the streamed column
gather with its optimization barriers (`top_k.py:1238-1302`; indexing a
contiguous table copies only the gathered columns) and the static unrolling
of the Naive corpus walk (the chunking stays: it bounds memory), and
`permute_state_items`' host round trip of each table (an on-device
`index_select` copies one table at a time).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rails_tpu_torch.ops.mol_scoring import (
    BLOCK_X,
    FusedCorpusTables,
    extract_gating_qi_weights,
    fused_mol_group_block_max,
    fused_mol_scores_t,
    fused_mol_scores_tiles,
    fused_mol_ub_t,
    prepare_fused_tables,
    quantize_columns,
    quantize_fused_tables,
    query_dtype,
)
from rails_tpu_torch.similarity.mol import MoLItemTables

if TYPE_CHECKING:
    from rails_tpu_torch.index.ivf import IVFIndex

# Duplicate candidates score NEG_DUP; item id 0 is the padding id, and rows
# carrying it score NEG_PAD before any select, so pads rank below duplicates.
NEG_DUP = -32767.0
NEG_PAD = -1.0e30
# Above this many columns the exact select is `hierarchical_top_k` (and the
# fused path feeds it K2's tile maxima); at or below it, `torch.topk`.
_CHUNK_MAX_X = 262_144
# The one corpus-chunk size of the chunked builder and the streamed oracle:
# an embed_chunk_fn that keys its noise on the chunk start must see the same
# chunks in both, or the oracle scores another corpus (`top_k.py:51-56`).
BUILD_CHUNK = 262_144
# Naive candidate generation walks corpora above this size in chunks of it.
_NAIVE_CORPUS_CHUNK = 131_072
# Candidates per rerank step of the certified and per-query tile methods.
_RERANK_CHUNK = 8192
# Relative certificate margin per table dtype (`top_k.py:794-803`): the bound
# and the rerank sum in other orders, so `ub <= kth` must absorb a few ULPs of
# the table dtype; other dtypes still differ by summation order.
_CERT_REL_MARGIN = {torch.int8: 2.0 ** -6, torch.bfloat16: 2.0 ** -7}
_CERT_DEFAULT_REL_MARGIN = 2.0 ** -20


def _mask_pad_rows(scores: torch.Tensor, item_ids: torch.Tensor) -> torch.Tensor:
    return torch.where(item_ids == 0, NEG_PAD, scores)


class TopKResult(NamedTuple):
    scores: torch.Tensor   # (B, K)
    ids: torch.Tensor      # (B, K)


class MoLTopKState(NamedTuple):
    """Device-resident corpus state shared by every MoL top-k method. A
    `fused_only` state has an empty standard component table; `ivf` is the
    inverted-file index `MoLIVFTopK{n}` probes (`ivf.build_ivf_index`)."""

    item_ids: torch.Tensor            # (X,) int32
    item_tables: MoLItemTables        # components (X, P_X, d_P) + gating (X, L)
    avg_component: torch.Tensor       # (X, d_P): mean over P_X components
    fused_tables: Optional[FusedCorpusTables] = None
    ivf: Optional["IVFIndex"] = None


class TopKCertificate(NamedTuple):
    """Per-query bound of an approximate pass (`top_k.py:766-785`):
    `ub_unexamined` bounds the exact score of every item the method did not
    score; `certified` (ub + margin <= kth_score) proves the returned top-k
    exact, and `gap_bound` bounds how far the true k-th score can sit above
    the returned one."""

    certified: torch.Tensor       # (B,) bool
    ub_unexamined: torch.Tensor   # (B,)
    kth_score: torch.Tensor       # (B,)
    gap_bound: torch.Tensor       # (B,)


def build_mol_topk_state(
    model,
    item_ids: torch.Tensor,
    item_embeddings: torch.Tensor,
    table_dtype: torch.dtype = torch.bfloat16,
    build_fused: bool = False,
    fused_only: bool = False,
    quantize_fused: bool = False,
) -> MoLTopKState:
    """Precompute the item-side tables of a corpus (X, D), in `table_dtype`;
    `build_fused` adds the kernel-layout tables, and `fused_only` keeps only
    those (plus the avg table): every method still runs, gathering its
    candidates from the kernel layout. `quantize_fused` stores the fused
    tables int8 with their scales (half the bytes; `quantize_fused_tables`).
    The kernel layout serves only K2's function, the glu_silu combination
    (`rails_tpu/ops/pallas/mol_scoring.py:20-22`): any other combination, or
    a similarity without an item gating partial, gets no fused tables, and
    every method that reads them refuses it (`fused_scoring`)."""
    if (fused_only or quantize_fused) and not build_fused:
        raise ValueError("fused_only and quantize_fused require build_fused=True")
    tables = model.build_item_tables(item_embeddings)
    comp = tables.component_embeddings
    gating = None if tables.gating_partial is None else tables.gating_partial.to(table_dtype)
    fused = None
    if build_fused and fused_scoring(model.cfg.mol):
        fused = prepare_fused_tables(comp.to(table_dtype), gating)
        if quantize_fused:
            fused = quantize_fused_tables(fused)
    if fused_only:
        if fused is None:
            raise ValueError("fused_only needs the fused tables, and so an item gating partial")
        item_tables = MoLItemTables(
            component_embeddings=comp.new_zeros((0,) + tuple(comp.shape[1:]), dtype=table_dtype),
            gating_partial=None,
        )
    else:
        item_tables = MoLItemTables(component_embeddings=comp.to(table_dtype),
                                    gating_partial=gating)
    return MoLTopKState(
        item_ids=item_ids.to(torch.int32),
        item_tables=item_tables,
        avg_component=comp.mean(dim=1).to(table_dtype),
        fused_tables=fused,
    )


@torch.inference_mode()
def build_fused_state_chunked_on_device(
    model,
    item_ids: torch.Tensor,                       # (X,) int32, on the target device
    embed_chunk_fn: Callable[[int, torch.Tensor], torch.Tensor],  # (start, ids) -> (C, D)
    chunk_size: int = BUILD_CHUNK,
    table_dtype: torch.dtype = torch.bfloat16,
    quantize: bool = False,
    span: Optional[Tuple[int, int]] = None,
) -> MoLTopKState:
    """A `fused_only` state built chunk by chunk on `item_ids`' device
    (`top_k.py:293-411`): the kernel-layout tables, the avg table and, with
    `quantize`, the int8 codes and scales are allocated once at X padded to
    256 and filled `chunk_size` items at a time, so the peak is the final
    state plus one chunk, and with `quantize` the `table_dtype` tables never
    exist whole. Per-chunk quantization gives the bytes of quantizing the
    assembled tables (`quantize_columns`: the scales are per item); pad
    columns keep codes 0 and the scale 1e-12 / 127. `item_ids` come back
    zero-padded to X padded, as in JAX.

    `span` = (lo, hi) builds columns [lo, hi) only, padded to a multiple of
    256 (hi may pass X): one rank's slab (`sharded.build_shard_state`). The
    chunks that meet the span run with the whole build's starts, so an
    `embed_chunk_fn` keyed on the chunk start gives the same columns, and
    neither the device nor the host holds the tables of more than the slab
    and one chunk.
    It takes the place of JAX's host-staged `build_fused_state_chunked(
    keep_on_host=True)` (:211-290), which builds the whole corpus on the
    host for `pad_and_shard_state` to slice."""
    mol = model.cfg.mol
    if not fused_scoring(mol):
        raise ValueError("the fused kernel layout serves only K2's function, the glu_silu "
                         "combination with both gating partials")
    x = int(item_ids.shape[0])
    lo, hi = (0, x) if span is None else span
    xp = -(-(hi - lo) // BLOCK_X) * BLOCK_X
    p_x, d_p, l = mol.item_dot_product_groups, mol.dot_product_dimension, mol.num_logits
    dev = item_ids.device
    tbl = torch.int8 if quantize else table_dtype
    comp_buf = torch.zeros(p_x, d_p, xp, dtype=tbl, device=dev)
    gp_buf = torch.zeros(l, xp, dtype=tbl, device=dev)
    avg_buf = torch.zeros(xp, d_p, dtype=table_dtype, device=dev)
    cs_buf = ps_buf = None
    if quantize:
        pad_scale = torch.full((), 1e-12, dtype=torch.float32, device=dev) / 127.0
        cs_buf = pad_scale.expand(p_x, xp).clone()
        ps_buf = pad_scale.expand(1, xp).clone()
    for start in range(lo - lo % chunk_size, min(hi, x), chunk_size):
        end = min(start + chunk_size, x)
        t = model.build_item_tables(embed_chunk_fn(start, item_ids[start:end]))
        a, b = max(start, lo) - start, min(end, hi) - start   # the chunk's rows in the span
        comp = t.component_embeddings[a:b]
        comp_t = comp.to(table_dtype).permute(1, 2, 0)                       # (P_X, d_P, C)
        gp_t = t.gating_partial[a:b].to(table_dtype).T                       # (L, C)
        c0, c1 = start + a - lo, start + b - lo
        avg_buf[c0:c1] = comp.mean(dim=1).to(table_dtype)
        if quantize:
            comp_t, gp_t, cs_buf[:, c0:c1], ps_buf[:, c0:c1] = quantize_columns(comp_t, gp_t)
        comp_buf[:, :, c0:c1] = comp_t
        gp_buf[:, c0:c1] = gp_t
    ids = torch.zeros(xp, dtype=torch.int32, device=dev)
    ids[: max(0, min(hi, x) - lo)] = item_ids[lo:hi]
    return MoLTopKState(
        item_ids=ids,
        item_tables=MoLItemTables(
            component_embeddings=torch.zeros(0, p_x, d_p, dtype=table_dtype, device=dev),
            gating_partial=None,
        ),
        avg_component=avg_buf,
        fused_tables=FusedCorpusTables(comp_buf, gp_buf, x, cs_buf, ps_buf),
    )


@torch.inference_mode()
def permute_state_items(state: MoLTopKState, perm) -> MoLTopKState:
    """The corpus state with its item columns in the order `perm` (new
    position -> old position), e.g. `build_ivf_index(...,
    return_cluster_perm=True)`'s cluster order (`top_k.py:414-499`). The ids
    travel with the tables, so every method returns the same ids and scores
    (ties aside); only the tiles' composition changes, which sharpens the
    tile methods' block maxima on a cluster-ordered corpus. Each table is one
    `index_select` on its device; columns past len(perm) (the kernel layout's
    pad) stay in place. An attached `ivf` is remapped through the inverse
    permutation (bucket pad slots remap to some real position, which the
    rerank's dedup still collapses)."""
    dev = state.item_ids.device
    perm = torch.as_tensor(np.asarray(perm), dtype=torch.int64, device=dev)
    x = int(perm.shape[0])

    def take(t: Optional[torch.Tensor], dim: int) -> Optional[torch.Tensor]:
        if t is None:
            return None
        n = t.shape[dim]
        idx = perm if n == x else torch.cat([perm, torch.arange(x, n, device=dev)])
        return t.index_select(dim, idx)

    it = state.item_tables
    if it.component_embeddings.shape[0] > 0:
        it = MoLItemTables(take(it.component_embeddings, 0), take(it.gating_partial, 0))
    avg = state.avg_component
    if avg.shape[0] == x:
        avg = take(avg, 0)
    ft = state.fused_tables
    if ft is not None:
        ft = FusedCorpusTables(take(ft.item_comp_t, 2), take(ft.item_partial_t, 1), ft.num_items,
                               take(ft.comp_scale, 1), take(ft.partial_scale, 1))
    ivf = state.ivf
    if ivf is not None:
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(x, device=dev)
        ivf = ivf._replace(buckets=inv[ivf.buckets.long()].to(torch.int32),
                           overflow=inv[ivf.overflow.long()].to(torch.int32))
    return MoLTopKState(item_ids=take(state.item_ids, 0), item_tables=it, avg_component=avg,
                        fused_tables=ft, ivf=ivf)


def fused_scoring(mol) -> bool:
    """Whether K2's kernel layout serves a MoL config: the glu_silu
    combination (which has both gating partials), K2's only function."""
    return mol.gating_combination_type == "glu_silu"


def _temperature(model) -> float:
    return float(model.cfg.mol.temperature)


def _fused(state: MoLTopKState, name: str) -> FusedCorpusTables:
    if state.fused_tables is None:
        raise ValueError(f"{name} reads the fused kernel-layout tables: "
                         "build_mol_topk_state(..., build_fused=True) is required")
    return state.fused_tables


def _query_comp(model, ft: FusedCorpusTables, query_embeddings, user_ids) -> torch.Tensor:
    """(B, P_Q, d_P) query components as the kernels take them: in the table
    dtype, bf16 for int8 tables (`query_dtype`)."""
    q = model.query_components(query_embeddings, user_ids)
    return q.to(query_dtype(ft.item_comp_t.dtype)).contiguous()


def hierarchical_top_k(
    scores: torch.Tensor,                       # (B, X)
    k: int,
    tile: int = BLOCK_X,
    tile_max: Optional[torch.Tensor] = None,   # (B, >= ceil(X / tile)) f32
    extra_tiles: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of multi-million-column rows through a tile-max hierarchy
    (`top_k.py:507-587`): the top-k tiles by their maxima, then the top-k of
    those tiles' columns. Every column scoring at least the k-th score lies in
    a tile whose max is at least that score, and at most k tiles have one, so
    the score multiset is exact; a tie at the k-th score may resolve to
    another column than `torch.topk`'s. `tile_max` may come precomputed (K2's
    emit_blockmax); if it over-states at most `extra_tiles` tiles, selecting
    that many more tiles keeps the result exact. Pad columns score -inf,
    strictly below NEG_PAD, so every returned column is < X."""
    b, x = scores.shape
    kk = min(k, x)
    nt = -(-x // tile)
    if nt <= kk or x <= 2 * k:
        # Too few tiles for the hierarchy to skip anything.
        return tuple(torch.topk(scores, kk, dim=1))
    pad = nt * tile - x
    if pad:
        scores = F.pad(scores, (0, pad), value=-torch.inf)
    tiles = scores.reshape(b, nt, tile)
    if tile_max is None:
        tile_max = tiles.amax(dim=2)
        sel = kk
    else:
        if tile_max.shape[1] < nt:
            raise ValueError(f"tile_max has {tile_max.shape[1]} tiles for {nt}")
        tile_max = tile_max[:, :nt]
        sel = min(kk + extra_tiles, nt)
    tidx = chunked_top_k(tile_max, sel)[1]                              # (B, sel)
    gathered = tiles.gather(1, tidx[:, :, None].expand(b, sel, tile)).reshape(b, sel * tile)
    v, pos = chunked_top_k(gathered, kk)
    return v, tidx.gather(1, pos // tile) * tile + pos % tile


def chunked_top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis of (B, X) scores: `torch.topk` up to
    `_CHUNK_MAX_X` columns, `hierarchical_top_k` above (`top_k.py:590-630`)."""
    if scores.shape[1] > _CHUNK_MAX_X:
        return hierarchical_top_k(scores, k)
    return tuple(torch.topk(scores, min(k, scores.shape[1]), dim=1))


def mol_brute_force_top_k(
    model, state: MoLTopKState, query_embeddings: torch.Tensor, k: int,
    user_ids: Optional[torch.Tensor] = None,
) -> TopKResult:
    """Exact MoL over the whole corpus through plain PyTorch scoring
    (`MoLBruteForceTopK`)."""
    if state.item_tables.component_embeddings.shape[0] == 0:
        raise ValueError("the state was built fused_only; use MoLBruteForceTopKFused")
    scores = model.score_precomputed(query_embeddings, state.item_tables, user_ids)
    scores = _mask_pad_rows(scores, state.item_ids)
    top_scores, top_idx = chunked_top_k(scores, k)
    return TopKResult(scores=top_scores, ids=state.item_ids[top_idx])


def mol_brute_force_top_k_fused(
    model, state: MoLTopKState, query_embeddings: torch.Tensor, k: int,
    user_ids: Optional[torch.Tensor] = None,
) -> TopKResult:
    """Exact MoL over the whole corpus through the fused scorer (K2): the
    (B, X, L) logits and the gating activations never reach memory. Above
    `_CHUNK_MAX_X` items K2 also emits its per-tile maxima with id-0 columns
    masked in the kernel, and `hierarchical_top_k` selects from them with no
    masking pass over the (B, X) scores (`top_k.py:698-737`). A config
    outside K2's function (`fused_scoring`) is refused before any launch, as
    the other methods that read the kernel layout refuse it."""
    if not fused_scoring(model.cfg.mol):
        raise ValueError("MoLBruteForceTopKFused scores through K2, which serves only the "
                         "glu_silu combination; use MoLBruteForceTopK")
    ft = _fused(state, "MoLBruteForceTopKFused")
    args = (_query_comp(model, ft, query_embeddings, user_ids),
            model.query_gating_partial(query_embeddings), ft.item_comp_t, ft.item_partial_t,
            extract_gating_qi_weights(model.mol), _temperature(model), ft.comp_scale,
            ft.partial_scale)
    if ft.num_items > _CHUNK_MAX_X:
        scores, tile_max = fused_mol_scores_t(*args, emit_blockmax=True,
                                              valid=state.item_ids != 0)
        top_scores, top_idx = hierarchical_top_k(scores[:, : ft.num_items], k,
                                                 tile_max=tile_max)
    else:
        scores = fused_mol_scores_t(*args)[:, : ft.num_items]
        scores = _mask_pad_rows(scores, state.item_ids[: ft.num_items])
        top_scores, top_idx = chunked_top_k(scores, k)
    return TopKResult(scores=top_scores, ids=state.item_ids[top_idx])


def mol_brute_force_top_k_fused_approx(
    model, state: MoLTopKState, query_embeddings: torch.Tensor, k: int,
    user_ids: Optional[torch.Tensor] = None,
) -> TopKResult:
    """`MoLBruteForceTopKFusedApprox`: the fused scores (K2) and an exact
    `torch.topk`. The JAX method selects with `lax.approx_max_k` on a TPU and
    with exact `lax.top_k` elsewhere (`top_k.py:757-758`); torch has no
    approximate select, so the port always takes the exact one."""
    return mol_brute_force_top_k_fused(model, state, query_embeddings, k, user_ids)


def _table_dtype(state: MoLTopKState) -> torch.dtype:
    if state.fused_tables is not None:
        return state.fused_tables.item_comp_t.dtype
    return state.item_tables.component_embeddings.dtype


def _certificate(ub_unexamined: torch.Tensor, kth: torch.Tensor,
                 table_dtype: torch.dtype) -> TopKCertificate:
    rel = _CERT_REL_MARGIN.get(table_dtype, _CERT_DEFAULT_REL_MARGIN)
    margin = rel * torch.maximum(ub_unexamined.abs(), kth.abs())
    return TopKCertificate(
        certified=ub_unexamined + margin <= kth,
        ub_unexamined=ub_unexamined,
        kth_score=kth,
        gap_bound=torch.clamp(ub_unexamined - kth, min=0.0),
    )


def _gathered_candidate_tables(
    state: MoLTopKState, idx: torch.Tensor,      # (B, K) corpus positions
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query candidate tables ((B, K, P_X, d_P), (B, K, L)) from the
    standard tables, or from the kernel layout when the state is `fused_only`
    (`_direct_fused_column_gather`; the port's `item_partial_t` rows are
    already in the n-major logit order); int8 columns dequantize to f32 after
    the gather (`_finalize_gathered`, `top_k.py:1218-1235`)."""
    it = state.item_tables
    if it.component_embeddings.shape[0] > 0:
        gp = it.gating_partial
        return it.component_embeddings[idx], None if gp is None else gp[idx]
    ft = _fused(state, "the candidate gather of a fused_only state")
    comp = ft.item_comp_t[:, :, idx].permute(2, 3, 0, 1)          # (B, K, P_X, d_P)
    gp = ft.item_partial_t[:, idx].permute(1, 2, 0)               # (B, K, L)
    if ft.comp_scale is not None:
        comp = comp.float() * ft.comp_scale[:, idx].permute(1, 2, 0)[..., None]
        gp = gp.float() * ft.partial_scale[0, idx][..., None]
    return comp, gp


def _rerank_scores(model, state, query_embeddings, idx, is_first, user_ids) -> torch.Tensor:
    """(B, C) exact MoL scores of the candidates, NEG_DUP where not first."""
    comp, gp = _gathered_candidate_tables(state, idx)
    scores = model.score_gathered(query_embeddings, comp, gp, user_ids)
    scores = torch.where(is_first, scores, NEG_DUP)
    return _mask_pad_rows(scores, state.item_ids[idx])


def dedup_rerank_top_k(
    model, state: MoLTopKState,
    query_embeddings: torch.Tensor,
    candidate_indices: torch.Tensor,           # (B, C) corpus positions
    k: int,
    user_ids: Optional[torch.Tensor],
    cand_chunk: Optional[int] = None,
    is_first: Optional[torch.Tensor] = None,   # (B, C) bool
) -> TopKResult:
    """Sort the candidates, mask duplicates, exact-MoL rerank, final top-k
    (`top_k.py:1305-1431`). With `cand_chunk`, pools larger than it rerank
    chunk by chunk (per-chunk top-k, then a merge: exact), so the gathered
    tables peak at (B, cand_chunk, P_X, d_P). Given `is_first`, the caller
    has deduplicated (one True per distinct real candidate) and the sort is
    skipped."""
    if is_first is None:
        sorted_idx = torch.sort(candidate_indices, dim=1).values
        is_first = torch.ones_like(sorted_idx, dtype=torch.bool)
        is_first[:, 1:] = sorted_idx[:, 1:] != sorted_idx[:, :-1]
    else:
        sorted_idx = candidate_indices
    b, c = sorted_idx.shape
    if cand_chunk is None or c <= cand_chunk:
        scores = _rerank_scores(model, state, query_embeddings, sorted_idx, is_first, user_ids)
        top_scores, pos = torch.topk(scores, min(k, c), dim=1)
        return TopKResult(scores=top_scores, ids=state.item_ids[sorted_idx.gather(1, pos)])
    # Pad with duplicates of the last candidate, flagged not-first.
    nc = -(-c // cand_chunk)
    pad = nc * cand_chunk - c
    if pad:
        sorted_idx = torch.cat([sorted_idx, sorted_idx[:, -1:].expand(b, pad)], dim=1)
        is_first = torch.cat([is_first, is_first.new_zeros(b, pad)], dim=1)
    kk = min(k, cand_chunk)
    vals, idxs = [], []
    for s in range(0, nc * cand_chunk, cand_chunk):
        idx_c = sorted_idx[:, s : s + cand_chunk]
        scores = _rerank_scores(model, state, query_embeddings, idx_c,
                                is_first[:, s : s + cand_chunk], user_ids)
        v, pos = torch.topk(scores, kk, dim=1)
        vals.append(v)
        idxs.append(idx_c.gather(1, pos))
    v_all, i_all = torch.cat(vals, dim=1), torch.cat(idxs, dim=1)
    top_scores, pos = torch.topk(v_all, min(k, nc * kk), dim=1)
    return TopKResult(scores=top_scores, ids=state.item_ids[i_all.gather(1, pos)])


def mol_certified_top_k(
    model, state: MoLTopKState,
    query_embeddings: torch.Tensor,
    k: int,
    cand_budget: int,
    user_ids: Optional[torch.Tensor] = None,
) -> Tuple[TopKResult, TopKCertificate]:
    """Upper-bound prefilter (K8) + exact rerank with a per-query
    certificate (`top_k.py:821-884`). score(q, x) <= UB(q, x) = max_l
    logit_l; the top-`cand_budget` items by UB are reranked, and the
    (cand_budget+1)-th UB bounds every unexamined item, so UB spill <= the
    returned k-th score proves the result exact."""
    ft = _fused(state, "mol_certified_top_k")
    q_comp = _query_comp(model, ft, query_embeddings, user_ids)
    ub = fused_mol_ub_t(q_comp, ft.item_comp_t, _temperature(model),
                        ft.comp_scale)[:, : ft.num_items]
    ub = _mask_pad_rows(ub, state.item_ids[: ub.shape[1]])
    b, x = ub.shape
    c = min(cand_budget, x)
    if c >= x:   # full coverage: nothing unexamined
        cand = torch.arange(x, device=ub.device).expand(b, x)
        spill = torch.full((b,), NEG_PAD, dtype=torch.float32, device=ub.device)
    else:
        ub_top, cand = torch.topk(ub, c + 1, dim=1)
        spill = ub_top[:, c]
        cand = cand[:, :c]
    res = dedup_rerank_top_k(model, state, query_embeddings, cand, k, user_ids,
                             cand_chunk=_RERANK_CHUNK)
    return res, _certificate(spill, res.scores[:, -1], _table_dtype(state))


def _group_block_max(model, state, query_embeddings, user_ids, name):
    ft = _fused(state, name)
    q_comp = _query_comp(model, ft, query_embeddings, user_ids)
    return ft, q_comp, fused_mol_group_block_max(q_comp, ft.item_comp_t, _temperature(model),
                                                 ft.comp_scale)


def mol_tile_top_k(
    model, state: MoLTopKState,
    query_embeddings: torch.Tensor,
    k: int,
    tiles_per_group: int,
    user_ids: Optional[torch.Tensor] = None,
    certified: bool = False,
):
    """Tile-granular Naive (`top_k.py:887-994`): per (query, group) the top
    `tiles_per_group` 256-item tiles by block-max logit (K9), the union's
    items exact-reranked per query. Certificate: an item in no selected tile
    has score <= max_l t_l, t_l group l's tiles_per_group-th block max."""
    _, _, gmax = _group_block_max(model, state, query_embeddings, user_ids, "mol_tile_top_k")
    b, l, nb = gmax.shape
    kk = min(tiles_per_group, nb)
    tv, tidx = torch.topk(gmax.reshape(b * l, nb), kk, dim=1)
    tidx = tidx.reshape(b, l * kk)
    if kk >= nb:
        bound = torch.full((b,), NEG_PAD, dtype=torch.float32, device=gmax.device)
    else:
        bound = tv.reshape(b, l, kk)[:, :, -1].amax(dim=1)
    # Tile-level dedup, then whole tiles expand to item columns.
    tiles_sorted = torch.sort(tidx, dim=1).values
    tile_first = torch.ones_like(tiles_sorted, dtype=torch.bool)
    tile_first[:, 1:] = tiles_sorted[:, 1:] != tiles_sorted[:, :-1]
    offsets = torch.arange(BLOCK_X, device=gmax.device)
    cand = (tiles_sorted[:, :, None] * BLOCK_X + offsets).reshape(b, -1)
    is_first = tile_first[:, :, None].expand(b, l * kk, BLOCK_X).reshape(b, -1)
    x_ids = state.item_ids.shape[0]
    if nb * BLOCK_X > x_ids:   # kernel pad columns: clamp the gather, mask them
        is_first = is_first & (cand < x_ids)
        cand = cand.clamp(max=x_ids - 1)
    res = dedup_rerank_top_k(model, state, query_embeddings, cand, k, user_ids,
                             cand_chunk=_RERANK_CHUNK, is_first=is_first)
    if not certified:
        return res
    return res, _certificate(bound, res.scores[:, -1], _table_dtype(state))


def mol_tile_top_k_shared(
    model, state: MoLTopKState,
    query_embeddings: torch.Tensor,
    k: int,
    tiles_per_group: int,
    user_ids: Optional[torch.Tensor] = None,
    tile_budget: Optional[int] = None,
    certified: bool = False,
):
    """Batch-shared tile retrieval (`top_k.py:997-1142`): every (query,
    group) nominates its top `tiles_per_group` tiles by block-max logit (K9);
    the nominations, deduplicated, form one tile list of static size
    t = min(tile_budget or n_all, n_all, n_tiles) for the whole batch (a
    smaller budget keeps the distinct tiles of highest block max); K10 scores
    those tiles in place for every query; one top-k per query. Certificate:
    an item in no selected tile scores <= the largest block max of the
    unselected tiles."""
    ft, q_comp, gmax = _group_block_max(model, state, query_embeddings, user_ids,
                                        "mol_tile_top_k_shared")
    b, l, nb = gmax.shape
    kk = min(tiles_per_group, nb)
    tv, tidx = torch.topk(gmax.reshape(b * l, nb), kk, dim=1)
    all_tiles, all_vals = tidx.reshape(-1), tv.reshape(-1)
    sorted_tiles = torch.sort(all_tiles).values
    first = torch.ones_like(sorted_tiles, dtype=torch.bool)
    first[1:] = sorted_tiles[1:] != sorted_tiles[:-1]
    n_all = sorted_tiles.shape[0]
    # Never more slots than distinct corpus tiles: nominations repeat.
    t = min(tile_budget or n_all, n_all, nb)
    if t < n_all:
        seg = torch.full((nb,), -torch.inf, device=gmax.device).scatter_reduce(
            0, all_tiles, all_vals, "amax")
        key = torch.where(first, seg[sorted_tiles], NEG_PAD)
        pos = torch.topk(key, t).indices
        sel_tiles, sel_first = sorted_tiles[pos], first[pos]
    else:
        sel_tiles, sel_first = sorted_tiles, first
    if certified:
        covered = torch.zeros(nb + 1, dtype=torch.bool, device=gmax.device)
        covered[torch.where(sel_first, sel_tiles, nb)] = True
        bound = torch.where(covered[None, None, :nb], NEG_PAD, gmax).amax(dim=(1, 2))
    scores = fused_mol_scores_tiles(
        q_comp, model.query_gating_partial(query_embeddings), sel_tiles.to(torch.int32),
        ft.item_comp_t, ft.item_partial_t, extract_gating_qi_weights(model.mol),
        _temperature(model), ft.comp_scale, ft.partial_scale,
    )                                          # (B, t * BLOCK_X)
    cols = (sel_tiles[:, None] * BLOCK_X + torch.arange(BLOCK_X, device=gmax.device)).reshape(-1)
    valid = sel_first.repeat_interleave(BLOCK_X) & (cols < ft.num_items)
    ids_flat = state.item_ids[cols.clamp(max=ft.num_items - 1)]
    scores = _mask_pad_rows(torch.where(valid[None, :], scores, NEG_DUP), ids_flat)
    top_scores, pos = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    res = TopKResult(scores=top_scores, ids=ids_flat[pos])
    if not certified:
        return res
    return res, _certificate(bound, res.scores[:, -1], _table_dtype(state))


def mips_brute_force_top_k(
    item_ids: torch.Tensor,                   # (X,)
    item_embeddings: torch.Tensor,            # (X, D)
    query_embeddings: torch.Tensor,           # (B, D)
    k: int,
) -> TopKResult:
    """`MIPSBruteForceTopK`: dot-product scores in f32, exact top-k."""
    scores = query_embeddings.float() @ item_embeddings.float().T
    scores = _mask_pad_rows(scores, item_ids)
    top_scores, top_idx = torch.topk(scores, k, dim=1)
    return TopKResult(scores=top_scores, ids=item_ids[top_idx])


def _chunk_component_sims(state: MoLTopKState, q_comp: torch.Tensor, start: int,
                          size: int) -> torch.Tensor:
    """(B, P_Q, P_X, size) f32 component dot products of one corpus chunk,
    from whichever layout the state holds; an int8 chunk's scales multiply
    the products (`top_k.py:1455-1495`: the scale folds in after the
    contraction)."""
    it = state.item_tables.component_embeddings
    if it.shape[0] > 0:
        return torch.einsum("bnd,cmd->bnmc", q_comp.float(), it[start : start + size].float())
    ft = state.fused_tables
    sims = torch.einsum("bnd,mdc->bnmc", q_comp.float(),
                        ft.item_comp_t[:, :, start : start + size].float())
    if ft.comp_scale is not None:
        sims = sims * ft.comp_scale[None, None, :, start : start + size]
    return sims


def _naive_candidates(
    model, state: MoLTopKState,
    query_embeddings: torch.Tensor,
    k_per_group: int,
    user_ids: Optional[torch.Tensor],
    corpus_chunk: int = _NAIVE_CORPUS_CHUNK,
    return_bound: bool = False,
):
    """Per-(query-group, item-group) dot-product top-k_per_group union
    (`top_k.py:1498-1625`): (B, P_Q * P_X * k_per_group) corpus positions.
    Corpora above `corpus_chunk` are walked in chunks (the last start clamped
    back, its re-covered rows masked), with per-chunk top-k and an exact
    merge. `return_bound` adds max_l t_l / T, t_l group l's k-th value: an
    unseen item's logits are all below it."""
    q_comp = model.query_components(query_embeddings, user_ids)
    it = state.item_tables.component_embeddings
    has_std = it.shape[0] > 0
    if not has_std:
        _fused(state, "Naive candidate generation on a fused_only state")
    # int8 tables take bf16 queries, as the JAX walk's bf16 dot does.
    q_comp = q_comp.to(query_dtype(it.dtype if has_std else state.fused_tables.item_comp_t.dtype))
    b = q_comp.shape[0]
    x = state.item_ids.shape[0]
    full_cover = k_per_group >= x
    k_per_group = min(k_per_group, x)

    def _maybe(cands, thresholds):
        if not return_bound:
            return cands
        if full_cover:
            return cands, torch.full((b,), NEG_PAD, dtype=torch.float32, device=cands.device)
        return cands, thresholds.amax(dim=1) * (1.0 / _temperature(model))

    if x <= corpus_chunk:
        sims = _chunk_component_sims(state, q_comp, 0, x)            # (B, P_Q, P_X, X)
        sims = _mask_pad_rows(sims, state.item_ids)
        v, idx = torch.topk(sims, k_per_group, dim=-1)
        return _maybe(idx.reshape(b, -1), v[..., -1].reshape(b, -1))
    num_chunks = -(-x // corpus_chunk)
    kk = min(k_per_group, corpus_chunk)
    per_v, per_i = [], []
    for ci in range(num_chunks):
        start_nom = ci * corpus_chunk
        start = min(start_nom, x - corpus_chunk)
        col_ok = state.item_ids[start : start + corpus_chunk] != 0
        if start != start_nom:   # clamped tail: mask the rows a chunk already covered
            col_ok = col_ok & (torch.arange(corpus_chunk, device=col_ok.device)
                               >= start_nom - start)
        sims = _chunk_component_sims(state, q_comp, start, corpus_chunk)
        sims = torch.where(col_ok, sims, NEG_PAD)
        v, i = torch.topk(sims, kk, dim=-1)                          # (B, P_Q, P_X, kk)
        per_v.append(v.reshape(b, -1, kk))
        per_i.append((i + start).reshape(b, -1, kk))
    vv, pos = torch.topk(torch.cat(per_v, dim=2), k_per_group, dim=2)
    idx = torch.cat(per_i, dim=2).gather(2, pos)
    return _maybe(idx.reshape(b, -1), vv[:, :, -1])


def mol_naive_top_k(
    model, state: MoLTopKState,
    query_embeddings: torch.Tensor,
    k: int,
    k_per_group: int,
    user_ids: Optional[torch.Tensor] = None,
    corpus_chunk: int = _NAIVE_CORPUS_CHUNK,
    certified: bool = False,
):
    """`MoLNaiveTopK` (`top_k.py:1628-1652`): the per-group union, one
    rerank; `certified` adds the per-group-threshold certificate."""
    out = _naive_candidates(model, state, query_embeddings, k_per_group, user_ids,
                            corpus_chunk=corpus_chunk, return_bound=certified)
    cands, bound = out if certified else (out, None)
    res = dedup_rerank_top_k(model, state, query_embeddings, cands, k, user_ids)
    if not certified:
        return res
    return res, _certificate(bound, res.scores[:, -1], _table_dtype(state))


def _avg_candidates(model, state, query_embeddings, avg_top_k, user_ids) -> torch.Tensor:
    """Top-`avg_top_k` corpus positions by the avg-component dot product."""
    q_comp = model.query_components(query_embeddings, user_ids)
    q_avg = q_comp.sum(dim=1)             # sum, not mean (`mol_top_k.py:352`)
    avg = state.avg_component
    scores = q_avg.to(avg.dtype).float() @ avg.float().T
    scores = _mask_pad_rows(scores, state.item_ids)
    return torch.topk(scores, avg_top_k, dim=1).indices


def mol_avg_top_k(
    model, state: MoLTopKState,
    query_embeddings: torch.Tensor,
    k: int,
    avg_top_k: int,
    user_ids: Optional[torch.Tensor] = None,
) -> TopKResult:
    """`MoLAvgTopK` (`top_k.py:1655-1698`): avg-embedding MIPS prefilter,
    exact rerank; the budget clamps to the corpus size."""
    avg_top_k = min(avg_top_k, state.item_ids.shape[0])
    cand = _avg_candidates(model, state, query_embeddings, avg_top_k, user_ids)
    comp, gp = _gathered_candidate_tables(state, cand)
    scores = model.score_gathered(query_embeddings, comp, gp, user_ids)
    scores = _mask_pad_rows(scores, state.item_ids[cand])
    top_scores, pos = torch.topk(scores, min(k, avg_top_k), dim=1)
    return TopKResult(scores=top_scores, ids=state.item_ids[cand.gather(1, pos)])


def mol_comb_top_k(
    model, state: MoLTopKState,
    query_embeddings: torch.Tensor,
    k: int,
    avg_top_k: int,
    k_per_group: int,
    user_ids: Optional[torch.Tensor] = None,
    corpus_chunk: int = _NAIVE_CORPUS_CHUNK,
    certified: bool = False,
):
    """`MoLCombTopK` (`top_k.py:1701-1741`): Naive and Avg candidates, one
    rerank; the Naive bound still covers every item outside the union."""
    avg_top_k = min(avg_top_k, state.item_ids.shape[0])
    out = _naive_candidates(model, state, query_embeddings, k_per_group, user_ids,
                            corpus_chunk=corpus_chunk, return_bound=certified)
    naive, bound = out if certified else (out, None)
    cands = torch.cat(
        [naive, _avg_candidates(model, state, query_embeddings, avg_top_k, user_ids)], dim=1)
    res = dedup_rerank_top_k(model, state, query_embeddings, cands, k, user_ids)
    if not certified:
        return res
    return res, _certificate(bound, res.scores[:, -1], _table_dtype(state))
