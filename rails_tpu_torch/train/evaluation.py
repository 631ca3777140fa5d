"""Serving/eval step: encode -> MoL top-k' -> seen-id filter -> ranks.

Counterpart of `rails_tpu/train/evaluation.py`: `EvalState` and
`get_eval_state` (:64-138, int8 tables for the `...Int8...` spellings, the
item embeddings l2-normalised with `item_l2_norm`, the IVF index of the
`MoLIVFTopK{n}` spellings),
`ranks_from_top_k` (:141-152), `metrics_from_ranks` (:155-172),
`add_rating_filtered_metrics` (:175-189), `make_eval_step_fn` and
`make_eval_step` (:192-262, `max_num_invalid` caps the seen ids k' makes
room for), the item-sharded step `make_sharded_eval_step` (:265-339),
`LatencyStats` (:343-347), the eval harness `eval_metrics_from_batches`
(:403-520), `summarize_metrics` (:523-528) and `recall_vs_exact`
(:531-574). A DotProduct model serves through `MIPSBruteForceTopK`. The step
is a plain Python function under `torch.inference_mode`: no jit and no CUDA
graph yet. The JAX step's `params` argument goes everywhere: the weights
live in the model.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from rails_tpu_torch.core.distributed import all_reduce_mean_metrics
from rails_tpu_torch.core.device import resolve_device
from rails_tpu_torch.data.features import SequentialFeatures
from rails_tpu_torch.index.candidate_index import k_prime_for, select_top_k_with_invalid_filter
from rails_tpu_torch.index.factory import get_top_k_raw
from rails_tpu_torch.index.ivf import build_ivf_index
from rails_tpu_torch.index.top_k import MoLTopKState, build_mol_topk_state
from rails_tpu_torch.losses.samplers import maybe_l2_norm
from rails_tpu_torch.similarity.mol import MoLItemTables
from rails_tpu_torch.train.profiling import Timer

NDCG_KS = (1, 5, 10, 50, 100, 200)
HR_KS = (1, 5, 10, 50, 100, 200, 500, 1000)


@dataclass
class EvalState:
    """The corpus's top-k state (ids and item tables) and its embeddings,
    which `MIPSBruteForceTopK` scores."""

    topk_state: MoLTopKState
    num_objects: int
    top_k_method: str = "MoLBruteForceTopK"
    item_embeddings: Optional[torch.Tensor] = None   # (X, D)


def _reads_fused_tables(top_k_method: str) -> bool:
    # The certified UB and the tile block-max prefilters read the kernel
    # layout too (`evaluation.py:108-114`).
    return "Fused" in top_k_method or top_k_method.startswith(("MoLCertTopK", "MoLTileTopK"))


@torch.inference_mode()
def get_eval_state(
    model,
    all_item_ids: np.ndarray,
    top_k_method: str,
    table_dtype: torch.dtype = torch.bfloat16,
    device: Optional[Union[str, torch.device]] = None,
    item_l2_norm: bool = False,
    l2_norm_eps: float = 1e-6,
    ivf_nlist: Optional[int] = None,
) -> EvalState:
    """Embed the whole corpus (l2-normalised with `item_l2_norm`, as the
    `*-dot` configs set it) and build the method's top-k state on `device`
    (the card unless the caller passes "cpu"): the kernel-layout tables for
    the fused, certified and tile methods (int8 with their scales for the
    `...Int8...` spellings), no MoL tables for MIPS, and for `MoLIVFTopK{n}`
    an IVF index with MoL-aware probes over `ivf_nlist` lists, by default
    max(16, floor(4 sqrt(X))) for X real items (`evaluation.py:117-127`)."""
    get_top_k_raw(top_k_method)   # refuse unported methods before any work
    ids = torch.as_tensor(np.asarray(all_item_ids, dtype=np.int32),
                          device=resolve_device(device))
    emb = maybe_l2_norm(model.get_item_embeddings(ids), item_l2_norm, l2_norm_eps)
    if top_k_method == "MIPSBruteForceTopK":
        state = MoLTopKState(
            item_ids=ids,
            item_tables=MoLItemTables(emb.new_zeros((0, 1, 1), dtype=table_dtype), None),
            avg_component=emb.new_zeros((0, 1), dtype=table_dtype),
        )
    else:
        state = build_mol_topk_state(model, ids, emb, table_dtype=table_dtype,
                                     build_fused=_reads_fused_tables(top_k_method),
                                     quantize_fused="Int8" in top_k_method)
    if re.fullmatch(r"MoLIVFTopK\d+", top_k_method):
        x_real = int(torch.count_nonzero(ids).item())
        nlist = ivf_nlist or max(16, int(4 * np.sqrt(x_real)))
        state = state._replace(ivf=build_ivf_index(state.avg_component, state.item_ids,
                                                   nlist=nlist, mol_state=state))
    return EvalState(topk_state=state, num_objects=int(ids.shape[0]),
                     top_k_method=top_k_method, item_embeddings=emb)


def ranks_from_top_k(top_k_ids: torch.Tensor, target_ids: torch.Tensor) -> torch.Tensor:
    """1-based rank of the target in the top-k list; max(k, 1000) + 1 if absent."""
    k = top_k_ids.shape[1]
    hit = top_k_ids == target_ids[:, None]
    found = hit.any(dim=1)
    pos = torch.argmax(hit.to(torch.int8), dim=1)
    sentinel = max(k, max(HR_KS)) + 1
    return torch.where(found, pos + 1, torch.full_like(pos, sentinel))


def metrics_from_ranks(ranks: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-example NDCG/HR/MRR; MRR credits misses 1/sentinel like the reference."""
    out: Dict[str, torch.Tensor] = {}
    ranks_f = ranks.float()
    dcg = 1.0 / torch.log2(ranks_f + 1.0)
    for kk in NDCG_KS:
        out[f"ndcg@{kk}"] = torch.where(ranks <= kk, dcg, torch.zeros_like(dcg))
    for kk in HR_KS:
        out[f"hr@{kk}"] = (ranks <= kk).float()
    out["mrr"] = 1.0 / ranks_f
    return out


def add_rating_filtered_metrics(
    out: Dict[str, np.ndarray],
    ranks: np.ndarray,
    target_ratings: np.ndarray,
    min_positive_rating: int = 4,
) -> None:
    """The metrics over the examples whose target is rated at least
    `min_positive_rating`, added to `out` (`data/eval.py:249-264`)."""
    sel = target_ratings >= min_positive_rating
    r = ranks[sel].astype(np.float64)
    out[f"ndcg@10_>={min_positive_rating}"] = np.where(r <= 10, 1.0 / np.log2(r + 1.0), 0.0)
    out[f"hr@10_>={min_positive_rating}"] = (r <= 10).astype(np.float64)
    out[f"hr@50_>={min_positive_rating}"] = (r <= 50).astype(np.float64)
    out[f"mrr_>={min_positive_rating}"] = 1.0 / r


def make_eval_step_fn(
    model,
    top_k_method: str,
    k: int,
    num_objects: int,
    filter_invalid_ids: bool = True,
    truncate_k_prime_to: Optional[int] = None,
    max_num_invalid: Optional[int] = None,
) -> Callable:
    """The (encode -> top-k' -> filter -> rank) step, with the corpus state as
    an argument: fn(topk_state, features, target_ids, item_embeddings=None)
    -> (ranks (B,), top-k ids (B, k), scores (B, k)). The JAX step's `params`
    argument goes: the weights live in `model`. Only MIPS reads
    `item_embeddings`. k' makes room for the N seen ids of a batch, or for
    at most `max_num_invalid` of them. An approximate method whose pool is
    smaller than k returns its pool; ranks beyond it count as misses."""
    raw = get_top_k_raw(top_k_method)

    @torch.inference_mode()
    def step(topk_state: MoLTopKState, features: SequentialFeatures,
             target_ids: torch.Tensor, item_embeddings: Optional[torch.Tensor] = None):
        queries = model.encode(features)
        n0 = features.ids.shape[1] if filter_invalid_ids else 0
        if max_num_invalid is not None:
            n0 = min(n0, max_num_invalid)
        k_prime = k_prime_for(k, num_objects, n0, truncate_k_prime_to)
        res = raw(model, topk_state, queries, k_prime, features.user_ids,
                  item_embeddings=item_embeddings)
        res = select_top_k_with_invalid_filter(
            res, features.ids if filter_invalid_ids else None, min(k, res.ids.shape[1])
        )
        return ranks_from_top_k(res.ids, target_ids), res.ids, res.scores

    return step


def make_eval_step(
    model,
    eval_state: EvalState,
    k: int,
    filter_invalid_ids: bool = True,
    truncate_k_prime_to: Optional[int] = None,
    max_num_invalid: Optional[int] = None,
) -> Callable:
    """`make_eval_step_fn` bound to one eval state: fn(features, target_ids)."""
    step_fn = make_eval_step_fn(model, eval_state.top_k_method, k, eval_state.num_objects,
                                filter_invalid_ids, truncate_k_prime_to, max_num_invalid)

    def step(features: SequentialFeatures, target_ids: torch.Tensor):
        return step_fn(eval_state.topk_state, features, target_ids, eval_state.item_embeddings)

    return step


def make_sharded_eval_step(
    model,
    eval_state: EvalState,
    mesh,
    k: int,
    seq_len: int,
    filter_invalid_ids: bool = True,
    truncate_k_prime_to: Optional[int] = None,
    k_per_group: int = 50,
    avg_top_k: int = 200,
) -> Callable:
    """The item-sharded eval step (`evaluation.py:265-339`): this rank keeps
    its slab of the eval state (`pad_and_shard_state`), every rank encodes
    the same batch, the per-shard top-k' lists merge over the item group
    (`sharded.make_sharded_top_k_fn`), and the seen-id filter and the ranks
    apply to the merged list, so fn(features, target_ids) -> (ranks, ids,
    scores) has `make_eval_step`'s semantics on every rank. `seq_len`, the
    padded history length, budgets k' once. The slab's tables are those of
    the eval state as built."""
    from rails_tpu_torch.index.sharded import make_sharded_top_k_fn, pad_and_shard_state

    n0 = seq_len if filter_invalid_ids else 0
    k_prime = k_prime_for(k, eval_state.num_objects, n0, truncate_k_prime_to)
    sh_state = pad_and_shard_state(eval_state.topk_state, mesh)
    topk = make_sharded_top_k_fn(eval_state.top_k_method, model, sh_state, mesh, k=k_prime,
                                 k_per_group=k_per_group, avg_top_k=avg_top_k)

    @torch.inference_mode()
    def step(features: SequentialFeatures, target_ids: torch.Tensor):
        res = topk(model.encode(features), user_ids=features.user_ids)
        res = select_top_k_with_invalid_filter(
            res, features.ids if filter_invalid_ids else None, min(k, res.ids.shape[1]))
        return ranks_from_top_k(res.ids, target_ids), res.ids, res.scores

    return step


@dataclass
class LatencyStats:
    mean_ms: float
    std_ms: float
    num_measurements: int


def _valid_rows(b: int, seen: int, num_examples: Optional[int]) -> int:
    """How many of a batch's b rows are new examples: the wrap-around tail
    batch of `SequenceDataset.batches(drop_last=False)` repeats earlier
    rows past `num_examples`."""
    return b if num_examples is None else max(0, min(b, num_examples - seen))


def eval_metrics_from_batches(
    model,
    eval_state: EvalState,
    batches,
    k: int = 200,
    filter_invalid_ids: bool = True,
    include_eval_time: bool = False,
    truncate_k_prime_to: Optional[int] = None,
    warmup_runs: int = 3,
    timed_runs: int = 20,
    timing_fraction: float = 0.1,
    seed: int = 0,
    step_fn: Optional[Callable] = None,
    num_examples: Optional[int] = None,
    step: Optional[Callable] = None,
) -> Tuple[Dict[str, np.ndarray], Optional[LatencyStats]]:
    """Per-example metrics over every batch (objects with `.features`,
    `.target_ids` and `.target_ratings`), and with `include_eval_time` the
    step's latency (`data/eval.py:128-170`): k is capped at 120 and k'
    truncated to 200, each batch is timed with probability
    `timing_fraction` (drawn from `np.random.default_rng(seed)`), and a
    timed batch gets `warmup_runs` calls, then `timed_runs` calls between
    CUDA events (the host clock on the CPU); the latency is the mean over
    the timed batches of their time per call.

    `step_fn` (from `make_eval_step_fn`) reuses one step across corpus
    re-embeddings; `step`, a bound fn(features, target_ids) such as
    `make_sharded_eval_step`'s, replaces the step altogether.
    `num_examples` is the number of real examples when the tail batch wraps
    around; the repeated rows are dropped so that every user counts once."""
    if include_eval_time:
        k = min(k, 120)
        truncate_k_prime_to = 200 if truncate_k_prime_to is None else truncate_k_prime_to
    k = min(k, eval_state.num_objects)
    if step is None and step_fn is not None:
        def step(features, target_ids):
            return step_fn(eval_state.topk_state, features, target_ids,
                           eval_state.item_embeddings)
    elif step is None:
        step = make_eval_step(model, eval_state, k, filter_invalid_ids=filter_invalid_ids,
                              truncate_k_prime_to=truncate_k_prime_to)
    rng = np.random.default_rng(seed)
    all_metrics: Dict[str, List[np.ndarray]] = {}
    times: List[float] = []
    seen = 0
    for batch in batches:
        feats, target_ids = batch.features, batch.target_ids
        if include_eval_time and rng.random() < timing_fraction:
            for _ in range(warmup_runs):
                step(feats, target_ids)
            with Timer(target_ids.device) as timer:
                for _ in range(timed_runs):
                    step(feats, target_ids)
            times.append(timer.ms / timed_runs)
        ranks = step(feats, target_ids)[0]
        valid = _valid_rows(int(ranks.shape[0]), seen, num_examples)
        seen += int(ranks.shape[0])
        if valid == 0:
            continue
        m = {kk: v[:valid].cpu().numpy() for kk, v in metrics_from_ranks(ranks).items()}
        add_rating_filtered_metrics(m, ranks[:valid].cpu().numpy(),
                                    batch.target_ratings[:valid].cpu().numpy())
        for kk, v in m.items():
            all_metrics.setdefault(kk, []).append(v)
    out = {kk: np.concatenate(v) for kk, v in all_metrics.items()}
    lat = None
    if times:
        lat = LatencyStats(mean_ms=float(np.mean(times)), std_ms=float(np.std(times)),
                           num_measurements=len(times))
    return out, lat


def summarize_metrics(metrics: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Mean over the examples of every process: the [sum, count] pairs
    all-reduce across the run's processes (`_avg`, `data/eval.py:271-275`)."""
    return all_reduce_mean_metrics(metrics)


def recall_vs_exact(
    model,
    exact_state: EvalState,
    approx_state: EvalState,
    batches,
    k: int = 200,
    filter_invalid_ids: bool = True,
    exact_step: Optional[Callable] = None,
    approx_step: Optional[Callable] = None,
    num_examples: Optional[int] = None,
) -> Dict[str, float]:
    """Recall of an approximate method against the exact top-1: the exact
    method's top-1 id becomes the target, and the approximate method's HR@k
    against it is its recall (`eval_from_checkpoint.py:427-449`). `batches`
    yields objects with `.features` and `.target_ids`. `exact_step` /
    `approx_step` (fn(features, target_ids)) replace the unsharded steps,
    e.g. with `make_sharded_eval_step`; `num_examples` drops the
    wrap-around tail rows, as in `eval_metrics_from_batches`."""
    if exact_step is None:
        exact_step = make_eval_step(model, exact_state, 1, filter_invalid_ids=filter_invalid_ids)
    if approx_step is None:
        approx_step = make_eval_step(model, approx_state, k,
                                     filter_invalid_ids=filter_invalid_ids)
    hits: Dict[int, List[torch.Tensor]] = {kk: [] for kk in HR_KS if kk <= k}
    seen = 0
    for batch in batches:
        _, exact_ids, _ = exact_step(batch.features, batch.target_ids)
        ranks, _, _ = approx_step(batch.features, exact_ids[:, 0])
        valid = _valid_rows(int(ranks.shape[0]), seen, num_examples)
        seen += int(ranks.shape[0])
        for kk in hits:
            hits[kk].append((ranks[:valid] <= kk).cpu())
    return {f"recall@{kk}": torch.cat(v).float().mean().item() for kk, v in hits.items()}
