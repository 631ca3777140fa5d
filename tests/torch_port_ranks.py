"""Rank functions of the port's multi-process CPU tests.

Each function runs in a process that `rails_tpu_torch.core.distributed.
run_ranks` spawns: it joins a gloo group over a `file://` store under the
test's tmp_path, reads its inputs from a payload file the test wrote, and
writes rank<r>.pt beside it. This module imports the port, torch and numpy
only (the hygiene test holds it to that): JAX runs in the test process.
"""

from __future__ import annotations

import os
import sys
from typing import Dict

import numpy as np
import torch

from rails_tpu_torch.core import distributed
from rails_tpu_torch.core.config import MeshConfig
from rails_tpu_torch.core.mesh import make_mesh
from rails_tpu_torch.data.features import Batch, SequentialFeatures

# (case name, state kind, method, k, make_sharded_top_k_fn keywords), per
# rank count. State kinds: "std" f32 standard tables, "fused" with f32
# kernel-layout tables, "fused_only", "int8" the test's int8 kernel-layout
# tables, "ivf" the standard state with the test's stacked IVF index.
FULL = dict(k_per_group=1000, avg_top_k=1000)
SHARDED_CASES = {
    2: [
        ("bf", "std", "MoLBruteForceTopK", 20, {}),
        ("fused_only", "fused_only", "MoLBruteForceTopKFused", 15, {}),
        ("int8", "int8", "MoLBruteForceTopKFusedInt8", 15, {}),
        ("ivf", "ivf", "MoLIVFTopK2", 10, {}),
        ("naive5", "std", "MoLNaiveTopK5", 10, {}),
        ("cert", "fused", "MoLCertTopK64", 10, {}),
    ],
    4: [
        ("bf", "std", "MoLBruteForceTopK", 20, {}),
        ("fused", "fused", "MoLBruteForceTopKFused", 15, {}),
        ("naive_full", "std", "MoLNaive", 10, FULL),
        ("comb_full", "std", "MoLComb", 10, FULL),
        ("naive301", "std", "MoLNaiveTopK301", 10, {}),
        ("avg_full", "std", "MoLAvgTopK", 10, dict(avg_top_k=1000)),
        ("naive5", "std", "MoLNaiveTopK5", 10, {}),
        ("avg40", "std", "MoLAvgTopK40", 10, {}),
        ("comb5_40", "std", "MoLCombTopK5_40", 10, {}),
        ("cert", "fused", "MoLCertTopK64", 10, {}),
        ("tile", "fused", "MoLTileTopK1", 10, {}),
    ],
}
NEGATIVE_METHODS = ("MoLBruteForceTopK", "MoLNaiveTopK", "MoLAvgTopK", "MoLCombTopK")
# The slab builds: 301 items in build chunks of 96, which no slab boundary
# (256 items a slab at 2 and 4 ranks) divides; the IVF index of each slab.
SLAB_ITEMS = 301
SLAB_CHUNK = 96
SLAB_IVF = dict(nlist=8, num_iters=3, chunk=4096)


def keyed_embed(model):
    """embed_chunk_fn(start, ids): the item embeddings plus noise keyed on
    the chunk's start, as `cli/shard_bench.py`'s corpus: a slab build gives
    the whole build's columns only through the whole build's chunk starts."""
    from rails_tpu_torch.cli.frontier import chunk_noise

    def embed(start: int, ids: torch.Tensor) -> torch.Tensor:
        base = model.get_item_embeddings(ids).float()
        return base + 0.05 * chunk_noise(start, tuple(base.shape), base.device)

    return embed


def init(rank: int, world: int, store: str) -> None:
    # Two threads a rank: ranks that each take every core slow each other
    # several times over.
    torch.set_num_threads(2)
    distributed.initialize(f"file://{store}", world, rank, backend="gloo", device="cpu")


def save(out_dir: str, rank: int, result: Dict) -> None:
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def load_results(out_dir: str, world: int):
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def features_of(arrays) -> SequentialFeatures:
    return SequentialFeatures(*(torch.from_numpy(np.array(a)) for a in arrays))


def port_model(cfg, num_items: int, state_dict):
    from rails_tpu_torch.train.loop import create_train_state

    model = create_train_state(cfg, num_items, np.arange(1, num_items + 1, dtype=np.int32),
                               device="cpu")[0]
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


class DotModel:
    """The surface the top-k methods read, for a dot product with one
    component per side (P_Q = P_X = 1): `tests/test_sharding.py`'s
    `_DotModel`."""

    def score_precomputed(self, q, tables, user_ids=None):
        return q @ tables.component_embeddings[:, 0, :].T

    def score_gathered(self, q, comp, gating_partial, user_ids=None):
        return torch.einsum("bd,bcd->bc", q, comp[:, :, 0, :])

    def query_components(self, q, user_ids=None):
        return q[:, None, :]


def _state(kind: str, model, ids: torch.Tensor, payload):
    from rails_tpu_torch.index.top_k import build_mol_topk_state

    emb = model.get_item_embeddings(ids)
    if kind in ("std", "ivf"):
        state = build_mol_topk_state(model, ids, emb, torch.float32)
        return state._replace(ivf=payload["ivf"]) if kind == "ivf" else state
    state = build_mol_topk_state(model, ids, emb, torch.float32, build_fused=True,
                                 fused_only=kind == "fused_only")
    # int8: JAX's codes and scales, so that both sides score the same table.
    return state._replace(fused_tables=payload["int8_tables"]) if kind == "int8" else state


@torch.inference_mode()
def sharded_rank(rank: int, world: int, store: str, payload_path: str, out_dir: str) -> None:
    """Every case of SHARDED_CASES[world], this rank's slab builds (bf16
    and int8) and its slab's IVF index, the negative corpus at 4 ranks, and
    at 4 ranks the sharded eval steps and `recall_vs_exact`."""
    from rails_tpu_torch.index.ivf import build_rank_ivf
    from rails_tpu_torch.index.sharded import (
        build_shard_state,
        make_sharded_top_k_fn,
        pad_and_shard_state,
    )
    from rails_tpu_torch.index.top_k import MoLTopKState
    from rails_tpu_torch.similarity.mol import MoLItemTables

    init(rank, world, store)
    p = torch.load(payload_path, weights_only=False)
    model = port_model(p["cfg"], p["num_items"], p["state_dict"])
    mesh = make_mesh(MeshConfig(item_parallel=world))
    ids = torch.from_numpy(np.asarray(p["all_item_ids"], np.int32))
    feats = features_of(p["feats"])
    q = model.encode(feats)
    out = {"q": q.numpy()}
    for name, kind, method, k, kw in SHARDED_CASES[world]:
        sh = pad_and_shard_state(_state(kind, model, ids, p), mesh)
        res = make_sharded_top_k_fn(method, model, sh, mesh, k=k, **kw)(q, feats.user_ids)
        out[name] = (res.scores.numpy(), res.ids.numpy())
    out["slab"] = {q_: build_shard_state(model, SLAB_ITEMS, keyed_embed(model), mesh, quantize=q_,
                                         chunk_size=SLAB_CHUNK) for q_ in (False, True)}
    out["rank_ivf"] = build_rank_ivf(out["slab"][False], mesh, **SLAB_IVF)
    if world == 4:
        nq, items = (torch.from_numpy(p["negative"][a]) for a in ("q", "items"))
        neg = MoLTopKState(item_ids=torch.arange(1, items.shape[0] + 1, dtype=torch.int32),
                           item_tables=MoLItemTables(items[:, None, :], None),
                           avg_component=items)
        sh = pad_and_shard_state(neg, mesh)
        out["negative_slab_rows"] = int(sh.item_ids.shape[0])
        for method in NEGATIVE_METHODS:
            res = make_sharded_top_k_fn(method, DotModel(), sh, mesh, k=5, **FULL)(nq)
            out[f"negative_{method}"] = (res.scores.numpy(), res.ids.numpy())
        out.update(_eval_steps(model, p, mesh))
    save(out_dir, rank, out)
    distributed.shutdown()


def shard_bench_rank(rank: int, world: int, store: str, out_dir: str, argv) -> None:
    """`cli/shard_bench.py`'s main as this rank of a gloo group on the CPU;
    its summary (None off rank 0)."""
    from rails_tpu_torch.cli import shard_bench

    init(rank, world, store)
    save(out_dir, rank, {"summary": shard_bench.main(list(argv))})
    distributed.shutdown()


@torch.inference_mode()
def eval_cli_rank(rank: int, world: int, store: str, payload_path: str, out_dir: str) -> None:
    """`cli/eval.py`'s main with `--item-parallel` as this rank of a gloo
    group (its CSV lines, None off rank 0); then a serving state saved by
    the test, loaded with `host=True` and sharded by `pad_and_shard_state`:
    this rank's slab's element count and the merged top-k; then
    `cli/train.py`'s main with `--distributed`, data-parallel over the
    group: its final metrics and weights."""
    from rails_tpu_torch.cli import eval as eval_cli
    from rails_tpu_torch.index.serving_state import load_serving_state
    from rails_tpu_torch.index.sharded import make_sharded_top_k_fn, pad_and_shard_state
    from rails_tpu_torch.train.loop import create_train_state

    init(rank, world, store)
    p = torch.load(payload_path, weights_only=False)
    out = {"lines": eval_cli.main(list(p["argv"]))}
    cfg, n = p["cfg"], p["num_items"]
    model = create_train_state(cfg, n, np.arange(1, n + 1, dtype=np.int32), device="cpu")[0]
    es = load_serving_state(p["serving_state"], model, host=True)
    mesh = make_mesh(MeshConfig(item_parallel=world))
    sh = pad_and_shard_state(es.topk_state, mesh)
    feats = features_of(p["feats"])
    res = make_sharded_top_k_fn(es.top_k_method, model, sh, mesh, k=p["k"])(
        model.encode(feats), feats.user_ids)
    out.update(slab_items=int(sh.item_ids.shape[0]), ids=res.ids.numpy(),
               scores=res.scores.numpy())
    # TensorBoard's import pulls in TensorFlow; the JSONL log is the record.
    sys.modules["torch.utils.tensorboard"] = None
    with torch.inference_mode(False):
        from rails_tpu_torch.cli import train

        result = train.main(list(p["train_argv"]))
    out["train"] = dict(final=result.final_metrics,
                        params={k: v.detach().clone() for k, v in result.model.state_dict().items()})
    save(out_dir, rank, out)
    distributed.shutdown()


def _eval_steps(model, p, mesh) -> Dict:
    from rails_tpu_torch.train.evaluation import (
        get_eval_state,
        make_eval_step,
        make_sharded_eval_step,
        recall_vs_exact,
    )

    batches = [Batch(features_of(f), torch.from_numpy(t), torch.from_numpy(t))
               for f, t in p["batches"]]
    seq_len = batches[0].features.ids.shape[1]
    states = {m: get_eval_state(model, p["all_item_ids"], m, torch.float32, "cpu")
              for m in ("MoLBruteForceTopK", "MoLAvgTopK400", "MoLAvgTopK60")}
    out = {}
    step = make_sharded_eval_step(model, states["MoLBruteForceTopK"], mesh, 20, seq_len)
    out["eval_exact"] = [tuple(t.numpy() for t in step(b.features, b.target_ids))
                         for b in batches]
    exact1 = make_sharded_eval_step(model, states["MoLBruteForceTopK"], mesh, 1, seq_len)
    for m in ("MoLAvgTopK400", "MoLAvgTopK60"):
        apx = make_sharded_eval_step(model, states[m], mesh, 50, seq_len)
        out[f"recall_{m}"] = recall_vs_exact(model, states["MoLBruteForceTopK"], states[m],
                                             batches, k=50, exact_step=exact1, approx_step=apx)
    out["recall_single_MoLAvgTopK60"] = recall_vs_exact(
        model, states["MoLBruteForceTopK"], states["MoLAvgTopK60"], batches, k=50,
        approx_step=make_eval_step(model, states["MoLAvgTopK60"], 50))
    return out


# ---------------------------------------------------------------------------
# Data-parallel training.


def batch_rows(batch_arrays, rank: int, world: int) -> Batch:
    """Rank `rank`'s block of rows of a global batch given as numpy arrays
    (features, target_ids, target_ratings)."""
    feats, tgt, rat = batch_arrays
    b = tgt.shape[0] // world
    sl = slice(rank * b, (rank + 1) * b)
    return Batch(features_of([np.asarray(a)[sl] for a in feats]),
                 torch.from_numpy(np.asarray(tgt)[sl]), torch.from_numpy(np.asarray(rat)[sl]))


def fix_negatives(negatives) -> None:
    """The local sampler returns this fixed global (M, R) draw (None: its own
    draws again)."""
    from rails_tpu_torch.losses import samplers

    cls = samplers.LocalNegativesSampler
    if not hasattr(cls, "_own_sample"):
        cls._own_sample = cls.sample
    cls.sample = (cls._own_sample if negatives is None
                  else lambda self, generator, shape: torch.from_numpy(negatives))


def train_steps(cfg, num_items: int, state_dict, batch: Batch, steps: int, seed: int,
                mesh=None, opt_state=None):
    """`steps` port train steps on `batch` from `state_dict` (a generator of
    seed `seed`). Returns (losses, metrics of the last step, parameters,
    first step's gradients)."""
    from rails_tpu_torch.train.loop import create_train_state

    model, state, step, _ = create_train_state(
        cfg, num_items, np.arange(1, num_items + 1, dtype=np.int32), device="cpu", mesh=mesh)
    model.load_state_dict(state_dict, strict=True)
    if opt_state is not None:
        state.optimizer.state = opt_state
    gen = torch.Generator().manual_seed(seed)
    losses, grads = [], None
    for i in range(steps):
        state, m = step(state, batch, gen)
        losses.append(m["loss"].item())
        if i == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return losses, {k: v.item() for k, v in m.items()}, params, grads


def dp_rank(rank: int, world: int, store: str, payload_path: str, out_dir: str) -> None:
    """Every case of the payload: `steps` data-parallel steps of this rank's
    rows of the global batch."""
    init(rank, world, store)
    p = torch.load(payload_path, weights_only=False)
    mesh = make_mesh(MeshConfig(data_parallel=world, item_parallel=1))
    out = {}
    for name, case in p["cases"].items():
        fix_negatives(case.get("negatives"))
        losses, metrics, params, grads = train_steps(
            case["cfg"], case["num_items"], case["state_dict"],
            batch_rows(case["batch"], rank, world), case["steps"], case["seed"],
            mesh, case.get("opt_state"))
        out[name] = dict(losses=losses, metrics=metrics, params=params, grads=grads)
    save(out_dir, rank, out)
    distributed.shutdown()


# ---------------------------------------------------------------------------
# Two processes end to end (`tests/test_distributed.py`).


def two_process_train_rank(rank: int, world: int, store: str, payload_path: str,
                           out_dir: str) -> None:
    """Data-parallel steps over each rank's epoch shard, then each rank's
    shard of the eval users and the metric all-reduce."""
    from rails_tpu_torch.data.datasets import generate_synthetic_sequences, SequenceDataset
    from rails_tpu_torch.train.evaluation import get_eval_state, make_eval_step, metrics_from_ranks
    from rails_tpu_torch.train.loop import create_train_state

    init(rank, world, store)
    p = torch.load(payload_path, weights_only=False)
    cfg = p["cfg"]
    mesh = make_mesh(MeshConfig(data_parallel=world, item_parallel=1))
    n = cfg.data.synthetic_num_items
    seqs = generate_synthetic_sequences(num_users=cfg.data.synthetic_num_users, num_items=n,
                                        max_len=cfg.data.max_sequence_length + 2, seed=0)
    train_ds = SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1)
    eval_ds = SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=0)
    model, state, step, _ = create_train_state(
        cfg, n, np.arange(1, n + 1, dtype=np.int32), device="cpu", mesh=mesh)
    gen = torch.Generator().manual_seed(0)
    max_out = cfg.train.gr_output_length + 1
    losses, shards = [], set()
    for b in train_ds.batches(cfg.train.local_batch_size, max_out, shuffle=True, seed=0,
                              drop_last=True, num_shards=world, shard_index=rank,
                              device="cpu"):
        b, shard = distributed.make_global_batch(b, mesh)
        shards.add(shard[:3])
        state, m = step(state, b, gen)
        losses.append(m["loss"].item())
    es = get_eval_state(model, np.arange(1, n + 1, dtype=np.int32), "MoLBruteForceTopK",
                        torch.float32, "cpu")
    ev = make_eval_step(model, es, 50)
    ranks = []
    for b in eval_ds.batches(8, max_out, shuffle=False, drop_last=True, num_shards=world,
                             shard_index=rank, device="cpu"):
        ranks.append(ev(b.features, b.target_ids)[0])
    per_example = {k: v.numpy() for k, v in metrics_from_ranks(torch.cat(ranks)).items()}
    final = distributed.all_reduce_mean_metrics(
        {k: per_example[k] for k in ("hr@10", "hr@50", "mrr")})
    params = distributed.fetch_replicated(dict(model.named_parameters()))
    save(out_dir, rank, dict(losses=losses, final=final, per_example=per_example,
                             process_index=distributed.process_index(), params=params,
                             shards=shards, primary=distributed.is_primary(),
                             count=distributed.process_count()))
    distributed.shutdown()


@torch.inference_mode()
def two_process_serve_rank(rank: int, world: int, store: str, payload_path: str,
                           out_dir: str) -> None:
    """Both ranks build the same model and corpus from the seed; the corpus
    shards over the two; the merged ids must equal the single-process brute
    force each rank computes."""
    from rails_tpu_torch.data.datasets import generate_synthetic_sequences, SequenceDataset
    from rails_tpu_torch.index.sharded import make_sharded_top_k_fn, pad_and_shard_state
    from rails_tpu_torch.index.top_k import build_mol_topk_state, mol_brute_force_top_k
    from rails_tpu_torch.train.loop import create_train_state

    init(rank, world, store)
    cfg = torch.load(payload_path, weights_only=False)["cfg"]
    n = cfg.data.synthetic_num_items
    seqs = generate_synthetic_sequences(num_users=cfg.data.synthetic_num_users, num_items=n,
                                        max_len=cfg.data.max_sequence_length + 2, seed=0)
    batch = next(SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1).batches(
        8, cfg.train.gr_output_length + 1, shuffle=False, device="cpu"))
    model = create_train_state(cfg, n, np.arange(1, n + 1, dtype=np.int32), device="cpu")[0]
    ids = torch.arange(1, n + 1, dtype=torch.int32)
    state = build_mol_topk_state(model, ids, model.get_item_embeddings(ids), torch.float32)
    q = model.encode(batch.features)
    want = mol_brute_force_top_k(model, state, q, 15, batch.features.user_ids)
    mesh = make_mesh(MeshConfig(item_parallel=world))
    got = make_sharded_top_k_fn("MoLBruteForceTopK", model, pad_and_shard_state(state, mesh),
                                mesh, k=15)(q, batch.features.user_ids)
    save(out_dir, rank, dict(got=got.ids.numpy(), want=want.ids.numpy(),
                             got_scores=got.scores.numpy(), want_scores=want.scores.numpy(),
                             process_index=distributed.process_index()))
    distributed.shutdown()

