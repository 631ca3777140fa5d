"""Item-sharded serving benchmark: top-k over a corpus split across ranks.

Counterpart of `rails_tpu/cli/shard_bench.py`: the item tables shard over
the mesh's `item` axis, one rank per GPU; each rank scores its slab and
top-ks it, and one all-gather merges (`index/sharded.py`). 100M items at
ML-20M's MoL geometry (P_X = 4, d_P = 128, bf16) are 100M x 512 x 2 B =
102 GB of component tables, more than one H100's 80 GB.

Corpus: emb(i) = table[(i - 1) % vocab] + 0.05 eps(i), eps drawn from a torch
generator seeded with the build chunk's start, vocab = min(X, 100,000). Above
1,000,000 items the fused, int8 and IVF methods build the kernel-layout
tables chunk by chunk on the card, each rank only the chunks of its own slab
(`index/sharded.py:build_shard_state`; IVF: `ivf.build_rank_ivf`), so a rank
holds its slab and one chunk: 1,344 B an item at ML-20M's geometry in bf16
(components 1,024, gating 64, avg 256), 134 GB for 100M items, 34 GB a rank
on 4 cards. At or below it every rank builds the whole state and keeps its
slab (`pad_and_shard_state`). The JSON line carries the JAX CLI's keys, and
the corpus build's seconds.

Differences from the JAX CLI: calls are timed between CUDA events (the host
clock on the CPU) after one warm-up call, with the same queries every run
(the JAX CLI perturbs them, and fetches results to the host, to defeat a
remote TPU backend's caching); IVF indexes build on each rank's device.

Usage (one GPU, one rank on NCCL):
  python -m rails_tpu_torch.cli.shard_bench --num-items 8000000
N GPUs of one host:
  torchrun --nproc-per-node N -m rails_tpu_torch.cli.shard_bench --num-items 100000000
CPU smoke (one rank on gloo):
  python -m rails_tpu_torch.cli.shard_bench --device cpu --config synthetic-small \\
      --num-items 3000 --runs 2
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from rails_tpu_torch.cli import frontier
from rails_tpu_torch.core import distributed
from rails_tpu_torch.core.config import MeshConfig
from rails_tpu_torch.core.mesh import make_mesh, replicate
from rails_tpu_torch.index import top_k as tk
from rails_tpu_torch.index.factory import get_top_k_raw
from rails_tpu_torch.index.ivf import build_rank_ivf
from rails_tpu_torch.index.oracle import streamed_exact_top_k
from rails_tpu_torch.index.sharded import (
    build_shard_state,
    make_sharded_top_k_fn,
    pad_and_shard_state,
)
from rails_tpu_torch.similarity.mol import MoLItemTables
from rails_tpu_torch.train.loop import create_train_state
from rails_tpu_torch.train.profiling import timed_ms

log = logging.getLogger("rails_tpu_torch.shard_bench")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="ml-20m-hstu-mol",
                   help="experiment config supplying encoder + MoL geometry")
    p.add_argument("--num-items", type=int, default=1_000_000)
    p.add_argument("--item-parallel", type=int, default=None,
                   help="item-axis size (default: every rank)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--k", type=int, default=200)
    p.add_argument("--method", default="MoLBruteForceTopKFused")
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--ivf-nlist", type=int, default=None,
                   help="IVF cluster count (default max(64, 4 sqrt(X))); MoLIVF* only")
    p.add_argument("--ivf-iters", type=int, default=10)
    p.add_argument("--ivf-recall-floor", type=float, default=0.0,
                   help="fail if IVF recall against the exact oracle is below this")
    p.add_argument("--replicated", action="store_true",
                   help="run the single-device method on the unsharded state "
                        "(item_parallel 1): the A/B arm of the merge's cost")
    p.add_argument("--train-steps", type=int, default=0,
                   help="train N steps on the synthetic data before building the corpus")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    p.add_argument("--check-against-chunked", action="store_true",
                   help="hold the merged top-k against the streamed exact scan")
    p.add_argument("--device", default=None,
                   help="this rank's device (default cuda:LOCAL_RANK); cpu runs gloo")
    return p.parse_args(argv)


def embed_fn(model, vocab: int, device: torch.device):
    """embed_chunk_fn(start, ids): table[(id - 1) % vocab] + 0.05 * noise
    seeded by the chunk's start (`shard_bench.py:131-141`)."""

    def embed(start: int, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.to(device)
        base = model.get_item_embeddings((ids - 1) % vocab + 1).float()
        return base + 0.05 * frontier.chunk_noise(start, tuple(base.shape), device)

    return embed


def build_state(model, args, mesh, device) -> Tuple[tk.MoLTopKState, bool]:
    """This rank's corpus state (`shard_bench.py:143-217`) and whether it is
    the rank's slab already: above 1,000,000 items the fused, int8 and IVF
    methods build only the slab (`build_shard_state`), below it every rank
    builds the whole state."""
    x = args.num_items
    embed = embed_fn(model, min(x, 100_000), device)
    int8 = "Int8" in args.method
    if ("Fused" in args.method or args.method.startswith("MoLIVF")) and x > 1_000_000:
        return build_shard_state(model, x, embed, mesh, quantize=int8), True
    ids = torch.arange(1, x + 1, dtype=torch.int32, device=device)
    state = tk.build_mol_topk_state(model, ids, embed(0, ids), torch.bfloat16,
                                    build_fused="Fused" in args.method, quantize_fused=int8)
    return state, False


def table_bytes(state: tk.MoLTopKState) -> int:
    ft = state.fused_tables
    if ft is not None:
        n = ft.item_comp_t.numel() * ft.item_comp_t.element_size()
        n += ft.item_partial_t.numel() * ft.item_partial_t.element_size()
        if ft.comp_scale is not None:
            n += (ft.comp_scale.numel() + ft.partial_scale.numel()) * 4
        return n
    it = state.item_tables
    return sum(t.numel() * t.element_size() for t in (it.component_embeddings, it.gating_partial)
               if t is not None)


def main(argv=None) -> Optional[dict]:
    """Run the benchmark on this rank; rank 0 prints and returns the
    summary (None on the other ranks)."""
    args = parse_args(argv)
    get_top_k_raw(args.method)   # refuse an unknown method before any work
    logging.basicConfig(stream=sys.stdout, level=logging.INFO)
    distributed.initialize(device=args.device)
    device = distributed.device()
    world = distributed.process_count()
    item_parallel = args.item_parallel or world
    if args.replicated and item_parallel != 1:
        raise SystemExit("--replicated is a single-device A/B arm (use --item-parallel 1)")
    mesh = make_mesh(MeshConfig(item_parallel=item_parallel,
                                data_parallel=world // item_parallel))
    fargs = argparse.Namespace(num_items=args.num_items, batch_size=args.batch_size,
                               config=args.config, set=args.set)
    cfg = frontier.configure(fargs)
    ds = frontier.synthetic_dataset(cfg)
    vocab = cfg.data.synthetic_num_items
    if args.train_steps > 0:
        model, _ = frontier.pretrain(cfg, ds, args.train_steps, device)
    else:
        model = create_train_state(cfg, vocab, np.arange(1, vocab + 1, dtype=np.int32),
                                   device=device)[0]
    replicate(model, mesh)   # every rank serves rank 0's weights

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        state, is_slab = build_state(model, args, mesh, device)
        served = state if is_slab or args.replicated else pad_and_shard_state(state, mesh)
        sync()
        build_s = time.perf_counter() - t0
        log.info("corpus: %d items, this rank's tables %.2f GB, %d-way item sharding, "
                 "built in %.1f s", args.num_items, table_bytes(served) / 1e9, item_parallel,
                 build_s)
        if args.method.startswith("MoLIVF"):
            nlist = args.ivf_nlist or max(64, int(4 * np.sqrt(args.num_items)))
            tb = time.perf_counter()
            ivf = build_rank_ivf(served, mesh, nlist=nlist, num_iters=args.ivf_iters,
                                 chunk=16_384)
            log.info("ivf build: nlist=%d cap=%d overflow=%d (%d shards) in %.1f s",
                     ivf.centroids.shape[0], ivf.buckets.shape[1], ivf.overflow.shape[0],
                     item_parallel, time.perf_counter() - tb)
            served = served._replace(ivf=ivf)
        if args.replicated:
            raw = get_top_k_raw(args.method)

            def topk(q_, user_ids=None):
                return raw(model, served, q_, args.k, user_ids)
        else:
            topk = make_sharded_top_k_fn(args.method, model, served, mesh, k=args.k,
                                         avg_top_k=min(4000, args.num_items), k_per_group=50)
        batch = next(ds.batches(args.batch_size, cfg.train.gr_output_length + 1,
                                shuffle=False, device=device))
        q = model.encode(batch.features)
        user_ids = batch.features.user_ids
        res = topk(q, user_ids=user_ids)
        sync()
        if args.check_against_chunked:
            _check(model, None if is_slab else state, q, user_ids, res, args, device)
        ms = timed_ms(lambda: topk(q, user_ids=user_ids), args.runs, device)
    summary = {
        "metric": f"sharded_{args.method}_top{args.k}_qps",
        "mode": "replicated" if args.replicated else "sharded",
        "num_items": args.num_items,
        "item_parallel": item_parallel,
        "value": args.batch_size / ms * 1e3,
        "unit": "queries/sec",
        "ms_per_batch": ms,
        "build_seconds": build_s,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    if distributed.is_primary():
        print(json.dumps(summary))
        return summary
    return None


def _check(model, state, q, user_ids, res, args, device) -> None:
    """The merged list against the streamed exact scan (`shard_bench.py:
    265-331`) over the whole `state`, or with None (a rank holds only its
    slab) over the corpus regenerated chunk by chunk: exact methods within
    the JAX CLI's score tolerance and id overlap, IVF's recall above
    `--ivf-recall-floor`."""
    embed = None
    if state is None:
        ids = torch.arange(1, args.num_items + 1, dtype=torch.int32, device=device)
        state = tk.MoLTopKState(ids, MoLItemTables(ids.new_zeros(0), None), ids.new_zeros(0))
        embed = embed_fn(model, min(args.num_items, 100_000), device)
    best_s, best_i = streamed_exact_top_k(model, state, q, user_ids, args.k,
                                          embed_chunk_fn=embed, chunk=tk.BUILD_CHUNK)
    got = res.ids.cpu().numpy()
    overlap = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / args.k
                             for a, b in zip(got, best_i)]))
    if args.method.startswith("MoLIVF"):
        log.info("check vs chunked exact scan: IVF recall@%d = %.4f", args.k, overlap)
        if overlap < args.ivf_recall_floor:
            raise AssertionError(f"IVF recall {overlap} below {args.ivf_recall_floor}")
        return
    int8, fused = "Int8" in args.method, "Fused" in args.method
    tol = 1e-1 if int8 else (5e-2 if fused else 2e-3)
    np.testing.assert_allclose(res.scores.float().cpu().numpy(), best_s, rtol=tol, atol=tol)
    log.info("check vs chunked exact scan: scores match, id overlap %.4f", overlap)
    min_overlap = 0.85 if int8 else (0.95 if fused else 0.99)
    if overlap <= min_overlap:
        raise AssertionError(f"id overlap {overlap} not above {min_overlap}")


if __name__ == "__main__":
    try:
        main()
    finally:
        distributed.shutdown()
