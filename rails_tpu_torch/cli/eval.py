"""Checkpoint evaluation and retrieval benchmark CLI.

Counterpart of `rails_tpu/cli/eval.py`: build the model from its config,
restore a checkpoint (`train/checkpoint.py`), and evaluate a top-k method
over the eval users, every user once (the wrap-around tail trimmed),
optionally with the step's latency (`--include-eval-time`: k capped at 120,
k' at 200, CUDA events on the card) and the recall against the exact method
(`--eval-against-brute-force`: `MoLBruteForceTopK` for MoL,
`MIPSBruteForceTopK` for DotProduct). The CSV tail is JAX's: a header line
and a value line.

`--item-parallel N` shards the corpus over N processes, one a card
(`make_sharded_eval_step`): `torchrun --nproc-per-node N -m
rails_tpu_torch.cli.eval ... --item-parallel N`. The primary process prints.
`--save-serving-state DIR` writes the built corpus state and
`--load-serving-state DIR` serves from it without embedding the corpus
(`index/serving_state.py`).

Usage:
  python -m rails_tpu_torch.cli.eval --config ml-20m-hstu-mol \\
      --ckpt runs/<run>/ckpts/ep3 --top-k-method MoLBruteForceTopKFused \\
      [--include-eval-time] [--eval-against-brute-force]
CPU smoke: add `--device cpu`.
"""

from __future__ import annotations

import argparse
import itertools
import logging
import sys
from typing import Optional, Tuple

import torch

from rails_tpu_torch.cli.train import add_config_args, config_from_args

logger = logging.getLogger("rails_tpu_torch")


def item_parallel_mesh(p: argparse.ArgumentParser, item_parallel: int, device):
    """(mesh, device, whether this call joined the process group) for
    `--item-parallel`: a mesh of `item_parallel` ranks, one a process
    (torchrun's environment, or a group the caller joined), or no mesh and
    `device` for 1."""
    from rails_tpu_torch.core import distributed
    from rails_tpu_torch.core.device import resolve_device

    if item_parallel <= 1:
        return None, resolve_device(device), False
    from rails_tpu_torch.core.config import MeshConfig
    from rails_tpu_torch.core.mesh import make_mesh

    joined = not torch.distributed.is_initialized()
    distributed.initialize(device=device)
    if distributed.process_count() != item_parallel:
        if joined:
            distributed.shutdown()
        p.error(f"--item-parallel {item_parallel} needs that many processes, one a card "
                f"(torchrun --nproc-per-node {item_parallel}); this run has "
                f"{distributed.process_count()}")
    mesh = make_mesh(MeshConfig(item_parallel=item_parallel))
    logger.info("item-sharded retrieval over mesh %s", mesh)
    return mesh, distributed.device(), joined


def oracle_method(cfg) -> str:
    """The exact method of the config's similarity
    (`eval_from_checkpoint.py:395-421`)."""
    return "MoLBruteForceTopK" if cfg.similarity_type == "MoL" else "MIPSBruteForceTopK"


def main(argv=None) -> Optional[Tuple[str, str]]:
    """Evaluate; the primary process prints and returns the CSV header and
    value lines (None on the others)."""
    logging.basicConfig(stream=sys.stdout, level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_config_args(p)
    p.add_argument("--ckpt", default=None, help="checkpoint path (ckpts/ep*)")
    p.add_argument("--top-k-method", default=None)
    p.add_argument("--k", type=int, default=200)
    p.add_argument("--include-eval-time", action="store_true")
    p.add_argument("--eval-against-brute-force", action="store_true")
    p.add_argument("--limit-users", type=int, default=None)
    p.add_argument("--item-parallel", type=int, default=1,
                   help="shard the corpus over N processes, one a card (top-k merged)")
    p.add_argument("--save-serving-state", default=None, metavar="DIR",
                   help="write the built corpus tables for --load-serving-state")
    p.add_argument("--load-serving-state", default=None, metavar="DIR",
                   help="serve from saved corpus tables instead of embedding the corpus")
    p.add_argument("--sort-by-length", action="store_true",
                   help="length-sorted batches truncated to their own padded max (a "
                        "multiple of 64): the same metrics, a shorter encode")
    args = p.parse_args(argv)

    from rails_tpu_torch.core import distributed
    from rails_tpu_torch.data.datasets import get_reco_dataset
    from rails_tpu_torch.data.features import serving_pad_length, truncate_features
    from rails_tpu_torch.train import evaluation as ev
    from rails_tpu_torch.train.checkpoint import restore_checkpoint
    from rails_tpu_torch.train.loop import create_train_state

    cfg = config_from_args(p, args)
    t = cfg.train
    top_k_method = args.top_k_method or t.top_k_method
    if args.sort_by_length and args.item_parallel != 1:
        p.error("--sort-by-length with --item-parallel is not supported (the sharded step "
                "budgets k' for one sequence length)")
    if args.sort_by_length and args.limit_users:
        p.error("--sort-by-length with --limit-users would evaluate the N shortest-history "
                "users instead of the first N; drop one of the flags")
    mesh, dev, joined = item_parallel_mesh(p, args.item_parallel, args.device)
    try:
        ds = get_reco_dataset(cfg.data, args.data_root)
        max_output_length = t.gr_output_length + 1
        # Every user once: the tail batch wraps around and `num_examples`
        # drops its repeated rows.
        n_eval = len(ds.eval_dataset)
        if args.limit_users:
            n_eval = min(n_eval, args.limit_users)
        eval_batches = list(itertools.islice(
            ds.eval_dataset.batches(batch_size=t.eval_batch_size,
                                    max_output_length=max_output_length, shuffle=False,
                                    drop_last=False, sort_by_length=args.sort_by_length,
                                    device=dev),
            -(-n_eval // t.eval_batch_size)))
        seq_len = eval_batches[0].features.ids.shape[1]
        if args.sort_by_length:
            eval_batches = [b._replace(features=truncate_features(
                b.features, min(seq_len, serving_pad_length(int(b.features.lengths.max()), 64))))
                for b in eval_batches]
        model, state, _, _ = create_train_state(cfg, ds.max_item_id, ds.all_item_ids,
                                                device=dev)
        if args.ckpt:
            state, epoch, _ = restore_checkpoint(args.ckpt, state)
            logger.info("restored checkpoint %s (epoch %d)", args.ckpt, epoch)

        def corpus_state(method: str):
            return ev.get_eval_state(model, ds.all_item_ids, method, device=dev,
                                     item_l2_norm=t.item_l2_norm, l2_norm_eps=t.l2_norm_eps)

        if args.load_serving_state:
            from rails_tpu_torch.index.serving_state import load_serving_state

            eval_state = load_serving_state(args.load_serving_state, model)
            if eval_state.num_objects != len(ds.all_item_ids):
                raise SystemExit(f"serving state holds {eval_state.num_objects} items but the "
                                 f"dataset has {len(ds.all_item_ids)}: it was saved for "
                                 "another corpus or config")
            if eval_state.top_k_method != top_k_method:
                logger.info("serving state was saved for %s; using it (requested %s)",
                            eval_state.top_k_method, top_k_method)
                top_k_method = eval_state.top_k_method
        else:
            eval_state = corpus_state(top_k_method)
        if args.save_serving_state:
            from rails_tpu_torch.index.serving_state import save_serving_state

            logger.info("serving state saved to %s",
                        save_serving_state(args.save_serving_state, eval_state))
        k = min(args.k if not args.include_eval_time else 120, len(ds.all_item_ids))

        step = None
        if mesh is not None:
            step = ev.make_sharded_eval_step(model, eval_state, mesh, k, seq_len=seq_len)
        metrics, lat = ev.eval_metrics_from_batches(
            model, eval_state, eval_batches, k=k, include_eval_time=args.include_eval_time,
            num_examples=n_eval, step=step)
        summary = ev.summarize_metrics(metrics)

        recall = {}
        oracle = oracle_method(cfg)
        if args.eval_against_brute_force and top_k_method != oracle:
            exact_state = corpus_state(oracle)
            recall_k = min(200, len(ds.all_item_ids))
            approx_step = None
            if mesh is not None:
                approx_step = ev.make_sharded_eval_step(model, eval_state, mesh, recall_k,
                                                        seq_len=seq_len)
            recall = ev.recall_vs_exact(model, exact_state, eval_state, eval_batches,
                                        k=recall_k, approx_step=approx_step,
                                        num_examples=n_eval)
            summary.update(recall)
        primary = distributed.is_primary()
    finally:
        if joined:
            distributed.shutdown()

    keys = ["ndcg@10", "hr@10", "hr@50", "hr@100", "hr@200", "mrr"] + sorted(recall)
    if lat is not None:
        summary["EvalTimeAvgMs"] = lat.mean_ms
        summary["EvalTimeDevMs"] = lat.std_ms
        keys += ["EvalTimeAvgMs", "EvalTimeDevMs"]
    if not primary:
        return None
    header = ",".join(f"{top_k_method}_{key}" for key in keys)
    values = ",".join(f"{summary.get(key, float('nan')):.4f}" for key in keys)
    print(header)
    print(values)
    return header, values


if __name__ == "__main__":
    main()
