"""Top-k method sweep CLI.

Counterpart of `rails_tpu/cli/sweep.py`: one model build and one exact
corpus state, then per method of a dataset's menu its metrics, its recall
against the exact method (`recall_vs_exact`) and, unless `--no-eval-time`,
its latency with every batch timed (`eval_metrics_from_batches`); one CSV
row per method. Methods whose budget exceeds the corpus are dropped
(`index/factory.py:parse_top_k_budgets`), `--extra-algorithms` appends
others, `--menu` picks a dataset's menu regardless of the config's dataset.

Usage:
  python -m rails_tpu_torch.cli.sweep --config ml-20m-hstu-mol --ckpt runs/<run>/ckpts/ep3 \
      [--menu synthetic] [--output-csv sweep.csv]
N cards, the corpus sharded: torchrun --nproc-per-node N -m rails_tpu_torch.cli.sweep ...
--item-parallel N. CPU smoke: add `--device cpu`.
"""

from __future__ import annotations

import argparse
import itertools
import logging
import sys
from typing import Dict, List, Optional

from rails_tpu_torch.cli.train import add_config_args, config_from_args

# Method menus per dataset (the reference's `eval_batch.py:40-71`), with the
# fused brute force (and its approximate select), int8 tables, IVF and tile
# top-k added; `MoLIVFTopK` takes the reference's `MoLNaiveFaissTopK5` slot.
CONFIGURED_ALGORITHMS: Dict[str, List[str]] = {
    "ml-1m": [
        "MoLBruteForceTopK",
        "MoLBruteForceTopKFused", "MoLBruteForceTopKFusedApprox",
        "MoLBruteForceTopKFusedInt8",
        "MoLNaiveTopK5", "MoLNaiveTopK10", "MoLNaiveTopK50", "MoLNaiveTopK100",
        "MoLAvgTopK200", "MoLAvgTopK500", "MoLAvgTopK1000",
        "MoLCombTopK5_200", "MoLCombTopK50_500", "MoLCombTopK100_1000",
        "MoLIVFTopK8", "MoLTileTopK8",
    ],
    "ml-20m": [
        "MoLBruteForceTopK",
        "MoLBruteForceTopKFused", "MoLBruteForceTopKFusedApprox",
        "MoLBruteForceTopKFusedInt8",
        "MoLNaiveTopK5", "MoLNaiveTopK10", "MoLNaiveTopK50", "MoLNaiveTopK100",
        "MoLAvgTopK200", "MoLAvgTopK500", "MoLAvgTopK1000", "MoLAvgTopK2000",
        "MoLCombTopK5_200", "MoLCombTopK50_500", "MoLCombTopK100_1000",
        "MoLIVFTopK16", "MoLTileTopK8",
    ],
    "amzn-books": [
        "MoLBruteForceTopK",
        "MoLBruteForceTopKFused", "MoLBruteForceTopKFusedApprox",
        "MoLBruteForceTopKFusedInt8",
        "MoLNaiveTopK5", "MoLNaiveTopK10", "MoLNaiveTopK50",
        "MoLAvgTopK500", "MoLAvgTopK1000", "MoLAvgTopK2000", "MoLAvgTopK4000",
        "MoLCombTopK5_200", "MoLCombTopK50_500", "MoLCombTopK100_1000",
        "MoLIVFTopK16", "MoLTileTopK8",
    ],
    "synthetic": [
        "MoLBruteForceTopK",
        "MoLBruteForceTopKFused",
        "MoLBruteForceTopKFusedInt8",
        "MoLNaiveTopK10", "MoLNaiveTopK50",
        "MoLAvgTopK200", "MoLAvgTopK500",
        "MoLCombTopK10_200",
        "MoLIVFTopK4", "MoLTileTopK4",
    ],
}


def run_sweep(
    cfg,
    ds,
    model,
    algorithms: List[str],
    eval_batches,
    k: int = 120,
    include_eval_time: bool = True,
    num_examples: Optional[int] = None,
    mesh=None,
) -> List[Dict[str, float]]:
    """One row per method: hr@10, hr@50, ndcg@10, mrr, its recall@k against
    the exact method and its latency. The corpus states build on the model's
    device; with an item `mesh` every method serves sharded."""
    from rails_tpu_torch.train import evaluation as ev

    t = cfg.train
    dev = next(model.parameters()).device

    def corpus_state(method: str):
        return ev.get_eval_state(model, ds.all_item_ids, method, device=dev,
                                 item_l2_norm=t.item_l2_norm, l2_norm_eps=t.l2_norm_eps)

    exact_state = corpus_state("MoLBruteForceTopK")
    seq_len = eval_batches[0].features.ids.shape[1]
    kk = min(k, len(ds.all_item_ids))
    rows = []
    for alg in algorithms:
        state = exact_state if alg == "MoLBruteForceTopK" else corpus_state(alg)
        step = None
        if mesh is not None:
            step = ev.make_sharded_eval_step(model, state, mesh,
                                             min(kk, 120) if include_eval_time else kk,
                                             seq_len=seq_len)
        metrics, lat = ev.eval_metrics_from_batches(
            model, state, eval_batches, k=kk, include_eval_time=include_eval_time,
            timing_fraction=1.0 if include_eval_time else 0.0, num_examples=num_examples,
            step=step)
        summary = ev.summarize_metrics(metrics)
        row = {"algorithm": alg, **{key: summary[key]
                                    for key in ("hr@10", "hr@50", "ndcg@10", "mrr")}}
        if alg != "MoLBruteForceTopK":
            approx_step = None
            if mesh is not None:
                approx_step = ev.make_sharded_eval_step(model, state, mesh, kk, seq_len=seq_len)
            row.update(ev.recall_vs_exact(model, exact_state, state, eval_batches, k=kk,
                                          approx_step=approx_step, num_examples=num_examples))
        if lat is not None:
            row["EvalTimeAvgMs"] = lat.mean_ms
            row["EvalTimeDevMs"] = lat.std_ms
        rows.append(row)
        logging.info("sweep %s: %s", alg, row)
    return rows


def main(argv=None) -> Optional[List[Dict[str, float]]]:
    """Run the sweep; the primary process prints the CSV and returns the rows
    (None on the others)."""
    logging.basicConfig(stream=sys.stdout, level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_config_args(p)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--limit-users", type=int, default=8192)
    p.add_argument("--no-eval-time", action="store_true")
    p.add_argument("--output-csv", default=None)
    p.add_argument("--item-parallel", type=int, default=1,
                   help="shard the corpus over N processes, one a card (top-k merged)")
    p.add_argument("--extra-algorithms", nargs="*", default=[],
                   help="methods to append to the menu (e.g. MoLCertTopK4096 MoLIVFTopK16)")
    p.add_argument("--menu", default=None, choices=sorted(CONFIGURED_ALGORITHMS),
                   help="this dataset's menu regardless of the config's dataset")
    args = p.parse_args(argv)

    from rails_tpu_torch.cli.eval import item_parallel_mesh
    from rails_tpu_torch.core import distributed
    from rails_tpu_torch.data.datasets import get_reco_dataset
    from rails_tpu_torch.index.factory import parse_top_k_budgets
    from rails_tpu_torch.train.checkpoint import restore_checkpoint
    from rails_tpu_torch.train.loop import create_train_state

    cfg = config_from_args(p, args)
    mesh, dev, joined = item_parallel_mesh(p, args.item_parallel, args.device)
    try:
        ds = get_reco_dataset(cfg.data, args.data_root)
        t = cfg.train
        n_eval = min(len(ds.eval_dataset), args.limit_users)
        eval_batches = list(itertools.islice(
            ds.eval_dataset.batches(batch_size=t.eval_batch_size,
                                    max_output_length=t.gr_output_length + 1, shuffle=False,
                                    drop_last=False, device=dev),
            -(-n_eval // t.eval_batch_size)))
        model, state, _, _ = create_train_state(cfg, ds.max_item_id, ds.all_item_ids,
                                                device=dev)
        if args.ckpt:
            restore_checkpoint(args.ckpt, state)
        algorithms = CONFIGURED_ALGORITHMS.get(args.menu or cfg.data.dataset_name,
                                               CONFIGURED_ALGORITHMS["synthetic"])
        # A budget above the corpus size only clamps to brute force under an
        # approximate name: drop such methods, whatever their spelling.
        x = len(ds.all_item_ids)
        algorithms = [a for a in algorithms
                      if not any(v > x for key, v in parse_top_k_budgets(a).items()
                                 if key in ("avg_top_k", "k_per_group"))]
        algorithms += [a for a in args.extra_algorithms if a not in algorithms]
        rows = run_sweep(cfg, ds, model, algorithms, eval_batches,
                         include_eval_time=not args.no_eval_time, num_examples=n_eval,
                         mesh=mesh)
        primary = distributed.is_primary()
    finally:
        if joined:
            distributed.shutdown()
    if not primary:
        return None
    cols = sorted({k for r in rows for k in r})
    lines = [",".join(cols)] + [",".join(str(r.get(c, "")) for c in cols) for r in rows]
    out = "\n".join(lines)
    print(out)
    if args.output_csv:
        with open(args.output_csv, "w") as f:
            f.write(out + "\n")
    return rows


if __name__ == "__main__":
    main()
