"""Training driver: epochs, the per-epoch eval, checkpoints and the metrics log.

Counterpart of `rails_tpu/train/driver.py` (`run_training`, `TrainResult`),
with its semantics:
- each epoch's batches are shuffled with seed `random_seed + epoch`, drop
  the incomplete tail and are assembled ahead by `prefetch_batches`;
- the train metrics go to the log every `eval_interval` steps, from the
  primary process;
- after every epoch the corpus is embedded again and evaluated with
  `eval_k = min(2500, X)` through one `make_eval_step_fn` step made once:
  every `full_eval_every_n`-th epoch over every eval user once (the
  wrap-around tail trimmed by `num_examples`), otherwise over the first
  `partial_eval_num_iters` shuffled batches;
- a checkpoint at every epoch > 0 that `save_ckpt_every_n` divides, and a
  final one;
- a resume continues at the checkpoint's epoch + 1, with its `batch_id`.

A run resumed from a checkpoint trains what the uninterrupted run trains:
the checkpoint carries the train step's generator (`train/checkpoint.py`),
and the data order depends on the epoch alone.

One process drives one card and uses no mesh. A run of several processes
(`core.distributed.initialize` first: torchrun, or the train CLI's
`--coordinator`) trains data-parallel over a mesh of `cfg.mesh`
(`make_train_step(mesh=)`): every rank starts from rank 0's weights, seeds
its generator alike, takes its shard of each epoch
(`SequenceDataset.batches(num_shards, shard_index)`) and holds the same
replica after every step, so each rank evaluates its shard of the users
with its own replica (JAX fetches the replicated parameters to the host
for that, `fetch_replicated`) and the metrics all-reduce
(`summarize_metrics`). The primary process writes the log and the
checkpoints.
"""

from __future__ import annotations

import itertools
import logging
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch

from rails_tpu_torch.core import distributed as dist
from rails_tpu_torch.core.config import ExperimentConfig
from rails_tpu_torch.core.device import resolve_device
from rails_tpu_torch.data.datasets import RecoDataset, get_reco_dataset, prefetch_batches
from rails_tpu_torch.train import evaluation as ev
from rails_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from rails_tpu_torch.train.loop import TrainState, create_train_state
from rails_tpu_torch.train.metrics import MetricsWriter

logger = logging.getLogger("rails_tpu_torch")


@dataclass
class TrainResult:
    state: TrainState
    final_metrics: Dict[str, float]
    model: object


def run_training(
    cfg: ExperimentConfig,
    data_root: str = ".",
    workdir: Optional[str] = None,
    restore_from: Optional[str] = None,
    dataset: Optional[RecoDataset] = None,
    num_epochs: Optional[int] = None,
    item_id_to_category_id: Optional[np.ndarray] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> TrainResult:
    """Train `cfg` for `num_epochs` (default `cfg.train.num_epochs`) on
    `device` (the card unless the caller passes "cpu"; a rank's own device
    in a run of several processes). With a `workdir` the run writes
    `<workdir>/<name>-<config hash>/metrics.jsonl` and its checkpoints
    under `ckpts/`."""
    t = cfg.train
    ds = dataset or get_reco_dataset(cfg.data, data_root)
    max_output_length = t.gr_output_length + 1
    n_proc, rank = dist.process_count(), dist.process_index()
    mesh = None
    if n_proc > 1:
        from rails_tpu_torch.core.mesh import make_mesh

        dev = dist.device()
        mesh = make_mesh(cfg.mesh)
        logger.info("training data-parallel over mesh %s (%d processes)", mesh, n_proc)
    else:
        dev = resolve_device(device)
    model, state, train_step, _ = create_train_state(
        cfg, ds.max_item_id, ds.all_item_ids, device=dev,
        item_id_to_category_id=item_id_to_category_id, mesh=mesh,
    )
    generator = torch.Generator(device=dev).manual_seed(t.random_seed)

    run_dir = os.path.join(workdir, f"{cfg.name}-{cfg.config_hash()}") if workdir else None
    ckpt_dir = os.path.join(run_dir, "ckpts") if run_dir else None
    writer = MetricsWriter(run_dir if dist.is_primary() else None)
    if ckpt_dir and dist.is_primary():
        os.makedirs(ckpt_dir, exist_ok=True)

    def checkpoint(epoch: int) -> None:
        save_checkpoint(ckpt_dir, state, epoch, batch_id, generator,
                        config_json=cfg.to_json(), debug_str=cfg.model_debug_str())

    epoch0, batch_id = 0, 0
    if restore_from:
        state, prev_epoch, batch_id = restore_checkpoint(restore_from, state, generator)
        epoch0 = prev_epoch + 1
        logger.info("restored %s; resuming at epoch %d", restore_from, epoch0)

    epochs = num_epochs if num_epochs is not None else t.num_epochs
    final_metrics: Dict[str, float] = {}
    last_log = time.time()
    num_items = len(ds.all_item_ids)
    eval_k = min(2500, num_items)
    # One step for every epoch: each epoch's eval state is passed to it.
    eval_step_fn = ev.make_eval_step_fn(model, t.top_k_method, eval_k, num_items)

    for epoch in range(epoch0, epochs):
        for batch in prefetch_batches(ds.train_dataset.batches(
                batch_size=t.local_batch_size, max_output_length=max_output_length,
                shuffle=True, seed=t.random_seed + epoch, drop_last=True,
                num_shards=n_proc, shard_index=rank, device=dev)):
            state, metrics = train_step(state, batch, generator)
            if batch_id % t.eval_interval == 0 and dist.is_primary():
                m = {k: float(v) for k, v in metrics.items()}
                writer.write(batch_id, m, prefix="train")
                logger.info("epoch %d batch %d (%.2fs): loss %.6f", epoch, batch_id,
                            time.time() - last_log, m["loss"])
                last_log = time.time()
            batch_id += 1

        is_full = epoch % t.full_eval_every_n == 0
        eval_state = ev.get_eval_state(model, ds.all_item_ids, t.top_k_method, device=dev,
                                       item_l2_norm=t.item_l2_norm, l2_norm_eps=t.l2_norm_eps)
        # drop_last=False for partial evals too: a small shard of users
        # could otherwise give one process no batch at all.
        eval_batches = ds.eval_dataset.batches(
            batch_size=t.eval_batch_size, max_output_length=max_output_length, shuffle=True,
            seed=t.random_seed + epoch, drop_last=False, num_shards=n_proc, shard_index=rank,
            device=dev)
        n_eval = len(range(rank, len(ds.eval_dataset), n_proc)) if is_full else None
        if not is_full:
            eval_batches = itertools.islice(eval_batches, t.partial_eval_num_iters)
        metrics_arrays, _ = ev.eval_metrics_from_batches(
            model, eval_state, eval_batches, k=eval_k, step_fn=eval_step_fn,
            num_examples=n_eval)
        final_metrics = ev.summarize_metrics(metrics_arrays)
        del eval_state   # its tables leave the card while the next epoch trains
        if dist.is_primary():
            writer.write(epoch, final_metrics, prefix="eval_epoch")
            logger.info("eval @ epoch %d: NDCG@10 %.4f HR@10 %.4f HR@50 %.4f MRR %.4f", epoch,
                        *(final_metrics.get(k, float("nan"))
                          for k in ("ndcg@10", "hr@10", "hr@50", "mrr")))
        if ckpt_dir and epoch > 0 and epoch % t.save_ckpt_every_n == 0:
            checkpoint(epoch)

    if ckpt_dir:
        checkpoint(epochs - 1 if epochs else 0)
    writer.close()
    return TrainResult(state=state, final_metrics=final_metrics, model=model)
