"""Training step: sampled-softmax loss -> gradients -> fused AdamW.

Counterpart of `rails_tpu/train/loop.py`: `model_dtype` (:71-77),
`make_optimizer` (:38-61), `scatter_target` (:64-68), `make_train_step`
(:132-193, with its sampler choice and loss dispatch, :115-167) and
`create_train_state` (:196-225). The training state is
(model, optimizer, step): the model's parameters and the optimizer's moments
are updated in place. One explicit `torch.Generator` on the model's device
draws, per step, the HSTU blocks' dropout seed, the negatives and every
other dropout. The step is a plain Python function: no jit, no CUDA graph.
The losses are `SampledSoftmaxLoss`, `BCELoss` and `BCELossWithRatings`; the
samplers the local and the in-batch one.

Data parallelism (JAX: the same jitted step over a batch sharded on the
mesh's `data` axis, `loop.py:7-10`): `make_train_step(..., mesh=mesh)` gives
each rank its rows of the global batch under a `RowShard`, so the rank draws
the global batch's negatives and dropout masks and keeps its rows, numbers
the hash dropout streams by global row, and divides its loss terms by the
global batch's weights; the gradients then sum over the batch group in one
all-reduce of a flat buffer in parameter order, and K7 updates every rank's
replica from the same sums, so the replicas stay bit-equal. The step equals
the single-process step over the global batch up to the order of the sums.
Every rank seeds its generator alike and starts from the same weights
(`core.mesh.replicate`).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from rails_tpu_torch.core.config import ExperimentConfig
from rails_tpu_torch.core.distributed import RowShard, row_shard
from rails_tpu_torch.core.device import resolve_device
from rails_tpu_torch.data.features import Batch, SequentialFeatures
from rails_tpu_torch.losses.bce import bce_loss, bce_loss_with_ratings
from rails_tpu_torch.losses.sampled_softmax import get_weighted_loss, sampled_softmax_loss
from rails_tpu_torch.losses.samplers import InBatchNegativesSampler, LocalNegativesSampler
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.train.fused_adamw import FusedAdamW, linear_schedule

_INT32_MAX = 2 ** 31 - 1


class TrainState(NamedTuple):
    model: SequentialRecommender
    optimizer: FusedAdamW
    step: int


def model_dtype(cfg: ExperimentConfig) -> torch.dtype:
    """bf16 compute when the config enables it (`main_module_bf16` / MoL
    `bf16_training`), f32 otherwise; parameters stay f32."""
    if cfg.train.main_module_bf16 or cfg.mol.bf16_training:
        return torch.bfloat16
    return torch.float32


def make_optimizer(cfg: ExperimentConfig, model: SequentialRecommender) -> FusedAdamW:
    """AdamW(b1, b2, eps=1e-8, weight_decay) with the optional linear warmup;
    with `fused_optimizer` the large leaves go through K7."""
    t = cfg.train
    if t.num_warmup_steps > 0:
        schedule = linear_schedule(t.learning_rate / t.num_warmup_steps, t.learning_rate,
                                   t.num_warmup_steps)
    else:
        schedule = t.learning_rate
    return FusedAdamW(
        dict(model.named_parameters()), schedule, b1=t.beta1, b2=t.beta2, eps=1e-8,
        weight_decay=t.weight_decay,
        min_fused_elements=(1 << 21) if t.fused_optimizer else None,
    )


def scatter_target(features: SequentialFeatures, target_ids: torch.Tensor) -> SequentialFeatures:
    """Place the target id at position `length` (`train.py:394-398`)."""
    ids = features.ids.clone()
    rows = torch.arange(ids.shape[0], device=ids.device)
    ids[rows, features.lengths.long()] = target_ids
    return features._replace(ids=ids)


def _make_sampler(cfg: ExperimentConfig, all_item_ids: np.ndarray, device):
    t = cfg.train
    if t.sampling_strategy == "local":
        ids = torch.as_tensor(np.asarray(all_item_ids, dtype=np.int32), device=device)
        return LocalNegativesSampler(ids, t.item_l2_norm, t.l2_norm_eps)
    if t.sampling_strategy == "in-batch":
        return InBatchNegativesSampler(t.item_l2_norm, t.l2_norm_eps)
    raise ValueError(f"Unknown sampling_strategy {t.sampling_strategy!r}")


def _sum_over(tensors, group) -> list:
    """The tensors (None kept) summed over `group` in one all-reduce of a
    flat f32 buffer, in the given order."""
    live = [t for t in tensors if t is not None]
    flat = torch.cat([t.reshape(-1).float() for t in live])
    dist.all_reduce(flat, group=group)
    out, i = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        out.append(flat[i : i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def make_train_step(
    cfg: ExperimentConfig, model: SequentialRecommender, optimizer: FusedAdamW,
    sampler, mesh=None,
) -> Callable:
    """fn(state, batch, generator) -> (state, metrics) with metrics
    {"loss", "loss_incl_aux", "aux/<name>"} as detached scalars. The
    gradients stay in the parameters' `.grad` after the step. With a `mesh`,
    `batch` is this rank's rows of the global batch (`core.mesh.shard_batch`
    or its own epoch shard), the step data-parallel over the mesh's batch
    axes, and the metrics the global batch's on every rank."""
    t = cfg.train
    if t.loss_module == "SampledSoftmaxLoss":
        def apply_loss(features, generator, seed0):
            return sampled_softmax_loss(
                model, features, sampler, t.num_negatives, t.temperature, True, generator, seed0,
                t.loss_activation_checkpoint, t.shared_negatives)
    elif t.loss_module in ("BCELoss", "BCELossWithRatings"):
        loss_fn = bce_loss if t.loss_module == "BCELoss" else bce_loss_with_ratings

        def apply_loss(features, generator, seed0):
            return loss_fn(model, features, sampler, t.temperature, True, generator, seed0)
    else:
        raise ValueError(f"Unknown loss_module {t.loss_module!r}")
    loss_weights = dict(t.loss_weights)
    params = dict(model.named_parameters())
    group = None
    if mesh is not None:
        from rails_tpu_torch.core.mesh import batch_group, batch_rank, batch_size

        group, rank, ranks = batch_group(mesh), batch_rank(mesh), batch_size(mesh)

    def train_step(state: TrainState, batch: Batch, generator: torch.Generator
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        features = scatter_target(batch.features, batch.target_ids)
        seed0 = int(torch.randint(0, _INT32_MAX, (1,), generator=generator,
                                  device=generator.device).item())
        model.zero_grad(set_to_none=True)
        shard = None
        if group is not None:
            b, n = (int(v) for v in features.ids.shape)
            shard = RowShard(rank * b, b, ranks * b, group, (1, n - 1))
        with row_shard(shard):
            main_loss, aux = apply_loss(features, generator, seed0)
            total = get_weighted_loss(main_loss, aux, loss_weights)
            total.backward()
        grads = {k: p.grad for k, p in params.items()}
        metrics = {"loss": main_loss.detach(), "loss_incl_aux": total.detach()}
        metrics.update({f"aux/{k}": v.detach() for k, v in aux.items()})
        if shard is not None:
            # The ranks' terms sum to the global batch's gradients and losses;
            # `.grad` holds the sums, as after a single-process step.
            for g, total_g in zip(grads.values(), _sum_over(list(grads.values()), group)):
                if g is not None:
                    g.copy_(total_g)
            metrics = dict(zip(metrics, _sum_over(
                [torch.as_tensor(v, device=main_loss.device).float() for v in metrics.values()],
                group)))
        optimizer.step(grads)
        return TrainState(state.model, state.optimizer, state.step + 1), metrics

    return train_step


def create_train_state(
    cfg: ExperimentConfig,
    num_items: int,
    all_item_ids: np.ndarray,
    seed: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    item_id_to_category_id: Optional[np.ndarray] = None,
    mesh=None,
):
    """Returns (model, state, train_step, sampler) on `device`, the card
    unless the caller passes "cpu". Weights are drawn from `seed`
    (`cfg.train.random_seed` by default); `item_id_to_category_id` serves the
    categorical embedding. With a `mesh`, rank 0's weights are broadcast to
    every rank and the step is data-parallel (`make_train_step`)."""
    device = resolve_device(device)
    seed = cfg.train.random_seed if seed is None else seed
    model = SequentialRecommender(
        cfg, num_items, compute_dtype=model_dtype(cfg), device=device,
        generator=torch.Generator().manual_seed(seed),
        item_id_to_category_id=item_id_to_category_id,
    )
    if mesh is not None:
        from rails_tpu_torch.core.mesh import replicate

        replicate(model, mesh)
    optimizer = make_optimizer(cfg, model)
    sampler = _make_sampler(cfg, all_item_ids, device)
    state = TrainState(model, optimizer, 0)
    return model, state, make_train_step(cfg, model, optimizer, sampler, mesh), sampler
