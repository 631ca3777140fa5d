"""One training step of each option this slice ports, against rails_tpu.

Each case is `synthetic-small` (2 blocks, D=32, batch 8, R=8) with one option
set: SASRec-MoL (f32, and bf16 as ml-20m-sasrec-mol's `bf16_training`),
HSTU-dot and SASRec-dot (the `*-dot` configs' settings), the in-batch
sampler, BCE, BCE with ratings, the loss's activation checkpoint, the rated
and combined preprocessors, the categorical embedding, and the MoL
`glu_silu_ln` and `none` combinations. JAX's `create_train_state` builds the
model; its weights reach the port through `state_dict_from_jax_params`.
Every dropout is 0 and both sides draw the same negatives (the local
sampler's ids, or the in-batch sampler's uniforms, fixed from numpy), so the
two compute the same function: the loss within rtol 1e-4 and each parameter
group's gradient within 1e-3 of its largest value (bf16: 1e-2 and 1e-1, the
bf16 step's contract). The JAX package's Pallas kernels run in interpret
mode; the port runs its plain versions on CPU tensors.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.core.config import get_experiment_config as jax_experiment_config
from rails_tpu.data import datasets as jax_datasets
from rails_tpu.losses.bce import bce_loss as jax_bce_loss
from rails_tpu.losses.bce import bce_loss_with_ratings as jax_bce_ratings
from rails_tpu.losses.sampled_softmax import get_weighted_loss as jax_weighted_loss
from rails_tpu.losses.sampled_softmax import sampled_softmax_loss as jax_ss_loss
from rails_tpu.train import loop as jax_loop
from rails_tpu_torch.compat.from_jax import state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.losses import samplers as port_samplers
from rails_tpu_torch.losses.sampled_softmax import sampled_softmax_loss
from rails_tpu_torch.train import loop as port_loop
from tests.test_torch_port_train_step import NO_DROPOUT, _configure, _fix_negatives, _port_batch

DOT = dict(similarity_type="DotProduct",
           train=dict(user_embedding_norm="l2_norm", temperature=0.05, item_l2_norm=True,
                      top_k_method="MIPSBruteForceTopK", loss_weights=()))
NUM_CATEGORIES = 7
# The HSTU options that train through the fused block (K4's plain version
# here, Pallas interpret in JAX), as ml-20m-hstu-dot and ml-20m-hstu-mol do;
# the rest take the XLA block path, which the JAX side compiles faster.
FUSED_TRAIN = dict(fused_train=True)
# name -> (config changes, bf16)
OPTIONS = {
    "sasrec_mol": (dict(model_type="SASRec"), False),
    "sasrec_mol_bf16": (dict(model_type="SASRec", mol=dict(bf16_training=True)), True),
    "hstu_dot": (dict(DOT, hstu=FUSED_TRAIN), False),
    "sasrec_dot": (dict(DOT, model_type="SASRec"), False),
    "in_batch": (dict(train=dict(sampling_strategy="in-batch")), False),
    "bce": (dict(train=dict(loss_module="BCELoss")), False),
    "bce_with_ratings": (dict(train=dict(loss_module="BCELossWithRatings")), False),
    "checkpoint": (dict(train=dict(loss_activation_checkpoint=True)), False),
    "rated": (dict(input_preprocessor_type="rated", hstu=FUSED_TRAIN), False),
    "combined": (dict(input_preprocessor_type="combined", hstu=FUSED_TRAIN), False),
    "categorical": (dict(embedding_module_type="categorical",
                         num_item_categories=NUM_CATEGORIES), False),
    "glu_silu_ln": (dict(mol=dict(gating_combination_type="glu_silu_ln")), False),
    "none": (dict(mol=dict(gating_combination_type="none", gating_item_fn=False)), False),
}
LOSS_RTOL, GRAD_TOL = 1e-4, 1e-3
BF16_LOSS_RTOL, BF16_GRAD_TOL = 1e-2, 1e-1


def _changes(option: str) -> dict:
    """NO_DROPOUT merged with the option's changes; SASRec's dropout off, the
    XLA block path unless the option trains the fused block."""
    change = OPTIONS[option][0]
    nested = dict(NO_DROPOUT, sasrec=dict(ffn_dropout_rate=0.0),
                  hstu=dict(NO_DROPOUT["hstu"], fused_train=False))
    out = {k: dict(nested.get(k, {}), **change.get(k, {})) for k in set(nested) | set(change)
           if isinstance(change.get(k, {}), dict)}
    flat = {k: v for k, v in change.items() if not isinstance(v, dict)}
    return out, flat


def _config(get, option: str):
    nested, flat = _changes(option)
    return _configure(get("synthetic-small"), nested).replace(**flat)


def _fix_draws(mp, cfg, shape_rows: int, all_ids: np.ndarray) -> None:
    """Both sides draw the same negatives: the local sampler's ids, or the
    uniforms of the in-batch sampler's inverse-CDF draw."""
    t = cfg.train
    r = 1 if t.loss_module == "BCELoss" else t.num_negatives
    shape = (r,) if t.shared_negatives and t.sampling_strategy == "local" else (shape_rows, r)
    rng = np.random.default_rng(5)
    if t.sampling_strategy == "local":
        _fix_negatives(mp, rng.choice(all_ids, size=shape).astype(np.int32))
        return
    u = rng.random(shape, dtype=np.float32)
    mp.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(u))
    mp.setattr(port_samplers.InBatchNegativesSampler, "sample",
               lambda self, state, generator, shape: self.sample_from_uniforms(
                   state, torch.from_numpy(u)))


def _jax_loss_and_grads(cfg, model, sampler, params, features):
    """JAX's loss dispatch (`rails_tpu/train/loop.py:140-167`) under
    `value_and_grad`, as `make_train_step` runs it."""
    t = cfg.train
    rngs = {"dropout": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)}

    def loss_fn(p):
        if t.loss_module == "SampledSoftmaxLoss":
            main, aux = model.apply(p, features, sampler, t.num_negatives, t.temperature, True,
                                    t.loss_activation_checkpoint,
                                    shared_negatives=t.shared_negatives, method=jax_ss_loss,
                                    rngs=rngs)
        else:
            fn = jax_bce_loss if t.loss_module == "BCELoss" else jax_bce_ratings
            main, aux = model.apply(p, features, sampler, t.temperature, True, method=fn,
                                    rngs=rngs)
        return jax_weighted_loss(main, aux, dict(t.loss_weights)), (main, aux)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


def _setup(option: str, mp):
    cfg = _config(jax_experiment_config, option)
    port_cfg = _config(port_config.get_experiment_config, option)
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.train_dataset.batches(
        batch_size=8, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    b, n = batch.features.ids.shape
    _fix_draws(mp, cfg, b * (n - 1), np.asarray(ds.all_item_ids))
    mapping = (np.arange(ds.max_item_id, dtype=np.int32) % NUM_CATEGORIES
               if cfg.embedding_module_type == "categorical" else None)
    model, state, _, sampler = jax_loop.create_train_state(
        cfg, ds.max_item_id, ds.all_item_ids, batch, item_id_to_category_id=mapping)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    port, port_state, port_step, _ = port_loop.create_train_state(
        port_cfg, ds.max_item_id, ds.all_item_ids, device="cpu",
        item_id_to_category_id=mapping)
    port.load_state_dict(state_dict_from_jax_params(params, port_cfg), strict=True)
    return cfg, port_cfg, model, sampler, state.params, batch, port, port_state, port_step


@pytest.mark.parametrize("option", list(OPTIONS))
def test_train_step_matches_jax(option, monkeypatch):
    cfg, port_cfg, model, sampler, params, batch, port, port_state, port_step = _setup(
        option, monkeypatch)
    features = jax_loop.scatter_target(batch.features, batch.target_ids)
    (total, (main, aux)), grads = _jax_loss_and_grads(cfg, model, sampler, params, features)
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, grads), port_cfg)
    _, metrics = port_step(port_state, _port_batch(batch), torch.Generator().manual_seed(0))
    bf16 = OPTIONS[option][1]
    loss_rtol, grad_tol = (BF16_LOSS_RTOL, BF16_GRAD_TOL) if bf16 else (LOSS_RTOL, GRAD_TOL)
    np.testing.assert_allclose(metrics["loss"].item(), float(main), rtol=loss_rtol)
    np.testing.assert_allclose(metrics["loss_incl_aux"].item(), float(total), rtol=loss_rtol)
    assert {f"aux/{k}" for k in aux} == {k for k in metrics if k.startswith("aux/")}
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want)
    groups: dict = {}
    for name, w in want.items():
        group = name.split(".")[0]
        err, scale = groups.get(group, (0.0, 0.0))
        groups[group] = (max(err, float((got[name] - w).abs().max())),
                         max(scale, float(w.abs().max())))
    for group, (err, scale) in groups.items():
        assert err <= grad_tol * scale, (group, err, scale)


def test_activation_checkpoint_changes_nothing(monkeypatch):
    """`loss_activation_checkpoint` recomputes the negatives' scoring chunk by
    chunk in the backward: the loss and every gradient equal the same step's
    without it, to the last bit but for the order in which the chunks'
    gradients add up: within 1e-6 of each tensor's largest value (measured
    at most 5e-7)."""
    cfg = _config(port_config.get_experiment_config, "checkpoint")
    num_items = 150
    all_ids = np.arange(1, num_items + 1, dtype=np.int32)
    model, _, _, sampler = port_loop.create_train_state(cfg, num_items, all_ids, device="cpu")
    from tests.test_torch_port_train_step import _port_batch as to_port
    ds = jax_datasets.get_reco_dataset(jax_experiment_config("synthetic-small").data)
    batch = to_port(next(ds.train_dataset.batches(
        batch_size=8, max_output_length=cfg.train.gr_output_length + 1, shuffle=False)))
    features = port_loop.scatter_target(batch.features, batch.target_ids)
    features = features._replace(ids=features.ids.clamp(max=num_items))
    b, n = features.ids.shape
    negatives = np.random.default_rng(3).choice(all_ids, (b * (n - 1), 8)).astype(np.int32)
    _fix_negatives(monkeypatch, negatives)
    results = []
    for checkpointed in (False, True):
        model.zero_grad(set_to_none=True)
        loss, _ = sampled_softmax_loss(model, features, sampler, 8, 1.0, True,
                                       torch.Generator().manual_seed(0), 1, checkpointed)
        loss.backward()
        results.append((loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}))
    (loss0, g0), (loss1, g1) = results
    torch.testing.assert_close(loss1, loss0, rtol=1e-6, atol=0.0)
    for name in g0:
        err = float((g1[name] - g0[name]).abs().max())
        scale = float(g0[name].abs().max())
        assert err <= 1e-6 * scale, (name, err, scale)
