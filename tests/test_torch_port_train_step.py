"""The rails_tpu_torch training step vs rails_tpu's `make_train_step`.

A `synthetic-small` model with `fused_train=True` (batch 8, 2 blocks, D=32,
N=35) is built by `rails_tpu.train.loop.create_train_state`; its weights and
optimizer state reach the port through `compat.from_jax`. Both sides draw the
same negatives (each side's `LocalNegativesSampler.sample` is patched to
return one fixed numpy draw), and every dropout is 0, so the two steps
compute the same function. The linear-dropout hash stream is held bit for
bit by `test_torch_port_train_kernels.py`. The JAX package's Pallas kernels
run in interpret mode; the port runs its plain versions on CPU tensors.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.core.config import get_experiment_config
from rails_tpu.data import datasets as jax_datasets
from rails_tpu.losses import samplers as jax_samplers
from rails_tpu.losses.sampled_softmax import get_weighted_loss as jax_weighted_loss
from rails_tpu.losses.sampled_softmax import sampled_softmax_loss as jax_loss
from rails_tpu.train import loop as jax_loop
from rails_tpu_torch.compat.from_jax import adamw_state_from_jax, state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.data.features import Batch, SequentialFeatures
from rails_tpu_torch.losses import samplers as port_samplers
from rails_tpu_torch.losses.sampled_softmax import sampled_softmax_loss
from rails_tpu_torch.models import preprocessors
from rails_tpu_torch.similarity import layers, mol
from rails_tpu_torch.train import loop as port_loop

NO_DROPOUT = dict(
    train=dict(dropout_rate=0.0, local_batch_size=8, num_negatives=8),
    hstu=dict(fused_train=True, linear_dropout_rate=0.0),
    mol=dict(query_dropout_rate=0.0, uid_dropout_rate=0.0, item_dropout_rate=0.0,
             softmax_dropout_rate=0.0, gating_qi_dropout_rate=0.0, gating_item_dropout_rate=0.0),
    data=dict(synthetic_num_users=64, synthetic_num_items=150),
)


def _configure(cfg, changes):
    return cfg.replace(**{k: getattr(cfg, k).replace(**v) for k, v in changes.items()})


def _port_batch(batch) -> Batch:
    feats = SequentialFeatures(*(torch.from_numpy(np.array(f)) for f in batch.features))
    return Batch(feats, torch.from_numpy(np.array(batch.target_ids)),
                 torch.from_numpy(np.array(batch.target_ratings)))


@pytest.fixture(scope="module")
def step_setup():
    """Both configs, the batch, the fixed negatives and the JAX train state."""
    cfg = _configure(get_experiment_config("synthetic-small"), NO_DROPOUT)
    port_cfg = _configure(port_config.get_experiment_config("synthetic-small"), NO_DROPOUT)
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.train_dataset.batches(
        batch_size=8, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    b, n = batch.features.ids.shape
    negatives = np.random.default_rng(5).choice(
        ds.all_item_ids, size=(b * (n - 1), cfg.train.num_negatives)).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp:
        _fix_negatives(mp, negatives)
        model, state, train_step, sampler = jax_loop.create_train_state(
            cfg, ds.max_item_id, ds.all_item_ids, batch)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    opt_state = jax.tree_util.tree_map(np.asarray, state.opt_state)
    return dict(cfg=cfg, port_cfg=port_cfg, ds=ds, batch=batch, model=model, state=state,
                train_step=train_step, sampler=sampler, params=params, opt_state=opt_state,
                negatives=negatives)


def _fix_negatives(mp, negatives: np.ndarray) -> None:
    """Both samplers return the same fixed (M, R) draw."""
    mp.setattr(jax_samplers.LocalNegativesSampler, "sample",
               lambda self, rng, shape: jnp.asarray(negatives))
    mp.setattr(port_samplers.LocalNegativesSampler, "sample",
               lambda self, generator, shape: torch.from_numpy(negatives))


def _port_state(s):
    model, state, train_step, _ = port_loop.create_train_state(
        s["port_cfg"], s["ds"].max_item_id, s["ds"].all_item_ids, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(s["params"], s["port_cfg"]), strict=True)
    state.optimizer.state = adamw_state_from_jax(s["opt_state"])
    return model, state, train_step


def test_train_step_loss_aux_and_grads_match_jax(step_setup, monkeypatch):
    s = step_setup
    _fix_negatives(monkeypatch, s["negatives"])
    cfg, model = s["cfg"], s["model"]
    features = jax_loop.scatter_target(s["batch"].features, s["batch"].target_ids)

    @jax.jit
    def loss_and_grads(params):
        def loss_fn(p):
            main, aux = model.apply(p, features, s["sampler"], cfg.train.num_negatives,
                                    cfg.train.temperature, True, False, method=jax_loss,
                                    rngs={"dropout": jax.random.PRNGKey(0),
                                          "sampler": jax.random.PRNGKey(1)})
            return jax_weighted_loss(main, aux, dict(cfg.train.loss_weights)), (main, aux)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (total, (main, aux)), grads = loss_and_grads(s["params"])
    want_grads = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, grads),
                                            s["port_cfg"])

    port, state, train_step = _port_state(s)
    _, metrics = train_step(state, _port_batch(s["batch"]), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(metrics["loss"].item(), float(main), rtol=1e-4)
    np.testing.assert_allclose(metrics["loss_incl_aux"].item(), float(total), rtol=1e-4)
    assert set(aux) == {"uid_embedding_l2_norm", "mi_loss"}
    for key in aux:
        np.testing.assert_allclose(metrics[f"aux/{key}"].item(), float(aux[key]), rtol=1e-4,
                                   err_msg=key)
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want_grads)
    for name, want in want_grads.items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=5e-3, atol=1e-4,
                                   err_msg=name)


def test_three_steps_match_jax(step_setup, monkeypatch):
    """Three optimizer steps from the same (params, mu, nu, count)."""
    s = step_setup
    _fix_negatives(monkeypatch, s["negatives"])
    state, rng = s["state"], jax.random.PRNGKey(0)
    want = []
    for _ in range(3):
        state, m = s["train_step"](state, s["batch"], rng)
        want.append(float(m["loss"]))
    _, port_state, train_step = _port_state(s)
    batch, gen = _port_batch(s["batch"]), torch.Generator().manual_seed(0)
    got = []
    for _ in range(3):
        port_state, m = train_step(port_state, batch, gen)
        got.append(m["loss"].item())
    assert port_state.step == 3 and port_state.optimizer.state.count == 3
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[2] < got[0]


def test_dropout_sites_in_training_and_eval(monkeypatch):
    """Each dropout site of the flax model (input, query, uid, item, softmax,
    gating-qi) zeroes about its rate and scales what it keeps by
    1/(1 - rate) in training; in eval none of them runs."""
    cfg = port_config.get_experiment_config("synthetic-small")
    rates = dict(query_dropout_rate=0.3, uid_dropout_rate=0.5, item_dropout_rate=0.1,
                 softmax_dropout_rate=0.2, gating_qi_dropout_rate=0.25)
    cfg = cfg.replace(mol=cfg.mol.replace(**rates), hstu=cfg.hstu.replace(fused_train=True))
    seen = []
    real = layers.dropout

    def recording(x, rate, generator):
        out = real(x, rate, generator)
        if rate > 0:
            live = x != 0
            kept = live & (out != 0)
            seen.append(rate)
            assert abs(1.0 - kept.sum().item() / live.sum().item() - rate) < 0.05, rate
            torch.testing.assert_close(out[kept], x[kept] / (1.0 - rate))
        return out

    for module in (layers, mol, preprocessors):
        monkeypatch.setattr(module, "dropout", recording)
    num_items = 500
    all_ids = np.arange(1, num_items + 1, dtype=np.int32)
    model, state, _, sampler = port_loop.create_train_state(cfg, num_items, all_ids,
                                                            device="cpu")
    rng = np.random.default_rng(0)
    b, n = 16, cfg.max_seq_len_padded
    lengths = rng.integers(8, n - 1, b)
    ids = np.where(np.arange(n)[None] <= lengths[:, None], rng.integers(1, num_items, (b, n)), 0)
    ts = np.sort(rng.integers(1, 1 << 20, (b, n)), axis=1) * (ids > 0)
    feats = SequentialFeatures(*(torch.from_numpy(a.astype(np.int32)) for a in (
        lengths, ids, ts, np.ones((b, n)), np.arange(b))))
    sampled_softmax_loss(model, feats, sampler, 32, 1.0, True, torch.Generator().manual_seed(1),
                         seed0=3)
    want = {cfg.train.dropout_rate, *rates.values()}
    assert set(seen) == want, (seen, want)
    seen.clear()
    with torch.no_grad():
        q = model.encode(feats)
        a, _ = model.similarity_fn(q, model.get_item_embeddings(feats.ids[:, :5]), feats.user_ids)
        b_, _ = model.similarity_fn(q, model.get_item_embeddings(feats.ids[:, :5]), feats.user_ids)
    assert seen == [] and torch.equal(a, b_)
