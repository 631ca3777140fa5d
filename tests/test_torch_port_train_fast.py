"""The rails_tpu_torch `-fast` training step (shared negatives, the fused MoL
loss K5 and the K6 embedding-gradient scatter) vs rails_tpu's.

A `synthetic-small` model with `fused_train`, `shared_negatives`,
`fused_mol_loss` and `pallas_scatter_grad` on (batch 8, 2 blocks, D=32, N=35)
is built by `rails_tpu.train.loop.create_train_state`; its weights and
optimizer state reach the port through `compat.from_jax`. Both sides draw the
same (R,) negatives (each side's `LocalNegativesSampler.sample` is patched to
return one fixed numpy draw), and every dropout is 0, so the two steps compute
the same function. K5's hash streams are held bit for bit by
`test_torch_port_mol_loss.py`. The JAX package's Pallas kernels run in
interpret mode; the port runs its plain versions on CPU tensors.
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
from rails_tpu_torch.ops import mol_loss_train, scatter_add
from rails_tpu_torch.train import loop as port_loop

FAST = dict(shared_negatives=True, fused_mol_loss=True, pallas_scatter_grad=True)
NO_DROPOUT = dict(
    train=dict(dropout_rate=0.0, local_batch_size=8, num_negatives=16, **FAST),
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


def _fix_negatives(mp, negatives: np.ndarray) -> None:
    """Both samplers return the same fixed (R,) draw."""
    mp.setattr(jax_samplers.LocalNegativesSampler, "sample",
               lambda self, rng, shape: jnp.asarray(negatives))
    mp.setattr(port_samplers.LocalNegativesSampler, "sample",
               lambda self, generator, shape: torch.from_numpy(negatives))


@pytest.fixture(scope="module")
def fast_setup():
    """Both configs, the batch, the fixed negatives and the JAX train state."""
    cfg = _configure(get_experiment_config("synthetic-small"), NO_DROPOUT)
    port_cfg = _configure(port_config.get_experiment_config("synthetic-small"), NO_DROPOUT)
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.train_dataset.batches(
        batch_size=8, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    negatives = np.random.default_rng(9).choice(
        ds.all_item_ids, size=(cfg.train.num_negatives,)).astype(np.int32)
    # Put some positives among the negatives, so the accidental-hit mask acts.
    negatives[:3] = np.asarray(batch.features.ids)[0, 1:4]
    with pytest.MonkeyPatch.context() as mp:
        _fix_negatives(mp, negatives)
        model, state, train_step, sampler = jax_loop.create_train_state(
            cfg, ds.max_item_id, ds.all_item_ids, batch)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    opt_state = jax.tree_util.tree_map(np.asarray, state.opt_state)
    return dict(cfg=cfg, port_cfg=port_cfg, ds=ds, batch=batch, model=model, state=state,
                train_step=train_step, sampler=sampler, params=params, opt_state=opt_state,
                negatives=negatives)


def _port_state(s, port_cfg=None):
    cfg = port_cfg or s["port_cfg"]
    model, state, train_step, _ = port_loop.create_train_state(
        cfg, s["ds"].max_item_id, s["ds"].all_item_ids, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(s["params"], cfg), strict=True)
    state.optimizer.state = adamw_state_from_jax(s["opt_state"])
    return model, state, train_step


@pytest.mark.parametrize("jax_fused", [True, False], ids=["jax_fused", "jax_shared_einsum"])
def test_fast_loss_aux_and_grads_match_jax(fast_setup, monkeypatch, jax_fused):
    """The port's fused step against JAX's fused path and against its
    non-fused shared path (the shared-corpus einsum): loss 2e-4, every
    parameter gradient 2e-3 (`test_loss_wiring_matches_xla_at_zero_dropout`)."""
    s = fast_setup
    _fix_negatives(monkeypatch, s["negatives"])
    cfg, model = s["cfg"], s["model"]
    if not jax_fused:
        cfg = cfg.replace(train=cfg.train.replace(fused_mol_loss=False))
        model = model.clone(cfg=cfg)
    features = jax_loop.scatter_target(s["batch"].features, s["batch"].target_ids)

    @jax.jit
    def loss_and_grads(params):
        def loss_fn(p):
            main, aux = model.apply(p, features, s["sampler"], cfg.train.num_negatives,
                                    cfg.train.temperature, True, False, shared_negatives=True,
                                    method=jax_loss,
                                    rngs={"dropout": jax.random.PRNGKey(0),
                                          "sampler": jax.random.PRNGKey(1)})
            return jax_weighted_loss(main, aux, dict(cfg.train.loss_weights)), (main, aux)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (total, (main, aux)), grads = loss_and_grads(s["params"])
    want_grads = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, grads),
                                            s["port_cfg"])

    port, state, train_step = _port_state(s)
    _, metrics = train_step(state, _port_batch(s["batch"]), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(metrics["loss"].item(), float(main), rtol=2e-4)
    np.testing.assert_allclose(metrics["loss_incl_aux"].item(), float(total), rtol=2e-4)
    assert set(aux) == {"uid_embedding_l2_norm", "mi_loss"}
    for key in aux:
        np.testing.assert_allclose(metrics[f"aux/{key}"].item(), float(aux[key]), rtol=2e-4,
                                   err_msg=key)
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want_grads)
    for name, want in want_grads.items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=2e-3, atol=2e-3,
                                   err_msg=name)


def test_three_fast_steps_match_jax(fast_setup, monkeypatch):
    """Three optimizer steps from the same (params, mu, nu, count)."""
    s = fast_setup
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


def _counting(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("scatter_grad", [True, False], ids=["pallas_scatter_grad", "indexing"])
def test_fast_step_routes_through_k5_and_k6(fast_setup, monkeypatch, scatter_grad):
    """One port step calls K5's forward and backward wrappers once each, and
    with `pallas_scatter_grad` the K6 wrapper once per table gather (tokens,
    the encoder's input, the negatives: 3), counted by its plain version, which
    it takes on CPU tensors; without the flag, never."""
    s = fast_setup
    _fix_negatives(monkeypatch, s["negatives"])
    calls: dict = {}
    _counting(monkeypatch, scatter_add, "scatter_add_rows_reference", calls)
    _counting(monkeypatch, mol_loss_train, "fused_mol_loss_forward", calls)
    _counting(monkeypatch, mol_loss_train, "fused_mol_loss_backward", calls)
    cfg = s["port_cfg"]
    cfg = cfg.replace(train=cfg.train.replace(pallas_scatter_grad=scatter_grad))
    model, state, train_step = _port_state(s, cfg)
    assert model.item_emb.scatter_grad_kernel is scatter_grad
    train_step(state, _port_batch(s["batch"]), torch.Generator().manual_seed(0))
    want = {"fused_mol_loss_forward": 1, "fused_mol_loss_backward": 1}
    if scatter_grad:
        want["scatter_add_rows_reference"] = 3
    assert calls == want
    assert model.item_emb.embedding.grad is not None


def test_fast_step_with_published_dropout_runs_and_learns():
    """The synthetic-small `-fast` step with every published dropout rate on
    (softmax 0.2, gating-qi 0.25 here, the rest as configured): the K5 seed is
    drawn from the step's generator, the loss is finite and falls on one batch."""
    from rails_tpu_torch.data.datasets import SequenceDataset, generate_synthetic_sequences

    cfg = port_config.get_experiment_config("synthetic-small")
    cfg = cfg.replace(train=cfg.train.replace(num_negatives=16, **FAST),
                      hstu=cfg.hstu.replace(fused_train=True),
                      mol=cfg.mol.replace(gating_qi_dropout_rate=0.25))
    num_items = 200
    seqs = generate_synthetic_sequences(num_users=16, num_items=num_items, max_len=34, seed=3)
    ds = SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1)
    batch = next(ds.batches(8, cfg.train.gr_output_length + 1, shuffle=False, device="cpu"))
    _, state, step, _ = port_loop.create_train_state(
        cfg, num_items, np.arange(1, num_items + 1, dtype=np.int32), seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(8):
        state, m = step(state, batch, gen)
        losses.append(m["loss"].item())
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_fast_step_ignores_loss_activation_checkpoint(fast_setup, monkeypatch):
    """JAX picks the fused route before it reads `loss_activation_checkpoint`,
    so a `-fast` step with the flag trains, and gives the step without it;
    on the non-fused route the flag scores the shared negatives in
    checkpointed chunks, to the same loss but for the chunks' summation
    order (relative 1e-6)."""
    s = fast_setup
    _fix_negatives(monkeypatch, s["negatives"])
    batch = _port_batch(s["batch"])
    results = []
    for flag in (False, True):
        cfg = s["port_cfg"]
        cfg = cfg.replace(train=cfg.train.replace(loss_activation_checkpoint=flag))
        model, state, train_step = _port_state(s, cfg)
        _, m = train_step(state, batch, torch.Generator().manual_seed(0))
        results.append((m["loss"].item(), {k: p.grad.clone() for k, p in model.named_parameters()}))
    assert results[0][0] == results[1][0]
    for name, grad in results[0][1].items():
        assert torch.equal(grad, results[1][1][name]), name
    losses = []
    for flag in (False, True):
        cfg = s["port_cfg"]
        cfg = cfg.replace(train=cfg.train.replace(loss_activation_checkpoint=flag,
                                                  fused_mol_loss=False))
        _, state, train_step = _port_state(s, cfg)
        losses.append(train_step(state, batch, torch.Generator().manual_seed(0))[1]["loss"].item())
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
