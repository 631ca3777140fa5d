"""The port's data-parallel training step (`train/loop.py` under a mesh whose
`data` axis is 2) vs rails_tpu's and vs the port's single-process step, on
gloo ranks over the CPU; the epoch shards; two processes end to end.

Mirrors `tests/test_sharding.py`'s `TestDataParallelTraining` and
`tests/test_distributed.py`. A `synthetic-small` model (64 users, 150 items,
fused_train, batch 8 = 4 a rank) starts from JAX's weights and optimizer
state (`state_dict_from_jax_params`, `adamw_state_from_jax`). The ranks
(`tests/torch_port_ranks.py`, spawned by `core.distributed.run_ranks` with a
300 s limit) import the port alone and run the kernels' plain versions.

- Against JAX's data-parallel step (its batch sharded over 2 devices of the
  virtual CPU mesh): every dropout off and both sides drawing one fixed
  global set of negatives, as `test_torch_port_train_step.py` holds the
  single-process step; losses of 3 steps within relative 1e-3 and step 1's
  gradients within (5e-3 relative, 1e-4 absolute), that test's tolerances.
- Against the port's single-process step over the global batch, with the
  config's dropout rates on (input 0.2, uid 0.5, item 0.1, softmax 0.2, the
  hash-stream linear dropout 0.2; plus qi 0.1 through K5 and attention 0.1 on
  the XLA path in their cases) and the sampler's own draws: the ranks draw
  the global batch's negatives and masks and keep their rows, and number the
  hash streams by global row, so the two compute one function up to the
  order of the sums. The `sasrec` and `dot_product` cases take the
  driver's other model families (SASRec, DotProduct) from the port's own
  seeded weights. Losses within relative 1e-5, step 1's gradients within
  1e-5 of each tensor's largest value, parameters after 3 AdamW steps within
  1e-5 absolute (3 steps of lr 1e-3 move each element at most 3e-3).
- The ranks' parameters after 3 steps are bit-equal.
"""

import os

import numpy as np
import pytest
import torch

import torch_port_ranks as R
from rails_tpu_torch.compat.from_jax import adamw_state_from_jax, state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.core.distributed import run_ranks
from rails_tpu_torch.data import datasets as port_datasets
from rails_tpu_torch.train.loop import create_train_state

RANK_TIMEOUT = 300.0
WORLD = 2
STEPS = 3
NO_DROPOUT = dict(
    train=dict(dropout_rate=0.0),
    hstu=dict(linear_dropout_rate=0.0),
    mol=dict(query_dropout_rate=0.0, uid_dropout_rate=0.0, item_dropout_rate=0.0,
             softmax_dropout_rate=0.0, gating_qi_dropout_rate=0.0, gating_item_dropout_rate=0.0),
)
# The single-process comparisons: config changes on top of BASE, dropouts on.
SINGLE_CASES = {
    "fused": {},
    "fast": dict(train=dict(shared_negatives=True, fused_mol_loss=True, pallas_scatter_grad=True),
                 mol=dict(gating_qi_dropout_rate=0.1)),
    "xla_in_batch": dict(hstu=dict(fused_train=False, attn_dropout_rate=0.1),
                         train=dict(sampling_strategy="in-batch")),
    "checkpointed": dict(train=dict(shared_negatives=True, loss_activation_checkpoint=True)),
    "bce": dict(train=dict(loss_module="BCELoss")),
    # The driver's other model families, from the port's own seeded weights.
    "sasrec": dict(model_type="SASRec"),
    "dot_product": dict(similarity_type="DotProduct",
                        train=dict(item_l2_norm=True, temperature=0.05, loss_weights=())),
}
BASE = dict(
    train=dict(local_batch_size=8, num_negatives=8),
    hstu=dict(fused_train=True),
    data=dict(synthetic_num_users=64, synthetic_num_items=150),
)


def _configure(cfg, *changes):
    """`cfg` with each change applied: a dict per section, or a top-level
    value."""
    for ch in changes:
        cfg = cfg.replace(**{k: getattr(cfg, k).replace(**v) if isinstance(v, dict) else v
                             for k, v in ch.items()})
    return cfg


def _np_batch(batch):
    return (tuple(np.asarray(a) for a in batch.features), np.asarray(batch.target_ids),
            np.asarray(batch.target_ratings))


@pytest.fixture(scope="module")
def jax_setup():
    import jax

    from rails_tpu.core.config import get_experiment_config
    from rails_tpu.data import datasets as jax_datasets
    from rails_tpu.train import loop as jax_loop

    cfg = _configure(get_experiment_config("synthetic-small"), BASE)
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.train_dataset.batches(
        batch_size=8, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    _, state, _, _ = jax_loop.create_train_state(cfg, ds.max_item_id, ds.all_item_ids, batch)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    opt_state = jax.tree_util.tree_map(np.asarray, state.opt_state)
    port_cfg = _configure(port_config.get_experiment_config("synthetic-small"), BASE)
    return dict(ds=ds, batch=batch, params=params, opt_state=opt_state, port_cfg=port_cfg,
                num_items=ds.max_item_id,
                state_dict=state_dict_from_jax_params(params, port_cfg))


@pytest.fixture(scope="module")
def negatives(jax_setup):
    b, n = jax_setup["batch"].features.ids.shape
    return np.random.default_rng(5).choice(
        jax_setup["ds"].all_item_ids, size=(b * (n - 1), 8)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_dp(jax_setup, negatives):
    """JAX's data-parallel step: 3 steps over the batch sharded on 2 devices,
    and step 1's gradients."""
    import jax
    import jax.numpy as jnp

    from rails_tpu.core.config import MeshConfig, get_experiment_config
    from rails_tpu.core.mesh import make_mesh, replicate, shard_batch
    from rails_tpu.losses import samplers as jax_samplers
    from rails_tpu.losses.sampled_softmax import get_weighted_loss, sampled_softmax_loss
    from rails_tpu.train import loop as jax_loop

    s = jax_setup
    cfg = _configure(get_experiment_config("synthetic-small"), BASE, NO_DROPOUT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_samplers.LocalNegativesSampler, "sample",
                   lambda self, rng, shape: jnp.asarray(negatives))
        model, state, step, sampler = jax_loop.create_train_state(
            cfg, s["ds"].max_item_id, s["ds"].all_item_ids, s["batch"])
        state = state._replace(params=jax.tree_util.tree_map(jnp.asarray, s["params"]),
                               opt_state=jax.tree_util.tree_map(jnp.asarray, s["opt_state"]))
        mesh = make_mesh(MeshConfig(data_parallel=WORLD, item_parallel=1),
                         devices=jax.devices()[:WORLD])
        state = replicate(state, mesh)
        batch = shard_batch(s["batch"], mesh)
        feats = jax_loop.scatter_target(batch.features, batch.target_ids)

        def loss_fn(p):
            main, aux = model.apply(p, feats, sampler, cfg.train.num_negatives,
                                    cfg.train.temperature, True, method=sampled_softmax_loss,
                                    rngs={"dropout": jax.random.PRNGKey(0),
                                          "sampler": jax.random.PRNGKey(1)})
            return get_weighted_loss(main, aux, dict(cfg.train.loss_weights))

        grads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(state.params))
        losses = []
        for _ in range(STEPS):
            state, m = step(state, batch, jax.random.PRNGKey(0))
            losses.append(float(m["loss"]))
    return dict(losses=losses, grads=state_dict_from_jax_params(grads, s["port_cfg"]))


def _run(fn, tmp_path_factory, payload, world=WORLD):
    d = str(tmp_path_factory.mktemp(fn.__name__))
    path = os.path.join(d, "payload.pt")
    torch.save(payload, path)
    run_ranks(fn, world, (world, os.path.join(d, "store"), path, d), timeout=RANK_TIMEOUT)
    return R.load_results(d, world)


def _single_cfg(port_cfg, name, dropout=True):
    cfg = _configure(port_cfg, SINGLE_CASES[name])
    return cfg if dropout else _configure(cfg, NO_DROPOUT)


def _case_state_dict(jax_setup, cfg):
    """JAX's weights for the HSTU + MoL cases; another model family starts
    from the port's seeded weights."""
    if (cfg.model_type, cfg.similarity_type) == ("HSTU", "MoL"):
        return jax_setup["state_dict"]
    n = jax_setup["num_items"]
    model = create_train_state(cfg, n, np.arange(1, n + 1, dtype=np.int32), device="cpu")[0]
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def dp(jax_setup, negatives, tmp_path_factory):
    s = jax_setup
    common = dict(num_items=s["num_items"], state_dict=s["state_dict"],
                  batch=_np_batch(s["batch"]), steps=STEPS, seed=0)
    cases = {"vs_jax": dict(common, cfg=_configure(s["port_cfg"], NO_DROPOUT),
                            negatives=negatives,
                            opt_state=adamw_state_from_jax(s["opt_state"]))}
    for name in SINGLE_CASES:
        cfg = _single_cfg(s["port_cfg"], name)
        cases[name] = dict(common, cfg=cfg, state_dict=_case_state_dict(s, cfg))
    return _run(R.dp_rank, tmp_path_factory, dict(cases=cases))


def _full_batch(jax_setup):
    return R.batch_rows(_np_batch(jax_setup["batch"]), 0, 1)


def test_dp_step_matches_jax_dp_step(dp, jax_dp, jax_setup, negatives):
    got = dp[0]["vs_jax"]
    np.testing.assert_allclose(got["losses"], jax_dp["losses"], rtol=1e-3)
    assert set(got["grads"]) == set(jax_dp["grads"])
    for name, want in jax_dp["grads"].items():
        np.testing.assert_allclose(got["grads"][name].numpy(), want.numpy(), rtol=5e-3,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("case", ["vs_jax", *SINGLE_CASES])
def test_dp_ranks_stay_bit_equal(dp, case):
    for name, p in dp[0][case]["params"].items():
        assert torch.equal(p, dp[1][case]["params"][name]), name
    assert dp[0][case]["losses"] == dp[1][case]["losses"]


def _vanishes(name: str) -> bool:
    """A gradient that is 0 in exact arithmetic: SASRec's key bias adds one
    constant to every logit of a softmax row. Both sides hold rounding noise
    there, whose sign AdamW turns into whole steps."""
    return name.startswith("sasrec.") and name.endswith("k_proj.bias")


@pytest.mark.parametrize("case", list(SINGLE_CASES))
def test_dp_step_matches_single_process_step(dp, jax_setup, case):
    """With dropout on: the ranks' step over their rows == one process's step
    over the global batch (`fused`: K3/K4's plain versions with the hash
    streams numbered by global row; `fast`: K5's streams over the global
    rows and K6; `xla_in_batch`: generator dropout and the in-batch pool of
    the global batch; `checkpointed`: the global batch's chunks; `sasrec`,
    `dot_product`: the driver's other model families). A gradient that
    vanishes in exact arithmetic (`_vanishes`) is held below 1e-6 of the
    model's largest gradient on both sides, and its parameter to the
    2 x lr a step by which AdamW moves a noise gradient."""
    s = jax_setup
    cfg = _single_cfg(s["port_cfg"], case)
    losses, metrics, params, grads = R.train_steps(cfg, s["num_items"],
                                                   _case_state_dict(s, cfg), _full_batch(s),
                                                   STEPS, 0)
    got = dp[0][case]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for key, want in metrics.items():
        np.testing.assert_allclose(got["metrics"][key], want, rtol=1e-5, atol=1e-7, err_msg=key)
    largest = max(float(g.abs().max()) for g in grads.values())
    for name, want in grads.items():
        if _vanishes(name):
            assert max(float(want.abs().max()), float(got["grads"][name].abs().max())) \
                <= 1e-6 * largest, name
            continue
        scale = max(float(want.abs().max()), 1e-12)
        np.testing.assert_allclose(got["grads"][name].numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
    for name, want in params.items():
        atol = 2 * cfg.train.learning_rate * STEPS if _vanishes(name) else 1e-5
        np.testing.assert_allclose(got["params"][name].numpy(), want.numpy(), rtol=0, atol=atol,
                                   err_msg=name)


def test_row_span_refuses_an_unmarked_tensor_whose_length_divides_the_rows():
    """Under a row shard of 4 batch rows (of 8) and 34 scored positions a
    row: a tensor that every rank holds whole, of 8 rows (a multiple of 4,
    as the `fast` case's 8 shared negatives are), raises unmarked rather
    than keeping rows 8-15 of a 16-row draw; under `replicated_rows()` it
    is drawn whole, as one process draws it; the batch's own tensors (4
    rows, 4 x 34 positions) keep this rank's rows of the global draw."""
    from rails_tpu_torch.core.distributed import RowShard, draw_rows, replicated_rows, row_shard

    def draw(shape):
        return torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)

    with row_shard(RowShard(4, 4, 8, None, (1, 34))):
        with pytest.raises(ValueError, match="replicated_rows"):
            draw_rows(draw, (8, 3))
        with replicated_rows():
            assert torch.equal(draw_rows(draw, (8, 3)), draw((8, 3)))
        assert torch.equal(draw_rows(draw, (4, 3)), draw((8, 3))[4:])
        assert torch.equal(draw_rows(draw, (136, 2)), draw((272, 2))[136:])
    assert torch.equal(draw_rows(draw, (8, 3)), draw((8, 3)))


def test_dp_dropout_draws_differ_from_local_numbering(jax_setup):
    """The rows' numbering matters: rank 1's rows of the `fused` case drawn
    as if they were rows 0-3 (no row shard) give another loss than the
    single-process step's rows 4-7 do."""
    s = jax_setup
    cfg = _single_cfg(s["port_cfg"], "fused")
    full = R.train_steps(cfg, s["num_items"], s["state_dict"], _full_batch(s), 1, 0)[0]
    alone = R.train_steps(cfg, s["num_items"], s["state_dict"],
                          R.batch_rows(_np_batch(s["batch"]), 1, 2), 1, 0)[0]
    assert abs(full[0] - alone[0]) > 1e-4


@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_epoch_shards_match_jax(jax_setup, num_shards):
    """`batches(num_shards, shard_index)` vs JAX's for every index: the same
    rows, the wrap-around tail included."""
    from rails_tpu.data import datasets as jax_datasets

    cfg = jax_setup["port_cfg"]
    seqs = jax_datasets.generate_synthetic_sequences(
        num_users=61, num_items=150, max_len=cfg.data.max_sequence_length + 2, seed=3)
    jds = jax_datasets.SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1)
    pds = port_datasets.SequenceDataset(
        port_datasets.generate_synthetic_sequences(
            num_users=61, num_items=150, max_len=cfg.data.max_sequence_length + 2, seed=3),
        cfg.data.max_sequence_length, ignore_last_n=1)
    kw = dict(batch_size=8, max_output_length=3, shuffle=True, seed=4, num_shards=num_shards)
    seen = []
    for i in range(num_shards):
        want = list(jds.batches(shard_index=i, **kw))
        got = list(pds.batches(shard_index=i, device="cpu", **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for a, b in zip(g.features, w.features):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(g.target_ids.numpy(), np.asarray(w.target_ids))
            seen.append(g.features.user_ids.numpy())
    assert set(np.concatenate(seen)) == set(np.asarray(seqs.user_ids))


def test_two_process_training_and_metric_reduction(jax_setup, tmp_path_factory):
    """Two ranks train data-parallel on their epoch shards, evaluate their
    shards of the users and all-reduce [sum, count]: both get the same global
    metrics, the mean over both shards' examples, and the same weights."""
    cfg = _configure(port_config.get_experiment_config("synthetic-small"), dict(
        data=dict(synthetic_num_users=64, synthetic_num_items=80),
        train=dict(local_batch_size=8, num_negatives=8)))
    outs = _run(R.two_process_train_rank, tmp_path_factory, dict(cfg=cfg))
    assert [o["process_index"] for o in outs] == [0, 1]
    assert [o["primary"] for o in outs] == [True, False] and outs[0]["count"] == 2
    # `make_global_batch`: rank r's 8 rows are rows [8r, 8r + 8) of 16.
    assert [o["shards"] for o in outs] == [{(0, 8, 16)}, {(8, 8, 16)}]
    assert outs[0]["losses"] == outs[1]["losses"] and len(outs[0]["losses"]) > 0
    for key in ("hr@10", "hr@50", "mrr"):
        assert np.isfinite(outs[0]["final"][key])
        assert outs[0]["final"][key] == outs[1]["final"][key]
        both = np.concatenate([o["per_example"][key] for o in outs]).astype(np.float64)
        np.testing.assert_allclose(outs[0]["final"][key], both.mean(), rtol=1e-12)
    for name, p in outs[0]["params"].items():
        assert isinstance(p, np.ndarray)
        np.testing.assert_array_equal(p, outs[1]["params"][name], err_msg=name)


def test_two_process_item_sharded_serving(tmp_path_factory):
    """The corpus shards over two ranks; both return the single-process
    brute force's ids, the same list."""
    cfg = _configure(port_config.get_experiment_config("synthetic-small"), dict(
        data=dict(synthetic_num_users=64, synthetic_num_items=80),
        train=dict(local_batch_size=8, num_negatives=8)))
    outs = _run(R.two_process_serve_rank, tmp_path_factory, dict(cfg=cfg))
    assert [o["process_index"] for o in outs] == [0, 1]
    for o in outs:
        np.testing.assert_array_equal(o["got"], o["want"])
        np.testing.assert_allclose(o["got_scores"], o["want_scores"], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(outs[0]["got"], outs[1]["got"])
