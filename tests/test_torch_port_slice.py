"""The rails_tpu_torch serving slice vs rails_tpu on one tiny model.

A `synthetic-small` model with `fused_inference=True` is built by
`rails_tpu.train.loop.create_train_state`; its weights reach the port
through `state_dict_from_jax_params`. Both sides see the same batch; the
JAX package's Pallas kernels run in interpret mode, the port's wrappers run
their plain versions on CPU tensors. All comparisons are float32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.core.config import get_experiment_config
from rails_tpu.data import datasets as jax_datasets
from rails_tpu.data.features import truncate_features as jax_truncate
from rails_tpu.train import evaluation as jax_eval
from rails_tpu.train.loop import create_train_state
from rails_tpu_torch.compat.from_jax import state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.data import datasets as port_datasets
from rails_tpu_torch.data.features import SequentialFeatures, truncate_features
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.train import evaluation as port_eval


@pytest.fixture(scope="module")
def slice_setup():
    cfg = get_experiment_config("synthetic-small")
    cfg = cfg.replace(
        data=cfg.data.replace(synthetic_num_users=64, synthetic_num_items=150),
        train=cfg.train.replace(local_batch_size=16, num_negatives=8),
        hstu=cfg.hstu.replace(fused_inference=True),
    )
    port_cfg = port_config.get_experiment_config("synthetic-small")
    port_cfg = port_cfg.replace(
        data=port_cfg.data.replace(synthetic_num_users=64, synthetic_num_items=150),
        train=port_cfg.train.replace(local_batch_size=16, num_negatives=8),
        hstu=port_cfg.hstu.replace(fused_inference=True),
    )
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.eval_dataset.batches(
        batch_size=16, max_output_length=cfg.train.gr_output_length + 1, shuffle=False,
    ))
    model, state, _, _ = create_train_state(cfg, ds.max_item_id, ds.all_item_ids, batch)
    port = SequentialRecommender(port_cfg, ds.max_item_id, device="cpu")
    port.load_state_dict(
        state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, state.params), port_cfg),
        strict=True,
    )
    return cfg, ds, batch, model, state.params, port


def _torch_features(features) -> SequentialFeatures:
    return SequentialFeatures(*(torch.from_numpy(np.array(f)) for f in features))


def test_state_dict_names_follow_the_flax_tree(slice_setup):
    *_, port = slice_setup
    names = set(port.state_dict())
    for name in ("item_emb.embedding", "input_preproc.pos_emb", "hstu.rel_attn_bias.pos_w",
                 "hstu.block_1.uvqk", "mol.gating_qi.hidden.weight", "mol.uid_embeddings_0.embedding"):
        assert name in names


@pytest.mark.parametrize("truncate", [False, True], ids=["n_full", "n_bucket"])
def test_encode_matches_jax(slice_setup, truncate):
    cfg, _, batch, model, params, port = slice_setup
    feats = batch.features
    if truncate:
        n = int(np.asarray(feats.lengths).max()) + 1
        assert n < feats.ids.shape[1]
        feats = jax_truncate(feats, n)
    want = model.apply(params, feats, method=model.encode)
    with torch.inference_mode():
        got = port.encode(_torch_features(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-4)


def test_score_precomputed_matches_jax(slice_setup):
    _, ds, batch, model, params, port = slice_setup
    ids = jnp.asarray(ds.all_item_ids)
    q = model.apply(params, batch.features, method=model.encode)
    emb = model.apply(params, ids, method=model.get_item_embeddings)
    tables = model.apply(params, emb, method=model.build_item_tables)
    want = model.apply(params, q, tables, batch.features.user_ids, method=model.score_precomputed)
    with torch.inference_mode():
        tq = torch.from_numpy(np.array(q))
        t_tables = port.build_item_tables(port.get_item_embeddings(torch.from_numpy(ds.all_item_ids)))
        got = port.score_precomputed(tq, t_tables, torch.from_numpy(np.array(batch.features.user_ids)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("method", ["MoLBruteForceTopK", "MoLBruteForceTopKFused"])
def test_eval_step_matches_jax(slice_setup, method):
    """Identical ranks; identical top-k ids wherever a score differs from both
    neighbours by more than 1e-5 (ties may order differently)."""
    _, ds, batch, model, params, port = slice_setup
    k, k_cap = 60, 100
    es = jax_eval.get_eval_state(model, params, ds.all_item_ids, method, table_dtype=jnp.float32)
    jstep = jax_eval.make_eval_step_fn(model, method, k=k, num_objects=es.num_objects,
                                       truncate_k_prime_to=k_cap)
    ranks, ids, scores = (np.asarray(a) for a in jstep(
        params, es.topk_state, es.item_embeddings, batch.features, batch.target_ids))

    pes = port_eval.get_eval_state(port, ds.all_item_ids, method, table_dtype=torch.float32,
                                    device="cpu")
    pstep = port_eval.make_eval_step_fn(port, method, k=k, num_objects=pes.num_objects,
                                        truncate_k_prime_to=k_cap)
    p_ranks, p_ids, p_scores = pstep(
        pes.topk_state, _torch_features(batch.features),
        torch.from_numpy(np.array(batch.target_ids)),
    )
    assert (ranks < 1001).sum() >= 3, "too few hits for a meaningful rank check"
    np.testing.assert_array_equal(p_ranks.numpy(), ranks)
    np.testing.assert_allclose(p_scores.numpy(), scores, rtol=2e-4, atol=2e-4)
    gap = np.abs(np.diff(scores, axis=1)) > 1e-5
    isolated = np.ones_like(scores, dtype=bool)
    isolated[:, 1:] &= gap
    isolated[:, :-1] &= gap
    assert isolated.mean() > 0.9
    np.testing.assert_array_equal(p_ids.numpy()[isolated], ids[isolated])


def test_eval_step_on_a_truncated_batch(slice_setup):
    """The serving bucket: the same step on the batch cut to its max length + 1."""
    _, ds, batch, model, params, port = slice_setup
    n = int(np.asarray(batch.features.lengths).max()) + 1
    feats = jax_truncate(batch.features, n)
    method = "MoLBruteForceTopKFused"
    es = jax_eval.get_eval_state(model, params, ds.all_item_ids, method, table_dtype=jnp.float32)
    jstep = jax_eval.make_eval_step_fn(model, method, k=30, num_objects=es.num_objects)
    ranks = np.asarray(jstep(params, es.topk_state, es.item_embeddings, feats, batch.target_ids)[0])
    pes = port_eval.get_eval_state(port, ds.all_item_ids, method, table_dtype=torch.float32,
                                    device="cpu")
    pstep = port_eval.make_eval_step_fn(port, method, k=30, num_objects=pes.num_objects)
    p_ranks = pstep(pes.topk_state, truncate_features(_torch_features(batch.features), n),
                    torch.from_numpy(np.array(batch.target_ids)))[0]
    np.testing.assert_array_equal(p_ranks.numpy(), ranks)


def test_metrics_from_ranks_match_jax():
    ranks = np.array([1, 2, 7, 120, 1001, 55], dtype=np.int32)
    want = jax_eval.metrics_from_ranks(jnp.asarray(ranks))
    got = port_eval.metrics_from_ranks(torch.from_numpy(ranks))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6)


@pytest.mark.parametrize(
    "distribution,order",
    [("uniform", "shuffle"), ("uniform", "sort_by_length"), ("ml20m", "sort_by_length")],
)
def test_batches_match_jax(distribution, order):
    kw = dict(num_users=40, num_items=300, max_len=60, seed=3, length_distribution=distribution)
    j_ds = jax_datasets.SequenceDataset(
        jax_datasets.generate_synthetic_sequences(**kw), 50, ignore_last_n=1
    )
    p_ds = port_datasets.SequenceDataset(
        port_datasets.generate_synthetic_sequences(**kw), 50, ignore_last_n=1
    )
    bkw = dict(batch_size=16, max_output_length=3, shuffle=order == "shuffle", seed=5,
               sort_by_length=order == "sort_by_length")
    j_batches = list(j_ds.batches(**bkw))
    p_batches = list(p_ds.batches(**bkw, device="cpu"))
    assert len(p_batches) == len(j_batches) == 3
    for jb, pb in zip(j_batches, p_batches):
        for name in jb.features._fields:
            got = getattr(pb.features, name)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jb.features, name)))
        np.testing.assert_array_equal(pb.target_ids.numpy(), np.asarray(jb.target_ids))
        np.testing.assert_array_equal(pb.target_ratings.numpy(), np.asarray(jb.target_ratings))
