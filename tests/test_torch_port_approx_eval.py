"""The rails_tpu_torch eval step with approximate retrieval vs rails_tpu.

The same `synthetic-small` model (weights through
`state_dict_from_jax_params`), corpus of 1,200 items (5 tiles of 256) and
batch on both sides: `get_eval_state` + `make_eval_step_fn` for every method
spelling the port serves, and `recall_vs_exact`. f32 tables; the JAX
package's Pallas kernels run in interpret mode, the port's wrappers their
plain versions. Ranks must be equal, scores within 1e-4, and ids equal
wherever a score differs from both neighbours by more than 1e-5. The
`...Int8...` spellings quantize those tables on both sides; their K2 rounds
its MLP to bf16, where a one-ulp difference before a rounding moves a score by
about a bf16 step, so there the tolerance is 1e-3 of each row's largest
|score| (`INT8_ROW_TOL`, below a bf16 half step), and ids and ranks are
compared where scores stand farther apart than that.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.core.config import get_experiment_config
from rails_tpu.data import datasets as jax_datasets
from rails_tpu.train import evaluation as jax_eval
from rails_tpu.train.loop import create_train_state
from rails_tpu_torch.compat.from_jax import state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.data.features import Batch, SequentialFeatures
from rails_tpu_torch.index.factory import get_top_k_raw, parse_top_k_budgets
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.train import evaluation as port_eval

NUM_ITEMS = 1200
K, K_CAP = 30, 60


def _small(cfg):
    return cfg.replace(
        data=cfg.data.replace(synthetic_num_users=64, synthetic_num_items=NUM_ITEMS),
        train=cfg.train.replace(local_batch_size=16, num_negatives=8),
    )


@pytest.fixture(scope="module")
def setup():
    cfg = _small(get_experiment_config("synthetic-small"))
    port_cfg = _small(port_config.get_experiment_config("synthetic-small"))
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.eval_dataset.batches(
        batch_size=16, max_output_length=cfg.train.gr_output_length + 1, shuffle=False,
    ))
    all_ids = np.arange(1, NUM_ITEMS + 1, dtype=np.int32)
    model, state, _, _ = create_train_state(cfg, NUM_ITEMS, all_ids, batch)
    port = SequentialRecommender(port_cfg, NUM_ITEMS, device="cpu")
    port.load_state_dict(
        state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, state.params), port_cfg),
        strict=True,
    )
    t_batch = Batch(SequentialFeatures(*(torch.from_numpy(np.array(f)) for f in batch.features)),
                    torch.from_numpy(np.array(batch.target_ids)),
                    torch.from_numpy(np.array(batch.target_ratings)))
    return model, state.params, port, all_ids, batch, t_batch


def _states(setup, method):
    model, params, port, all_ids, _, _ = setup
    jes = jax_eval.get_eval_state(model, params, all_ids, method, table_dtype=jnp.float32)
    pes = port_eval.get_eval_state(port, all_ids, method, table_dtype=torch.float32,
                                   device="cpu")
    return jes, pes


METHODS = ["MoLBruteForceTopKFusedApprox", "MIPSBruteForceTopK", "MoLNaiveTopK8",
           "MoLNaiveFaissTopK8", "MoLAvgTopK100", "MoLCombTopK8_100", "MoLCertTopK600",
           "MoLTileTopK1", "MoLTileTopK2B2"]


@pytest.mark.parametrize("method", METHODS)
def test_eval_step_matches_jax(setup, method):
    model, params, port, _, batch, t_batch = setup
    jes, pes = _states(setup, method)
    jstep = jax_eval.make_eval_step_fn(model, method, k=K, num_objects=jes.num_objects,
                                       truncate_k_prime_to=K_CAP)
    ranks, ids, scores = (np.asarray(a) for a in jstep(
        params, jes.topk_state, jes.item_embeddings, batch.features, batch.target_ids))
    pstep = port_eval.make_eval_step_fn(port, method, k=K, num_objects=pes.num_objects,
                                        truncate_k_prime_to=K_CAP)
    p_ranks, p_ids, p_scores = pstep(pes.topk_state, t_batch.features, t_batch.target_ids,
                                     pes.item_embeddings)
    assert (pes.topk_state.fused_tables is not None) == (jes.topk_state.fused_tables is not None)
    np.testing.assert_array_equal(p_ranks.numpy(), ranks)
    np.testing.assert_allclose(p_scores.numpy(), scores, rtol=1e-4, atol=1e-4)
    gap = np.abs(np.diff(scores, axis=1)) > 1e-5
    isolated = np.ones_like(scores, dtype=bool)
    isolated[:, 1:] &= gap
    isolated[:, :-1] &= gap
    assert isolated.mean() > 0.8
    np.testing.assert_array_equal(p_ids.numpy()[isolated], ids[isolated])


def test_recall_vs_exact_matches_jax(setup):
    model, params, port, _, batch, t_batch = setup
    j_exact, p_exact = _states(setup, "MoLBruteForceTopKFused")
    j_approx, p_approx = _states(setup, "MoLTileTopK2B2")
    want = jax_eval.recall_vs_exact(model, params, j_exact, j_approx, [batch], k=50)
    got = port_eval.recall_vs_exact(port, p_exact, p_approx, [t_batch], k=50)
    assert set(got) == set(want) == {"recall@1", "recall@5", "recall@10", "recall@50"}
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    assert 0.0 < got["recall@50"] < 1.0      # the tiles prune: some exact top-1s are missed


INT8_ROW_TOL = 1e-3
INT8_METHODS = ["MoLBruteForceTopKFusedInt8", "MoLBruteForceTopKFusedInt8Approx",
                "MoLCertTopK600Int8", "MoLTileTopK2B2Int8"]


@pytest.mark.parametrize("method", INT8_METHODS)
def test_int8_eval_step_matches_jax(setup, method):
    """Each Int8 spelling through both eval steps on int8 tables that each
    package quantizes from its f32 tables."""
    model, params, port, _, batch, t_batch = setup
    jes, pes = _states(setup, method)
    assert pes.topk_state.fused_tables.item_comp_t.dtype == torch.int8
    assert jes.topk_state.fused_tables.item_comp_t.dtype == jnp.int8
    jstep = jax_eval.make_eval_step_fn(model, method, k=K, num_objects=jes.num_objects,
                                       truncate_k_prime_to=K_CAP)
    ranks, ids, scores = (np.asarray(a) for a in jstep(
        params, jes.topk_state, jes.item_embeddings, batch.features, batch.target_ids))
    pstep = port_eval.make_eval_step_fn(port, method, k=K, num_objects=pes.num_objects,
                                        truncate_k_prime_to=K_CAP)
    p_ranks, p_ids, p_scores = (t.numpy() for t in pstep(
        pes.topk_state, t_batch.features, t_batch.target_ids, pes.item_embeddings))
    tol = INT8_ROW_TOL * np.abs(scores).max(axis=1, keepdims=True)
    assert (np.abs(p_scores - scores) <= tol).all()
    gap = np.abs(np.diff(scores, axis=1)) > tol
    isolated = np.ones_like(scores, dtype=bool)
    isolated[:, 1:] &= gap
    isolated[:, :-1] &= gap
    assert isolated.mean() > 0.5
    np.testing.assert_array_equal(p_ids[isolated], ids[isolated])
    rows = np.arange(ranks.shape[0])
    hit = ranks <= K
    clear = hit & isolated[rows, np.minimum(ranks, K) - 1]
    np.testing.assert_array_equal(p_ranks[clear], ranks[clear])
    # A target JAX misses is missed by the port too, or sits in a tie at the k-th score.
    p_hit = ~hit & (p_ranks <= K)
    assert (np.abs(p_scores[rows, np.minimum(p_ranks, K) - 1] - scores[:, -1])[p_hit]
            <= tol[p_hit, 0]).all()


@pytest.mark.parametrize("method", ["MoLIVFTopK8"])
def test_unported_spellings_raise(method):
    """IVF, once the one unported spelling, now serves: the factory binds
    its probe budget (tests/test_torch_port_ivf.py holds it to JAX)."""
    assert callable(get_top_k_raw(method))
    assert parse_top_k_budgets(method) == {"nprobe": 8}


@pytest.mark.parametrize("method", ["MoLFooTopK8", "MoLCertTopK", "MoLTileTopKB8",
                                    "MoLNaiveTopK8Int8", "MIPSBruteForceTopKFused"])
def test_unknown_spellings_raise_value_error(method):
    from rails_tpu.index.factory import get_top_k_raw as jax_get_top_k_raw

    for factory in (get_top_k_raw, jax_get_top_k_raw):
        with pytest.raises(ValueError, match="Unknown top_k_method"):
            factory(method)


def test_budgets_parse_as_in_jax():
    from rails_tpu.index.factory import parse_top_k_budgets as jax_parse

    for method in METHODS + ["MoLIVFTopK8", "MoLTileTopK8B2048Int8", "MoLCombTopK50_4096",
                             "MoLBruteForceTopK"]:
        assert parse_top_k_budgets(method) == jax_parse(method), method
