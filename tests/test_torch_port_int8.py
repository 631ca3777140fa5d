"""rails_tpu_torch int8 serving tables and K2's blockmax vs rails_tpu.

The int8 tables are the JAX package's own (`quantize_fused_tables`), carried
into the port by `fused_tables_from_jax`, so both sides read the same bytes.
The JAX Pallas kernels run in interpret mode, the port's wrappers their plain
versions on CPU tensors. Tolerances: the scales to rtol 1e-6 and the codes
equal but for one step where a division lands within an ulp of a half step;
K8 and K9 to 1e-5 (f32 sums of exact products); K2 and K10 within 1e-2 of
each row's largest |score|, with the top-1 equal wherever the top-2 gap
exceeds that (their MLP rounds to bf16, and a one-ulp difference before a
rounding moves a score by a bf16 step); the blockmax case to 1e-4, as the f32
K2 plain version against Pallas, and its masked columns and maxima exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.core.config import MoLConfig, get_experiment_config
from rails_tpu.data import datasets as jax_datasets
from rails_tpu.index import top_k as jtk
from rails_tpu.ops.pallas import mol_scoring as jax_mol
from rails_tpu.similarity.mol import MoLSimilarity
from rails_tpu.train.evaluation import get_eval_state as jax_get_eval_state
from rails_tpu.train.loop import create_train_state
from rails_tpu_torch.compat.from_jax import fused_tables_from_jax, state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.index import top_k as ptk
from rails_tpu_torch.index.factory import get_top_k_raw
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.ops import mol_scoring
from rails_tpu_torch.train import evaluation as port_eval

NUM_ITEMS = 1200
ROW_TOL = 1e-2      # of each row's largest |score|: K2 and K10 with bf16 rounding points


def _small(cfg, users=64, items=NUM_ITEMS):
    return cfg.replace(
        data=cfg.data.replace(synthetic_num_users=users, synthetic_num_items=items),
        train=cfg.train.replace(local_batch_size=16, num_negatives=8),
    )


def _port_model(params, port_cfg, num_items):
    port = SequentialRecommender(port_cfg, num_items, device="cpu")
    port.load_state_dict(
        state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params), port_cfg),
        strict=True,
    )
    return port


@pytest.fixture(scope="module")
def setup():
    """An untrained synthetic-small model over 1,200 items (5 tiles of 256),
    the JAX package's int8 fused tables and one batch of 16 queries."""
    cfg = _small(get_experiment_config("synthetic-small"))
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.eval_dataset.batches(
        batch_size=16, max_output_length=cfg.train.gr_output_length + 1, shuffle=False,
    ))
    all_ids = np.arange(1, NUM_ITEMS + 1, dtype=np.int32)
    model, state, _, _ = create_train_state(cfg, NUM_ITEMS, all_ids, batch)
    params = state.params
    ids = jnp.asarray(all_ids)
    emb = model.apply(params, ids, method=model.get_item_embeddings)
    jstate = jtk.build_mol_topk_state(model, params, ids, emb, table_dtype=jnp.float32,
                                      build_fused=True, quantize_fused=True)
    q = model.apply(params, batch.features, method=model.encode)
    uids = batch.features.user_ids
    jq = model.apply(params, q, uids, method=model.query_components).astype(jnp.bfloat16)
    qp = model.apply(params, q, method=model.query_gating_partial)
    port = _port_model(params, _small(port_config.get_experiment_config("synthetic-small")),
                       NUM_ITEMS)
    jft = jax.tree_util.tree_map(np.asarray, jstate.fused_tables)
    return dict(model=model, params=params, jft=jstate.fused_tables,
                pft=fused_tables_from_jax(jft), jq=jq, qp=qp,
                tq=torch.from_numpy(np.array(jq.astype(jnp.float32))).bfloat16(),
                tqp=torch.from_numpy(np.array(qp)), port=port,
                temp=float(model.cfg.mol.temperature))


def _assert_row_close(got: np.ndarray, want: np.ndarray) -> None:
    """Within ROW_TOL of each row's largest |score|; the top-1 equal wherever
    the top-2 gap exceeds that."""
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= ROW_TOL * scale).all(), np.abs(got - want).max()
    top2 = -np.sort(-want, axis=1)[:, :2]
    clear = (top2[:, 0] - top2[:, 1]) > ROW_TOL * scale[:, 0]
    assert clear.any()
    np.testing.assert_array_equal(got.argmax(axis=1)[clear], want.argmax(axis=1)[clear])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax(dtype):
    """The port's quantize_fused_tables on the JAX function's inputs: scales
    to rtol 1e-6, codes equal but for rare one-step flips at half steps."""
    rng = np.random.default_rng(0)
    comp = rng.normal(size=(4, 32, 1024)).astype(np.float32)
    part = rng.normal(size=(8, 1024)).astype(np.float32)
    comp[:, :, 1000:] = 0.0              # zero (pad) columns keep codes 0
    part[:, 1000:] = 0.0
    jt = jax_mol.FusedCorpusTables(jnp.asarray(comp).astype(dtype),
                                   jnp.asarray(part).astype(dtype), 1000)
    want = jax.tree_util.tree_map(np.asarray, jax_mol.quantize_fused_tables(jt))
    got = mol_scoring.quantize_fused_tables(fused_tables_from_jax(
        jax.tree_util.tree_map(np.asarray, jt)))
    assert got.item_comp_t.dtype == torch.int8 and got.num_items == 1000
    for g, w in ((got.comp_scale, want.comp_scale), (got.partial_scale, want.partial_scale)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)
    # Rows of the gating partial: the port's n-major order vs the m-major
    # order that fused_tables_from_jax undid (L = 8 rows as (P_Q, P_X) = (2, 4)).
    inv = [m * 2 + n for n in range(2) for m in range(4)]
    for g, w in ((got.item_comp_t, want.item_comp_t), (got.item_partial_t, want.item_partial_t[inv])):
        d = np.abs(g.numpy().astype(np.int32) - w.astype(np.int32))
        assert d.max() <= 1 and d.mean() < 1e-3, (d.max(), d.mean())
    assert not got.item_comp_t[:, :, 1000:].any()
    np.testing.assert_array_equal(got.comp_scale[:, 1000:].numpy(),
                                  np.float32(np.float32(1e-12) / np.float32(127.0)))


def test_fused_tables_from_jax_round_trip(setup):
    """The same int8 bytes and scales; the gating rows n-major."""
    jft, pft = setup["jft"], setup["pft"]
    assert pft.item_comp_t.dtype == torch.int8 and pft.num_items == NUM_ITEMS
    np.testing.assert_array_equal(pft.item_comp_t.numpy(), np.asarray(jft.item_comp_t))
    perm = jax_mol.m_major_perm(4, 2)     # JAX row l' holds port row perm[l']
    np.testing.assert_array_equal(pft.item_partial_t.numpy()[perm], np.asarray(jft.item_partial_t))
    np.testing.assert_array_equal(pft.comp_scale.numpy(), np.asarray(jft.comp_scale))
    np.testing.assert_array_equal(pft.partial_scale.numpy(), np.asarray(jft.partial_scale))


def test_k2_int8_plain_matches_pallas(setup):
    s, jft, pft = setup, setup["jft"], setup["pft"]
    want = np.asarray(jax_mol.fused_mol_scores_t(
        s["jq"], s["qp"], jft.item_comp_t, jft.item_partial_t,
        jax_mol.extract_gating_qi_weights(s["params"]), s["temp"], block_x=256, interpret=True,
        comp_scale=jft.comp_scale, partial_scale=jft.partial_scale))
    got = mol_scoring.fused_mol_scores_t(
        s["tq"], s["tqp"], pft.item_comp_t, pft.item_partial_t,
        mol_scoring.extract_gating_qi_weights(s["port"].mol), s["temp"], pft.comp_scale,
        pft.partial_scale)
    _assert_row_close(got.detach().numpy()[:, :NUM_ITEMS], want[:, :NUM_ITEMS])


def test_k10_int8_plain_matches_pallas_and_k2(setup):
    """Shuffled tile ids with a duplicate and the last (padded) tile."""
    s, jft, pft = setup, setup["jft"], setup["pft"]
    tiles = np.array([4, 0, 2, 2, 1], dtype=np.int32)
    want = np.asarray(jax_mol.fused_mol_scores_tiles(
        s["jq"], s["qp"], jnp.asarray(tiles), jft.item_comp_t, jft.item_partial_t,
        jax_mol.extract_gating_qi_weights(s["params"]), s["temp"], block_x=256, interpret=True,
        comp_scale=jft.comp_scale, partial_scale=jft.partial_scale))
    w = mol_scoring.extract_gating_qi_weights(s["port"].mol)
    with torch.inference_mode():
        got = mol_scoring.fused_mol_scores_tiles(
            s["tq"], s["tqp"], torch.from_numpy(tiles), pft.item_comp_t, pft.item_partial_t, w,
            s["temp"], pft.comp_scale, pft.partial_scale).numpy()
        full = mol_scoring.fused_mol_scores_t(
            s["tq"], s["tqp"], pft.item_comp_t, pft.item_partial_t, w, s["temp"],
            pft.comp_scale, pft.partial_scale).numpy()
    real = (tiles[:, None] * 256 + np.arange(256)).reshape(-1) < NUM_ITEMS
    _assert_row_close(got[:, real], want[:, real])
    cols = (tiles[:, None] * 256 + np.arange(256)).reshape(-1)
    np.testing.assert_allclose(got, full[:, cols], rtol=1e-6, atol=1e-6)


def test_k8_int8_plain_matches_pallas(setup):
    s, jft, pft = setup, setup["jft"], setup["pft"]
    want = np.asarray(jax_mol.fused_mol_ub_t(s["jq"], jft.item_comp_t, s["temp"], block_x=256,
                                             interpret=True, comp_scale=jft.comp_scale))
    got = mol_scoring.fused_mol_ub_t(s["tq"], pft.item_comp_t, s["temp"], pft.comp_scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_k9_int8_plain_matches_pallas_rows_permuted(setup):
    s, jft, pft = setup, setup["jft"], setup["pft"]
    want = np.asarray(jax_mol.fused_mol_group_block_max(
        s["jq"], jft.item_comp_t, s["temp"], block_x=256, interpret=True,
        comp_scale=jft.comp_scale))
    got = mol_scoring.fused_mol_group_block_max(s["tq"], pft.item_comp_t, s["temp"],
                                                pft.comp_scale).numpy()
    assert got.shape == want.shape == (16, 8, 5)
    np.testing.assert_allclose(got[:, jax_mol.m_major_perm(4, 2)], want, rtol=1e-5, atol=1e-5)


def test_int8_bounds_dominate_int8_scores(setup):
    """K8 >= K2 on every pair and K9's tile maxima >= K8 of the tile's items,
    with int8 tables."""
    s, pft = setup, setup["pft"]
    w = mol_scoring.extract_gating_qi_weights(s["port"].mol)
    with torch.inference_mode():
        scores = mol_scoring.fused_mol_scores_t(s["tq"], s["tqp"], pft.item_comp_t,
                                                pft.item_partial_t, w, s["temp"],
                                                pft.comp_scale, pft.partial_scale)
    ub = mol_scoring.fused_mol_ub_t(s["tq"], pft.item_comp_t, s["temp"], pft.comp_scale)
    assert bool((ub + 2.0 ** -20 * ub.abs() >= scores).all())
    gmax = mol_scoring.fused_mol_group_block_max(s["tq"], pft.item_comp_t, s["temp"],
                                                 pft.comp_scale).amax(dim=1)
    assert bool((gmax[:, torch.arange(ub.shape[1]) // 256] >= ub).all())


@pytest.mark.parametrize("kernel", ["K2", "K10", "K8", "K9"])
def test_int8_tables_without_scales_raise(setup, kernel):
    s, pft = setup, setup["pft"]
    w = mol_scoring.extract_gating_qi_weights(s["port"].mol)
    tiles = torch.zeros(1, dtype=torch.int32)
    calls = {
        "K2": lambda: mol_scoring.fused_mol_scores_t(
            s["tq"], s["tqp"], pft.item_comp_t, pft.item_partial_t, w, s["temp"], pft.comp_scale),
        "K10": lambda: mol_scoring.fused_mol_scores_tiles(
            s["tq"], s["tqp"], tiles, pft.item_comp_t, pft.item_partial_t, w, s["temp"],
            None, pft.partial_scale),
        "K8": lambda: mol_scoring.fused_mol_ub_t(s["tq"], pft.item_comp_t, s["temp"]),
        "K9": lambda: mol_scoring.fused_mol_group_block_max(s["tq"], pft.item_comp_t, s["temp"]),
    }
    with pytest.raises(ValueError, match="int8 tables need comp_scale"):
        calls[kernel]()


@pytest.fixture(scope="module")
def mol_setup():
    """`tests/test_pallas_mol.py`'s MoLSimilarity: 8 x 4 x 128, H=128, B=8, X=300."""
    cfg = MoLConfig(
        query_embedding_dim=24, item_embedding_dim=16, dot_product_dimension=128,
        query_dot_product_groups=8, item_dot_product_groups=4, query_hidden_dim=32,
        item_hidden_dim=-1, uid_embedding_hash_sizes=(33,), gating_query_hidden_dim=16,
        gating_item_hidden_dim=16, gating_qi_hidden_dim=128, temperature=0.05,
    )
    rng = np.random.default_rng(0)
    q = rng.normal(size=(8, cfg.query_embedding_dim)).astype(np.float32)
    items = rng.normal(size=(300, cfg.item_embedding_dim)).astype(np.float32)
    uids = jnp.asarray(rng.integers(0, 100, size=(8,)))
    module = MoLSimilarity(cfg)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(items)[None],
                         user_ids=uids)
    tables = module.apply(params, jnp.asarray(items), method=MoLSimilarity.build_item_tables)
    q_comp, _ = module.apply(params, jnp.asarray(q), method=MoLSimilarity.query_components,
                             user_ids=uids)
    qp = module.apply(params, jnp.asarray(q), method=lambda m, e: m.gating_query(e, train=False))
    return cfg, params, tables, q_comp, qp


def test_emit_blockmax_masks_and_matches(mol_setup):
    """`test_pallas_mol.py::test_emit_blockmax_masks_and_matches`: mid-corpus
    pads at 5 and 77 and the pad tail score -1e30; the port's (B, X/256)
    maxima are those of its masked scores exactly, and of the JAX kernel's
    masked scores to 1e-4."""
    cfg, params, tables, q_comp, qp = mol_setup
    weights = jax_mol.extract_gating_qi_weights({"params": params["params"]})
    comp_p, gp_p, x = jax_mol.pad_corpus_tables(tables.component_embeddings,
                                                tables.gating_partial, block_x=128)
    valid = np.ones((x,), np.float32)
    valid[[5, 77]] = 0.0
    # The JAX kernel reads the gating rows in its m-major order.
    plain = np.asarray(jax_mol.fused_mol_scores_t(
        q_comp, qp, jnp.transpose(comp_p, (1, 2, 0)), gp_p.T[jax_mol.m_major_perm(8, 4)],
        weights, cfg.temperature, block_x=128, block_b=8, interpret=True))
    expected = plain.copy()
    expected[:, [5, 77]] = -1e30
    ft = mol_scoring.prepare_fused_tables(
        torch.from_numpy(np.array(tables.component_embeddings)),
        torch.from_numpy(np.array(tables.gating_partial)))
    w = mol_scoring.MoLKernelWeights(*(torch.from_numpy(np.array(a)) for a in
                                       (weights.w1, weights.b1[0], weights.w2, weights.b2[0])))
    scores, bmax = mol_scoring.fused_mol_scores_t(
        torch.from_numpy(np.array(q_comp)), torch.from_numpy(np.array(qp)), ft.item_comp_t,
        ft.item_partial_t, w, cfg.temperature, emit_blockmax=True, valid=torch.from_numpy(valid))
    scores, bmax = scores.numpy(), bmax.numpy()
    assert scores.shape == (8, 512) and bmax.shape == (8, 2)
    np.testing.assert_allclose(scores[:, :x], expected[:, :x], rtol=1e-4, atol=1e-4)
    assert (scores[:, [5, 77]] == -1e30).all() and (scores[:, x:] == -1e30).all()
    np.testing.assert_array_equal(bmax, scores.reshape(8, 2, 256).max(axis=2))
    want = np.full((8, 512), -1e30, np.float32)
    want[:, :x] = expected[:, :x]
    np.testing.assert_allclose(bmax, want.reshape(8, 2, 256).max(axis=2), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def trained():
    """`tests/test_index.py`'s briefly trained model (4 steps, 300 items) in
    both packages."""
    cfg = get_experiment_config("synthetic-small")
    cfg = cfg.replace(
        data=cfg.data.replace(synthetic_num_users=128, synthetic_num_items=300),
        train=cfg.train.replace(local_batch_size=16, num_negatives=8),
    )
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batches = list(ds.train_dataset.batches(
        batch_size=16, max_output_length=cfg.train.gr_output_length + 1, shuffle=True, seed=0,
        drop_last=True,
    ))
    model, state, train_step, _ = create_train_state(cfg, ds.max_item_id, ds.all_item_ids,
                                                     batches[0])
    for batch in batches[:4]:
        state, _ = train_step(state, batch, jax.random.PRNGKey(0))
    port_cfg = port_config.get_experiment_config("synthetic-small")
    port_cfg = port_cfg.replace(data=port_cfg.data.replace(synthetic_num_users=128,
                                                           synthetic_num_items=300),
                                train=port_cfg.train.replace(local_batch_size=16, num_negatives=8))
    port = _port_model(state.params, port_cfg, ds.max_item_id)
    feats = batches[0].features
    q = model.apply(state.params, feats, method=model.encode)
    return dict(model=model, params=state.params, port=port, ids=np.asarray(ds.all_item_ids),
                q=q, uids=feats.user_ids, tq=torch.from_numpy(np.array(q)),
                tuids=torch.from_numpy(np.array(feats.user_ids)))


def test_int8_fused_high_overlap_with_f32(trained):
    """`test_index.py:257-285`: MoLBruteForceTopKFusedInt8 keeps top-20 id
    overlap >= 0.9 with the f32 fused path, and the top-1 score within 0.05;
    the JAX package's int8 path gives the same overlap."""
    s = trained
    raw = get_top_k_raw("MoLBruteForceTopKFusedInt8")
    es32 = port_eval.get_eval_state(s["port"], s["ids"], "MoLBruteForceTopKFused",
                                    table_dtype=torch.float32, device="cpu")
    es8 = port_eval.get_eval_state(s["port"], s["ids"], "MoLBruteForceTopKFusedInt8",
                                   table_dtype=torch.float32, device="cpu")
    ft8 = es8.topk_state.fused_tables
    assert ft8.item_comp_t.dtype == torch.int8 and ft8.comp_scale is not None
    with torch.inference_mode():
        exact = ptk.mol_brute_force_top_k_fused(s["port"], es32.topk_state, s["tq"], 20, s["tuids"])
        quant = raw(s["port"], es8.topk_state, s["tq"], 20, s["tuids"])
    overlap = np.mean([np.intersect1d(a, b).size / 20
                       for a, b in zip(quant.ids.numpy(), exact.ids.numpy())])
    assert overlap >= 0.9, overlap
    np.testing.assert_allclose(quant.scores[:, 0].numpy(), exact.scores[:, 0].numpy(),
                               rtol=0.05, atol=0.05)
    jes8 = jax_get_eval_state(s["model"], s["params"], s["ids"], "MoLBruteForceTopKFusedInt8",
                              table_dtype=jnp.float32)
    jquant = jes8.top_k_fn(s["q"], 20, user_ids=s["uids"])
    j_overlap = np.mean([np.intersect1d(a, b).size / 20
                         for a, b in zip(np.asarray(jquant.ids), quant.ids.numpy())])
    assert j_overlap >= 0.9, j_overlap


def test_int8_fused_only_naive_dequantizes(trained):
    """`test_index.py:288-311`: on an int8 fused_only state Naive with the
    full budget stays within 0.05 of the f32 exact scores, as in JAX."""
    s = trained
    t_ids = torch.from_numpy(s["ids"])
    with torch.inference_mode():
        emb = s["port"].get_item_embeddings(t_ids)
        std = ptk.build_mol_topk_state(s["port"], t_ids, emb, table_dtype=torch.float32)
        state8 = ptk.build_mol_topk_state(s["port"], t_ids, emb, table_dtype=torch.float32,
                                          build_fused=True, fused_only=True, quantize_fused=True)
        ref = ptk.mol_brute_force_top_k(s["port"], std, s["tq"], 10, s["tuids"])
        got = ptk.mol_naive_top_k(s["port"], state8, s["tq"], 10, 300, s["tuids"])
    np.testing.assert_allclose(got.scores.numpy(), ref.scores.numpy(), rtol=0.05, atol=0.05)
    jstate8 = jtk.build_mol_topk_state(
        s["model"], s["params"], jnp.asarray(s["ids"]),
        s["model"].apply(s["params"], jnp.asarray(s["ids"]), method=s["model"].get_item_embeddings),
        table_dtype=jnp.float32, build_fused=True, fused_only=True, quantize_fused=True)
    want = jtk.mol_naive_top_k(s["model"], s["params"], jstate8, s["q"], 10, k_per_group=300,
                               user_ids=s["uids"])
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-4)
