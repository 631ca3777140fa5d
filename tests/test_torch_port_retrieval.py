"""rails_tpu_torch approximate retrieval vs rails_tpu on one tiny model.

A `synthetic-small` model over 1,200 items (5 tiles of 256 once padded, so
tile selection prunes) is built by `rails_tpu.train.loop.create_train_state`;
its weights reach the port through `state_dict_from_jax_params`. Both sides
score the same query embeddings against f32 tables built from the same item
embeddings. The JAX package's Pallas kernels run in interpret mode, the port's
wrappers run their plain versions on CPU tensors.

Tolerances: the kernels' plain versions to rtol/atol 1e-5
(`tests/test_certified.py:88`, `tests/test_tile_topk.py:104,287`); every
algorithm's scores to 1e-4 and its ids wherever a score differs from both
neighbours by more than 1e-5 (ties may order differently).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.core.config import get_experiment_config
from rails_tpu.data import datasets as jax_datasets
from rails_tpu.index import top_k as jtk
from rails_tpu.ops.pallas import mol_scoring as jax_mol
from rails_tpu.train.loop import create_train_state
from rails_tpu_torch.compat.from_jax import state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.index import top_k as ptk
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.ops import mol_scoring

NUM_ITEMS = 1200
K = 20


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
    params = state.params
    port = SequentialRecommender(port_cfg, NUM_ITEMS, device="cpu")
    port.load_state_dict(
        state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params), port_cfg),
        strict=True,
    )
    ids = jnp.asarray(all_ids)
    emb = model.apply(params, ids, method=model.get_item_embeddings)
    jstate = jtk.build_mol_topk_state(model, params, ids, emb, table_dtype=jnp.float32,
                                      build_fused=True)
    q = model.apply(params, batch.features, method=model.encode)
    uids = batch.features.user_ids
    with torch.inference_mode():
        t_ids = torch.from_numpy(all_ids)
        pstate = ptk.build_mol_topk_state(port, t_ids, port.get_item_embeddings(t_ids),
                                          table_dtype=torch.float32, build_fused=True)
    return dict(model=model, params=params, port=port, jstate=jstate, pstate=pstate, q=q,
                uids=uids, tq=torch.from_numpy(np.array(q)),
                tuids=torch.from_numpy(np.array(uids)), emb=emb)


def _q_comp(s):
    jq = s["model"].apply(s["params"], s["q"], s["uids"], method=s["model"].query_components)
    return jq, torch.from_numpy(np.array(jq))


def assert_same_result(got, want):
    """Scores to 1e-4; ids wherever a score stands 1e-5 apart from both neighbours."""
    scores, ids = np.asarray(want.scores), np.asarray(want.ids)
    assert tuple(got.ids.shape) == ids.shape
    np.testing.assert_allclose(got.scores.numpy(), scores, rtol=1e-4, atol=1e-4)
    gap = np.abs(np.diff(scores, axis=1)) > 1e-5
    isolated = np.ones_like(scores, dtype=bool)
    isolated[:, 1:] &= gap
    isolated[:, :-1] &= gap
    assert isolated.mean() > 0.8
    np.testing.assert_array_equal(got.ids.numpy()[isolated], ids[isolated])


def test_fused_tables_match_jax_layout(setup):
    """Padded to 256 like the JAX build; item_partial_t rows n-major."""
    jft, pft = setup["jstate"].fused_tables, setup["pstate"].fused_tables
    assert pft.item_comp_t.shape[2] == jft.item_comp_t.shape[2] == 1280
    np.testing.assert_allclose(pft.item_comp_t.numpy(), np.asarray(jft.item_comp_t),
                               rtol=1e-6, atol=1e-6)
    p_x, _, _ = pft.item_comp_t.shape
    perm = jax_mol.m_major_perm(pft.item_partial_t.shape[0] // p_x, p_x)
    np.testing.assert_allclose(pft.item_partial_t.numpy()[perm], np.asarray(jft.item_partial_t),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(setup["pstate"].avg_component.numpy(),
                               np.asarray(setup["jstate"].avg_component), rtol=1e-6, atol=1e-6)


def test_k8_plain_matches_pallas(setup):
    jq, tq = _q_comp(setup)
    temp = float(setup["model"].cfg.mol.temperature)
    want = jax_mol.fused_mol_ub_t(jq, setup["jstate"].fused_tables.item_comp_t, temp,
                                  block_x=256, interpret=True)
    got = mol_scoring.fused_mol_ub_t(tq, setup["pstate"].fused_tables.item_comp_t, temp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_k9_plain_matches_pallas_rows_permuted(setup):
    jq, tq = _q_comp(setup)
    temp = float(setup["model"].cfg.mol.temperature)
    want = np.asarray(jax_mol.fused_mol_group_block_max(
        jq, setup["jstate"].fused_tables.item_comp_t, temp, block_x=256, interpret=True))
    got = mol_scoring.fused_mol_group_block_max(
        tq, setup["pstate"].fused_tables.item_comp_t, temp).numpy()
    assert got.shape == want.shape == (16, 8, 5)
    perm = jax_mol.m_major_perm(4, 2)      # JAX row l' holds port row perm[l']
    np.testing.assert_allclose(got[:, perm], want, rtol=1e-5, atol=1e-5)


def test_k10_plain_matches_pallas(setup):
    """Shuffled tile ids with a duplicate and the last (padded) tile."""
    jq, tq = _q_comp(setup)
    s = setup
    temp = float(s["model"].cfg.mol.temperature)
    qp = s["model"].apply(s["params"], s["q"], method=s["model"].query_gating_partial)
    tiles = np.array([4, 0, 2, 2, 1], dtype=np.int32)
    jft, pft = s["jstate"].fused_tables, s["pstate"].fused_tables
    want = jax_mol.fused_mol_scores_tiles(
        jq, qp, jnp.asarray(tiles), jft.item_comp_t, jft.item_partial_t,
        jax_mol.extract_gating_qi_weights(s["params"]), temp, block_x=256, interpret=True)
    weights = mol_scoring.extract_gating_qi_weights(s["port"].mol)
    with torch.inference_mode():
        got = mol_scoring.fused_mol_scores_tiles(
            tq, torch.from_numpy(np.array(qp)), torch.from_numpy(tiles), pft.item_comp_t,
            pft.item_partial_t, weights, temp)
        full = mol_scoring.fused_mol_scores_t(
            tq, torch.from_numpy(np.array(qp)), pft.item_comp_t, pft.item_partial_t, weights,
            temp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    cols = (tiles[:, None] * 256 + np.arange(256)).reshape(-1)
    np.testing.assert_allclose(got.numpy(), full.numpy()[:, cols], rtol=1e-6, atol=1e-6)
    bad = mol_scoring.fused_mol_scores_tiles(
        tq, torch.from_numpy(np.array(qp)), torch.tensor([5, 1], dtype=torch.int32),
        pft.item_comp_t, pft.item_partial_t, weights, temp)
    assert bool(bad[:, :256].isnan().all()) and not bool(bad[:, 256:].isnan().any())


# name -> (JAX call, port call), budgets that leave items unexamined. The JAX
# side runs jitted (one compile instead of one per op).
def _cases(s, jstate, pstate):
    m, port = s["model"], s["port"]
    tq, tu = s["tq"], s["tuids"]

    def jit(fn):
        return lambda: jax.jit(lambda p, st, q, u: fn(m, p, st, q, K, user_ids=u))(
            s["params"], jstate, s["q"], s["uids"])

    return {
        "cert": (jit(lambda *a, **kw: jtk.mol_certified_top_k(*a, cand_budget=600, **kw)),
                 lambda: ptk.mol_certified_top_k(port, pstate, tq, K, 600, tu)),
        "tile": (jit(lambda *a, **kw: jtk.mol_tile_top_k(*a, tiles_per_group=1,
                                                         certified=True, **kw)),
                 lambda: ptk.mol_tile_top_k(port, pstate, tq, K, 1, tu, certified=True)),
        "tile_shared": (
            jit(lambda *a, **kw: jtk.mol_tile_top_k_shared(*a, tiles_per_group=1,
                                                           certified=True, **kw)),
            lambda: ptk.mol_tile_top_k_shared(port, pstate, tq, K, 1, tu, certified=True)),
        "tile_shared_budget": (
            jit(lambda *a, **kw: jtk.mol_tile_top_k_shared(*a, tiles_per_group=2, tile_budget=2,
                                                           certified=True, **kw)),
            lambda: ptk.mol_tile_top_k_shared(port, pstate, tq, K, 2, tu, tile_budget=2,
                                              certified=True)),
        "naive": (jit(lambda *a, **kw: jtk.mol_naive_top_k(*a, k_per_group=8, certified=True,
                                                           **kw)),
                  lambda: ptk.mol_naive_top_k(port, pstate, tq, K, 8, tu, certified=True)),
        "naive_streamed": (
            jit(lambda *a, **kw: jtk.mol_naive_top_k(*a, k_per_group=8, corpus_chunk=500,
                                                     certified=True, **kw)),
            lambda: ptk.mol_naive_top_k(port, pstate, tq, K, 8, tu, corpus_chunk=500,
                                        certified=True)),
        "avg": (jit(lambda *a, **kw: jtk.mol_avg_top_k(*a, avg_top_k=100, **kw)),
                lambda: ptk.mol_avg_top_k(port, pstate, tq, K, 100, tu)),
        "comb": (jit(lambda *a, **kw: jtk.mol_comb_top_k(*a, avg_top_k=100, k_per_group=8,
                                                         certified=True, **kw)),
                 lambda: ptk.mol_comb_top_k(port, pstate, tq, K, 100, 8, tu, certified=True)),
    }


ALGORITHMS = ["cert", "tile", "tile_shared", "tile_shared_budget", "naive",
              "naive_streamed", "avg", "comb"]


def _run(s, name, fused_only=False):
    jstate, pstate = s["jstate"], s["pstate"]
    if fused_only:
        jstate = jtk.build_mol_topk_state(
            s["model"], s["params"], jnp.asarray(np.asarray(pstate.item_ids)), s["emb"],
            table_dtype=jnp.float32, build_fused=True, fused_only=True)
        with torch.inference_mode():
            pstate = ptk.build_mol_topk_state(
                s["port"], pstate.item_ids, s["port"].get_item_embeddings(pstate.item_ids),
                table_dtype=torch.float32, build_fused=True, fused_only=True)
        assert pstate.item_tables.component_embeddings.shape[0] == 0
    j_call, p_call = _cases(s, jstate, pstate)[name]
    want = j_call()
    with torch.inference_mode():
        got = p_call()
    return got, want


@pytest.mark.parametrize("name", ALGORITHMS)
def test_algorithm_matches_jax(setup, name):
    got, want = _run(setup, name)
    if not isinstance(want, jtk.TopKResult):
        (got, got_cert), (want, want_cert) = got, want
        np.testing.assert_array_equal(got_cert.certified.numpy(), np.asarray(want_cert.certified))
        for field in ("ub_unexamined", "kth_score", "gap_bound"):
            np.testing.assert_allclose(getattr(got_cert, field).numpy(),
                                       np.asarray(getattr(want_cert, field)),
                                       rtol=1e-4, atol=1e-4, err_msg=field)
    assert_same_result(got, want)


@pytest.mark.parametrize("name", ["cert", "tile", "naive", "avg", "comb"])
def test_fused_only_state_matches_jax(setup, name):
    got, want = _run(setup, name, fused_only=True)
    if not isinstance(want, jtk.TopKResult):
        got, want = got[0], want[0]
    assert_same_result(got, want)


def test_mips_matches_jax(setup):
    s = setup
    want = jtk.mips_brute_force_top_k(s["jstate"].item_ids, s["emb"], s["q"], K)
    got = ptk.mips_brute_force_top_k(s["pstate"].item_ids, torch.from_numpy(np.array(s["emb"])),
                                     s["tq"], K)
    assert_same_result(got, want)


@pytest.mark.parametrize("cand_chunk", [None, 64], ids=["one_shot", "chunked"])
def test_dedup_rerank_matches_jax(setup, cand_chunk):
    """Duplicates and pad-id candidates: pads rank below duplicates."""
    s = setup
    rng = np.random.default_rng(4)
    cands = rng.integers(0, 200, size=(16, 150)).astype(np.int32)
    cands[:, :10] = cands[:, 10:20]            # duplicates
    want = jtk.dedup_rerank_top_k(s["model"], s["params"], s["jstate"], s["q"],
                                  jnp.asarray(cands), 100, s["uids"], cand_chunk=cand_chunk)
    with torch.inference_mode():
        got = ptk.dedup_rerank_top_k(s["port"], s["pstate"], s["tq"],
                                     torch.from_numpy(cands).long(), 100, s["tuids"],
                                     cand_chunk=cand_chunk)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-4)
    assert (got.scores.numpy() == ptk.NEG_DUP).any()   # fewer distinct than k: duplicates show


def _exact(s):
    with torch.inference_mode():
        return ptk.mol_brute_force_top_k(s["port"], s["pstate"], s["tq"], K, s["tuids"])


@pytest.mark.parametrize("name", ["cert", "naive", "comb"])
def test_certified_rows_are_exact(setup, name):
    """certified => the returned top-k is the brute-force top-k; budgets at
    which this model certifies some rows."""
    s = setup
    port, state, tq, tu = s["port"], s["pstate"], s["tq"], s["tuids"]
    with torch.inference_mode():
        if name == "cert":
            res, cert = ptk.mol_certified_top_k(port, state, tq, K, 600, tu)
            assert not bool(cert.certified.all())
        elif name == "naive":
            res, cert = ptk.mol_naive_top_k(port, state, tq, K, 200, tu, certified=True)
        else:
            res, cert = ptk.mol_comb_top_k(port, state, tq, K, 100, 200, tu, certified=True)
    exact = _exact(s)
    rows = cert.certified.numpy()
    assert rows.any()
    np.testing.assert_allclose(res.scores.numpy()[rows], exact.scores.numpy()[rows],
                               rtol=1e-4, atol=1e-4)
    assert bool((cert.gap_bound >= 0).all())
    gap = (exact.scores[:, -1] - res.scores[:, -1]).numpy()      # true rank-k gap
    assert bool((cert.gap_bound.numpy() >= gap - 1e-4).all())


def test_full_coverage_equals_brute_force_and_certifies(setup):
    s = setup
    exact = _exact(s)
    with torch.inference_mode():
        cert_res, cert = ptk.mol_certified_top_k(s["port"], s["pstate"], s["tq"], K, NUM_ITEMS,
                                                 s["tuids"])
        tile_res, tile_cert = ptk.mol_tile_top_k_shared(s["port"], s["pstate"], s["tq"], K, 5,
                                                        s["tuids"], certified=True)
    for res, c in ((cert_res, cert), (tile_res, tile_cert)):
        assert bool(c.certified.all())
        np.testing.assert_allclose(res.scores.numpy(), exact.scores.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_bounds_dominate_scores(setup):
    """UB >= the exact score of every item; gmax >= the score of every item
    of the tile."""
    s = setup
    _, tq = _q_comp(s)
    ft = s["pstate"].fused_tables
    temp = float(s["model"].cfg.mol.temperature)
    with torch.inference_mode():
        scores = s["port"].score_precomputed(s["tq"], s["pstate"].item_tables, s["tuids"])
    ub = mol_scoring.fused_mol_ub_t(tq, ft.item_comp_t, temp)[:, :NUM_ITEMS]
    assert bool((ub >= scores - 1e-5).all())
    gmax = mol_scoring.fused_mol_group_block_max(tq, ft.item_comp_t, temp).amax(dim=1)
    tile_of = torch.arange(NUM_ITEMS) // 256
    assert bool((gmax[:, tile_of] >= scores - 1e-5).all())


def test_state_without_gating_partial_matches_jax(setup):
    """A similarity without the item gating partial (`gating_item_fn=False`,
    the `none` combination) gets a state with no gating table and no fused
    tables, as in JAX (`top_k.py:158,201-204`): the port's model of that
    config, with the same weights but the item gating MLP it does not have."""
    model, params, port = setup["model"], setup["params"], setup["port"]
    none = dict(gating_combination_type="none", gating_item_fn=False)
    cfg = model.cfg.replace(mol=model.cfg.mol.replace(**none))
    jmodel = model.clone(cfg=cfg)
    ids = jnp.arange(1, NUM_ITEMS + 1, dtype=jnp.int32)
    jstate = jtk.build_mol_topk_state(jmodel, params, ids, setup["emb"],
                                      table_dtype=jnp.bfloat16, build_fused=True)
    assert jstate.fused_tables is None and jstate.item_tables.gating_partial is None
    stand_in = SequentialRecommender(port.cfg.replace(mol=port.cfg.mol.replace(**none)),
                                     NUM_ITEMS, device="cpu")
    stand_in.load_state_dict({k: v for k, v in port.state_dict().items()
                              if not k.startswith("mol.gating_item.")}, strict=True)
    t_ids = torch.from_numpy(np.array(ids))
    with torch.inference_mode():
        emb = port.get_item_embeddings(t_ids)
        pstate = ptk.build_mol_topk_state(stand_in, t_ids, emb, torch.bfloat16, build_fused=True)
        with pytest.raises(ValueError, match="gating partial"):
            ptk.build_mol_topk_state(stand_in, t_ids, emb, torch.bfloat16, build_fused=True,
                                     fused_only=True)
    assert pstate.fused_tables is None and pstate.item_tables.gating_partial is None
    for got, want in ((pstate.item_tables.component_embeddings,
                       jstate.item_tables.component_embeddings),
                      (pstate.avg_component, jstate.avg_component)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("combination", ["glu_silu_ln", "none"])
def test_fused_spelling_refuses_other_combinations(setup, combination):
    """K2 computes the glu_silu combination alone, so the port builds no
    fused tables for another one and `MoLBruteForceTopKFused` raises before
    any launch; `MoLBruteForceTopK` scores the same state."""
    port = setup["port"]
    cfg = port.cfg.replace(mol=port.cfg.mol.replace(gating_combination_type=combination))
    other = SequentialRecommender(cfg, NUM_ITEMS, device="cpu")
    other.load_state_dict(port.state_dict(), strict=True)
    t_ids = torch.arange(1, NUM_ITEMS + 1, dtype=torch.int32)
    with torch.inference_mode():
        state = ptk.build_mol_topk_state(other, t_ids, other.get_item_embeddings(t_ids),
                                         table_dtype=torch.float32, build_fused=True)
        assert state.fused_tables is None
        with pytest.raises(ValueError, match="glu_silu"):
            ptk.mol_brute_force_top_k_fused(other, state, setup["tq"], 10, setup["tuids"])
        res = ptk.mol_brute_force_top_k(other, state, setup["tq"], 10, setup["tuids"])
    assert res.ids.shape == (setup["tq"].shape[0], 10)
