"""The port's IVF retrieval (`rails_tpu_torch.index.ivf`) vs rails_tpu's.

A `synthetic-small` model with random weights (JAX's, loaded into the port
through `state_dict_from_jax_params`) over a corpus of 600 items, nlist
8-16, on the CPU. The k-means++ seeding draws from other generators on the
two sides, so the Lloyd iterations start from JAX's own seeds (the port's
`_kmeanspp_init` patched to return them) and the index builder from JAX's
centroids (the port's `kmeans` patched); the query path runs on JAX's index
carried over. Tolerances: centroids within 1e-5, MoL means within 1e-5 of
the largest value, list similarities within 1e-6 of the largest, rerank
scores within 1e-4 with ids equal wherever a score stands more than 1e-5
from its neighbours; the host-side fill and the permutations bit-equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.core.config import get_experiment_config
from rails_tpu.data import datasets as jax_datasets
from rails_tpu.index import ivf as jivf
from rails_tpu.index import top_k as jtk
from rails_tpu.index.factory import parse_top_k_budgets as jax_parse
from rails_tpu.train import evaluation as jax_eval
from rails_tpu.train.loop import create_train_state
from rails_tpu_torch.compat.from_jax import _tensor, fused_tables_from_jax, state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.data.features import SequentialFeatures
from rails_tpu_torch.index import ivf
from rails_tpu_torch.index import top_k as ptk
from rails_tpu_torch.index.factory import get_top_k_raw, parse_top_k_budgets
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.similarity.mol import MoLItemTables
from rails_tpu_torch.train import evaluation as port_eval

NUM_ITEMS, K = 600, 20
CENT_TOL = 1e-5
SCORE_TOL = 1e-4


def _small(cfg):
    return cfg.replace(
        data=cfg.data.replace(synthetic_num_users=64, synthetic_num_items=NUM_ITEMS),
        train=cfg.train.replace(local_batch_size=16, num_negatives=8),
    )


@pytest.fixture(autouse=True)
def _inference():
    # The port's serving functions run under inference mode, as its eval
    # step does (their states are inference tensors).
    with torch.inference_mode():
        yield


@pytest.fixture(scope="module")
def setup():
    cfg = _small(get_experiment_config("synthetic-small"))
    port_cfg = _small(port_config.get_experiment_config("synthetic-small"))
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.eval_dataset.batches(
        batch_size=16, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    all_ids = np.arange(1, NUM_ITEMS + 1, dtype=np.int32)
    model, state, _, _ = create_train_state(cfg, NUM_ITEMS, all_ids, batch)
    params = state.params
    port = SequentialRecommender(port_cfg, NUM_ITEMS, device="cpu")
    port.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                                    port_cfg), strict=True)
    q = jax.jit(lambda p, f: model.apply(p, f, method=model.encode))(params, batch.features)
    feats = SequentialFeatures(*(torch.from_numpy(np.array(f)) for f in batch.features))
    return dict(model=model, params=params, port=port, ids=all_ids, batch=batch, q=q,
                uids=batch.features.user_ids, feats=feats,
                t_q=torch.from_numpy(np.array(q)), t_uids=feats.user_ids)


def _jax_state(s, **kw):
    ids = jnp.asarray(s["ids"])
    emb = jax.jit(lambda p, i: s["model"].apply(p, i, method=s["model"].get_item_embeddings))(
        s["params"], ids)
    kw.setdefault("table_dtype", jnp.float32)
    return jtk.build_mol_topk_state(s["model"], s["params"], ids, emb, **kw)


def _port_ivf(j):
    return ivf.IVFIndex(*(None if a is None else _tensor(a) for a in j))


def _port_state(j):
    """The port's state holding the JAX state's tables, bit for bit."""
    it = j.item_tables
    return ptk.MoLTopKState(
        item_ids=_tensor(j.item_ids),
        item_tables=MoLItemTables(_tensor(it.component_embeddings),
                                  None if it.gating_partial is None else _tensor(it.gating_partial)),
        avg_component=_tensor(j.avg_component),
        fused_tables=None if j.fused_tables is None else fused_tables_from_jax(j.fused_tables),
        ivf=None if j.ivf is None else _port_ivf(j.ivf),
    )


def _clustered(seed, n, d, centers, spread=0.3):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)) * 4.0
    return (c[rng.integers(0, centers, n)] + spread * rng.standard_normal((n, d))).astype(
        np.float32)


def _jax_seeds(data, nlist, seed, valid):
    return np.array(jivf._kmeanspp_init(
        jnp.asarray(data), min(nlist, data.shape[0]), jax.random.PRNGKey(seed),
        valid=None if valid is None else jnp.asarray(valid)))


KMEANS_CASES = {
    # 333 rows in chunks of 100 (a short last chunk), pad rows masked out.
    "masked_tail": dict(data=lambda: _clustered(0, 333, 8, 6), nlist=12, chunk=100,
                        valid=lambda x: np.arange(x) % 7 != 3),
    # Three distinct points, 128 copies each: the seeds repeat, the first
    # of equal centroids takes every point, so most clusters empty out and
    # more clusters are empty than not (donors shared), with tied counts.
    "shared_donors": dict(data=lambda: np.repeat(np.eye(3, 6, dtype=np.float32) * 5, 128, axis=0),
                          nlist=16, chunk=96, valid=None),
    "many_lists": dict(data=lambda: _clustered(2, 600, 16, 20), nlist=32, chunk=256,
                       valid=None),
}


@pytest.mark.parametrize("case", sorted(KMEANS_CASES))
def test_lloyd_iterations_match_jax(case, monkeypatch):
    c = KMEANS_CASES[case]
    data = c["data"]()
    valid = None if c["valid"] is None else c["valid"](data.shape[0])
    seeds = _jax_seeds(data, c["nlist"], 0, valid)
    want = np.asarray(jivf.kmeans(jnp.asarray(data), c["nlist"], num_iters=6, seed=0,
                                  chunk=c["chunk"],
                                  valid=None if valid is None else jnp.asarray(valid)))
    monkeypatch.setattr(ivf, "_kmeanspp_init", lambda *a, **kw: torch.from_numpy(seeds))
    got = ivf.kmeans(torch.from_numpy(data), c["nlist"], num_iters=6, seed=0, chunk=c["chunk"],
                     valid=None if valid is None else torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CENT_TOL)
    if case == "shared_donors":
        # The case exercises what it says: after one iteration most lists are
        # empty and donors serve several of them.
        t = torch.from_numpy(seeds)
        assign = torch.argmax(torch.from_numpy(data) @ t.T - 0.5 * (t * t).sum(1), dim=1)
        nonempty = len(torch.unique(assign))
        assert c["nlist"] - nonempty > nonempty


def test_kmeans_seeding_recovers_separated_clusters():
    """The port's own k-means++ seeding (torch generator): every true center
    gets a centroid, and one seed gives the same centroids twice."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((8, 16)) * 10.0
    data = torch.from_numpy((np.repeat(centers, 64, axis=0)
                             + rng.standard_normal((512, 16))).astype(np.float32))
    cent = ivf.kmeans(data, 8, num_iters=15, chunk=128)
    d = np.linalg.norm(cent.numpy()[None] - centers[:, None], axis=-1)
    assert float(d.min(axis=1).max()) < 2.0
    assert torch.equal(cent, ivf.kmeans(data, 8, num_iters=15, chunk=128))
    assert not torch.equal(cent, ivf.kmeans(data, 8, num_iters=15, chunk=128, seed=1))


def test_assign_choices_and_balanced_fill_match_jax():
    data = _clustered(3, 500, 8, 10)
    cent = _clustered(4, 12, 8, 12)
    want_c, want_v = jivf.assign_choices(jnp.asarray(data), jnp.asarray(cent), 4, chunk=128)
    got_c, got_v = ivf.assign_choices(torch.from_numpy(data), torch.from_numpy(cent), 4, chunk=128)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-6 * np.abs(want_v).max())
    for cap in (8, 48, 64):
        for got, want in zip(ivf._balanced_fill(want_c, want_v, 12, cap),
                             jivf._balanced_fill(want_c, want_v, 12, cap)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


MEANS_CASES = {
    "standard": dict(),
    "fused_f32": dict(build_fused=True, fused_only=True),
    "fused_bf16": dict(build_fused=True, fused_only=True, table_dtype=jnp.bfloat16),
    "fused_int8": dict(build_fused=True, fused_only=True, quantize_fused=True),
}


@pytest.mark.parametrize("case", sorted(MEANS_CASES))
def test_mol_cluster_means_match_jax(setup, case):
    """Per-cluster means of the member tables, -1 rows (and the kernel pad
    past the assignment) excluded; the port's fused gating rows come back in
    the n-major order without JAX's inverse permutation."""
    j = _jax_state(setup, **MEANS_CASES[case])
    assign = np.random.default_rng(5).integers(-1, 10, NUM_ITEMS).astype(np.int32)
    want = [np.asarray(a) for a in jivf._mol_cluster_means(j, assign, 10, chunk=256)]
    got = [a.numpy() for a in ivf._mol_cluster_means(_port_state(j), assign, 10, chunk=256)]
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=CENT_TOL * np.abs(w).max())


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
def test_build_ivf_index_matches_jax(setup, fused, monkeypatch):
    """With JAX's centroids: buckets, overflow, cluster perm equal; the MoL
    means within tolerance. cap_factor 1.1 makes an overflow list."""
    j = _jax_state(setup, build_fused=fused)
    kw = dict(nlist=12, num_iters=4, cap_factor=1.1, num_choices=2, chunk=256,
              return_cluster_perm=True)
    want, want_perm = jivf.build_ivf_index(j.avg_component, j.item_ids, mol_state=j, **kw)
    monkeypatch.setattr(ivf, "kmeans", lambda *a, **k: _tensor(want.centroids))
    p = _port_state(j)
    got, perm = ivf.build_ivf_index(p.avg_component, p.item_ids, mol_state=p, **kw)
    assert want.overflow.shape[0] > 0 and want.overflow.shape[0] % 8 == 0
    assert got.buckets.shape[1] == -(-int(np.ceil(1.1 * NUM_ITEMS / 12)) // 8) * 8
    np.testing.assert_array_equal(got.buckets.numpy(), np.asarray(want.buckets))
    np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(want.overflow))
    np.testing.assert_array_equal(perm, np.asarray(want_perm))
    for g, w in ((got.comp_centroids, want.comp_centroids),
                 (got.gating_centroids, want.gating_centroids)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=CENT_TOL * np.abs(w).max())


def test_build_covers_every_real_position_once(setup):
    """The port's own index (its own k-means): every real position exactly
    once in buckets + overflow, fill <= cap, pad rows (id 0) nowhere."""
    j = _jax_state(setup)
    p = _port_state(j)
    ids = p.item_ids.clone()
    ids[[3, 77, 599]] = 0
    index = ivf.build_ivf_index(p.avg_component, ids, nlist=16, num_iters=4, cap_factor=1.2,
                                chunk=256)
    b, o = index.buckets.numpy(), index.overflow.numpy()
    cap = b.shape[1]
    real = np.nonzero(ids.numpy())[0]
    counts = np.bincount(np.concatenate([b.ravel(), o]), minlength=NUM_ITEMS)
    assert (counts[real[real != 0]] == 1).all()
    assert (counts[[3, 77, 599]] == 0).all()
    assert ((b != 0).sum(axis=1) <= cap).all()


def _isolated_equal(got, want):
    scores = np.asarray(want.scores)
    assert got.scores.shape == scores.shape
    np.testing.assert_allclose(got.scores.numpy(), scores, rtol=SCORE_TOL, atol=SCORE_TOL)
    gap = np.abs(np.diff(scores, axis=1)) > 1e-5
    isolated = np.ones_like(scores, dtype=bool)
    isolated[:, 1:] &= gap
    isolated[:, :-1] &= gap
    assert isolated.mean() > 0.8
    np.testing.assert_array_equal(got.ids.numpy()[isolated], np.asarray(want.ids)[isolated])


@pytest.mark.parametrize("nprobe", [2, 5])
@pytest.mark.parametrize("mol_probes", [False, True], ids=["avg_probes", "mol_probes"])
def test_mol_ivf_top_k_matches_jax(setup, nprobe, mol_probes):
    j = _jax_state(setup)
    index = jivf.build_ivf_index(j.avg_component, j.item_ids, nlist=12, num_iters=4, chunk=256,
                                 mol_state=j if mol_probes else None)
    j = j._replace(ivf=index)
    want = jivf.mol_ivf_top_k(setup["model"], setup["params"], j, setup["q"], K, nprobe=nprobe,
                              user_ids=setup["uids"], cand_chunk=64)
    got = ivf.mol_ivf_top_k(setup["port"], _port_state(j), setup["t_q"], K, nprobe=nprobe,
                            user_ids=setup["t_uids"], cand_chunk=64)
    _isolated_equal(got, want)


def test_full_probe_is_brute_force_and_split_is_one_pass(setup):
    """Every list probed: the exact brute force's scores; on fused tables a
    pool budget of a few bytes splits the batch into single queries and
    gives the one-pass result."""
    j = _jax_state(setup, build_fused=True)
    index = jivf.build_ivf_index(j.avg_component, j.item_ids, nlist=10, num_iters=4, chunk=256,
                                 mol_state=j)
    p = _port_state(j._replace(ivf=index))
    port, q, uids = setup["port"], setup["t_q"], setup["t_uids"]
    exact = ptk.mol_brute_force_top_k(port, p, q, K, uids)
    full = ivf.mol_ivf_top_k(port, p, q, K, nprobe=10, user_ids=uids)
    np.testing.assert_allclose(full.scores.numpy(), exact.scores.numpy(), rtol=1e-6, atol=1e-6)
    one = ivf.mol_ivf_top_k(port, p, q, K, nprobe=3, user_ids=uids)
    split = ivf.mol_ivf_top_k(port, p, q, K, nprobe=3, user_ids=uids, pool_budget_bytes=8)
    # One query at a time sums its products in another order than 16.
    _isolated_equal(split, one)


def test_permute_state_items_matches_jax(setup):
    """Every table and the remapped index equal to JAX's relayout, bit for
    bit; the exact fused method returns the same ids and scores."""
    j = _jax_state(setup, build_fused=True)
    index, perm = jivf.build_ivf_index(j.avg_component, j.item_ids, nlist=8, num_iters=4,
                                       chunk=256, mol_state=j, return_cluster_perm=True)
    j = j._replace(ivf=index)
    want = _port_state(jtk.permute_state_items(j, perm))
    p = _port_state(j)
    got = ptk.permute_state_items(p, perm)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        if isinstance(w, torch.Tensor):
            assert torch.equal(g, w)
    assert got.fused_tables.num_items == NUM_ITEMS
    port, q, uids = setup["port"], setup["t_q"], setup["t_uids"]
    a = ptk.mol_brute_force_top_k_fused(port, p, q, K, uids)
    b = ptk.mol_brute_force_top_k_fused(port, got, q, K, uids)
    assert torch.equal(a.scores, b.scores) and torch.equal(a.ids, b.ids)
    a = ivf.mol_ivf_top_k(port, p, q, K, nprobe=8, user_ids=uids)
    b = ivf.mol_ivf_top_k(port, got, q, K, nprobe=8, user_ids=uids)
    assert torch.equal(a.ids, b.ids)


def test_factory_spelling_and_budgets():
    raw = get_top_k_raw("MoLIVFTopK4")
    assert callable(raw)
    for m in ("MoLIVFTopK4", "MoLIVFTopK128"):
        assert parse_top_k_budgets(m) == jax_parse(m) == {"nprobe": int(m[10:])}


@pytest.mark.parametrize("ivf_nlist", [None, 9])
def test_get_eval_state_nlist_rule(setup, ivf_nlist):
    es = port_eval.get_eval_state(setup["port"], setup["ids"], "MoLIVFTopK4",
                                  table_dtype=torch.float32, device="cpu", ivf_nlist=ivf_nlist)
    want = ivf_nlist or max(16, int(4 * np.sqrt(NUM_ITEMS)))
    index = es.topk_state.ivf
    assert index.centroids.shape[0] == want
    assert index.comp_centroids.shape[0] == want and index.gating_centroids is not None
    assert es.topk_state.fused_tables is None


def test_eval_step_matches_jax(setup):
    """`make_eval_step_fn` with MoLIVFTopK4 on JAX's eval state (its index
    carried over): JAX's ranks; ids and scores as above."""
    s = setup
    method, k = "MoLIVFTopK4", 30
    jes = jax_eval.get_eval_state(s["model"], s["params"], s["ids"], method,
                                  table_dtype=jnp.float32, ivf_nlist=12)
    pes = port_eval.get_eval_state(s["port"], s["ids"], method, table_dtype=torch.float32,
                                   device="cpu", ivf_nlist=12)
    pes.topk_state = pes.topk_state._replace(ivf=_port_ivf(jes.topk_state.ivf))
    jstep = jax_eval.make_eval_step_fn(s["model"], method, k=k, num_objects=jes.num_objects,
                                       truncate_k_prime_to=60)
    ranks, ids, scores = (np.asarray(a) for a in jstep(
        s["params"], jes.topk_state, jes.item_embeddings, s["batch"].features,
        s["batch"].target_ids))
    pstep = port_eval.make_eval_step_fn(s["port"], method, k=k, num_objects=pes.num_objects,
                                        truncate_k_prime_to=60)
    p_ranks, p_ids, p_scores = pstep(pes.topk_state, s["feats"],
                                     torch.from_numpy(np.array(s["batch"].target_ids)))
    np.testing.assert_array_equal(p_ranks.numpy(), ranks)
    _isolated_equal(type("R", (), {"scores": p_scores, "ids": p_ids}),
                    type("R", (), {"scores": scores, "ids": ids}))
