"""The port's item-sharded retrieval (`rails_tpu_torch/index/sharded.py`) vs
rails_tpu's, over 2 and 4 gloo ranks on the CPU.

Mirrors `tests/test_sharding.py`'s `TestShardedTopK`,
`TestShardedEvalThroughRecall` and `TestShardedPadRowMasking`: a
`synthetic-small` model trained 3 steps by JAX (301 items, which no shard
count divides) carries its weights to the port through
`state_dict_from_jax_params`. The ranks (`tests/torch_port_ranks.py`,
spawned by `core.distributed.run_ranks` with a 300 s limit) import the port
alone; JAX runs here, on the 8-device virtual CPU mesh, with its Pallas
kernels in interpret mode, and the port's ranks on the kernels' plain
versions. The same 16 queries go through both.

Tolerances: scores within 1e-4 (the port's f32 model against JAX's, a
different summation order); ids equal wherever the reference's score stands
more than 1e-4 from every other in its row (the tie rule). Exact methods are
held against JAX's unsharded brute force, approximate ones against JAX's
sharded result at the same shard count, which has the same slab boundaries.
Every rank returns the same merged list, bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import torch_port_ranks as R
from rails_tpu_torch.compat.from_jax import fused_tables_from_jax, state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.core.distributed import run_ranks
from rails_tpu_torch.index import ivf as pivf
from rails_tpu_torch.index import top_k as ptk
from rails_tpu_torch.similarity.mol import MoLItemTables

TOL = 1e-4
RANK_TIMEOUT = 300.0


def _small(cfg):
    return cfg.replace(
        data=cfg.data.replace(synthetic_num_users=128, synthetic_num_items=301),
        train=cfg.train.replace(local_batch_size=16, num_negatives=8),
    )


def assert_topk_match(got, want, tol=TOL):
    """Scores within `tol`; ids equal except where the reference's score
    ties another within `tol`."""
    gs, gi = (np.asarray(a) for a in got)
    ws, wi = (np.asarray(a) for a in want)
    np.testing.assert_allclose(gs, ws, rtol=tol, atol=tol)
    for b, j in zip(*np.nonzero(gi != wi)):
        assert (np.abs(ws[b] - ws[b, j]) < tol).sum() > 1, (b, j, gi[b], wi[b])


@pytest.fixture(scope="module")
def trained():
    import jax

    from rails_tpu.core.config import get_experiment_config
    from rails_tpu.data.datasets import get_reco_dataset
    from rails_tpu.train.loop import create_train_state

    cfg = _small(get_experiment_config("synthetic-small"))
    ds = get_reco_dataset(cfg.data)
    batches = list(ds.train_dataset.batches(
        batch_size=16, max_output_length=cfg.train.gr_output_length + 1, shuffle=True, seed=0,
        drop_last=True))
    model, state, train_step, _ = create_train_state(cfg, ds.max_item_id, ds.all_item_ids,
                                                     batches[0])
    rng = jax.random.PRNGKey(0)
    for batch in batches[:3]:
        state, _ = train_step(state, batch, rng)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    port_cfg = _small(port_config.get_experiment_config("synthetic-small"))
    return dict(cfg=cfg, ds=ds, model=model, params=params, batches=batches, port_cfg=port_cfg,
                state_dict=state_dict_from_jax_params(params, port_cfg))


def _np_features(f):
    return tuple(np.asarray(a) for a in f)


@pytest.fixture(scope="module")
def jax_states(trained):
    import jax.numpy as jnp

    from rails_tpu.index.top_k import build_mol_topk_state
    from rails_tpu.train.evaluation import get_eval_state

    t = trained
    es = get_eval_state(t["model"], t["params"], t["ds"].all_item_ids, "MoLBruteForceTopK",
                        table_dtype=jnp.float32)
    feats = t["batches"][0].features
    q = t["model"].apply(t["params"], feats, method=t["model"].encode)

    def fused(**kw):
        return build_mol_topk_state(t["model"], t["params"], es.all_item_ids, es.item_embeddings,
                                    table_dtype=jnp.float32, build_fused=True, **kw)

    return dict(es=es, q=q, feats=feats, std=es.topk_state, fused=fused(),
                fused_only=fused(fused_only=True), int8=fused(quantize_fused=True))


@pytest.fixture(scope="module")
def negative_corpus():
    """score_i = -(X - i) <q, 1> < 0 for every item: the 5 least negative are
    the last ones, in the last (padded) shard (`test_sharding.py:371-386`)."""
    rng = np.random.default_rng(0)
    d, x, b = 8, 37, 4
    q = (np.abs(rng.normal(size=(b, d))) + 0.1).astype(np.float32)
    items = (-np.arange(x, 0, -1, dtype=np.float32)[:, None] * np.ones((x, d), np.float32))
    return dict(q=q, items=items)


def _jax_ivf(jax_states):
    from rails_tpu.index.ivf import build_sharded_ivf

    return build_sharded_ivf(jax_states["std"], 2, nlist=8, num_iters=3, chunk=4096)


@pytest.fixture(scope="module")
def port_ivf(jax_states):
    """The port's stacked 2-shard index over JAX's avg table, its k-means
    patched to return JAX's per-shard centroids in shard order."""
    want = _jax_ivf(jax_states)
    std = jax_states["std"]
    cents = iter(torch.from_numpy(np.asarray(c)) for c in want.centroids)
    state = ptk.MoLTopKState(
        item_ids=torch.from_numpy(np.asarray(std.item_ids)),
        item_tables=MoLItemTables(torch.from_numpy(np.asarray(std.item_tables.component_embeddings)),
                                  torch.from_numpy(np.asarray(std.item_tables.gating_partial))),
        avg_component=torch.from_numpy(np.asarray(std.avg_component)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pivf, "kmeans", lambda *a, **kw: next(cents))
        got = pivf.build_sharded_ivf(state, 2, nlist=8, num_iters=3, chunk=4096)
    return got, want


def _run(fn, world, tmp_path_factory, payload):
    d = str(tmp_path_factory.mktemp(f"{fn.__name__}{world}"))
    path = os.path.join(d, "payload.pt")
    torch.save(payload, path)
    run_ranks(fn, world, (world, os.path.join(d, "store"), path, d), timeout=RANK_TIMEOUT)
    return R.load_results(d, world)


@pytest.fixture(scope="module")
def ranks(trained, jax_states, negative_corpus, port_ivf, tmp_path_factory):
    import jax

    t = trained
    payload = dict(cfg=t["port_cfg"], num_items=t["ds"].max_item_id, state_dict=t["state_dict"],
                   all_item_ids=np.asarray(t["ds"].all_item_ids),
                   feats=_np_features(jax_states["feats"]),
                   batches=[(_np_features(b.features), np.asarray(b.target_ids))
                            for b in t["batches"][:2]],
                   ivf=port_ivf[0], negative=negative_corpus,
                   int8_tables=fused_tables_from_jax(
                       jax.tree_util.tree_map(np.asarray, jax_states["int8"].fused_tables)))
    return {w: _run(R.sharded_rank, w, tmp_path_factory, payload) for w in (2, 4)}


def _jax_sharded(trained, jax_states, world, kind, method, k, kw):
    from rails_tpu.core.config import MeshConfig
    from rails_tpu.core.mesh import make_mesh, replicate
    from rails_tpu.index.sharded import make_sharded_top_k_fn, pad_and_shard_state

    t, s = trained, jax_states
    state = s["std"]._replace(ivf=_jax_ivf(s)) if kind == "ivf" else s[kind]
    mesh = make_mesh(MeshConfig(item_parallel=world))
    fn = make_sharded_top_k_fn(method, t["model"], replicate(t["params"], mesh),
                               pad_and_shard_state(state, mesh), mesh, k=k, **kw)
    res = fn(s["q"], user_ids=s["feats"].user_ids)
    return np.asarray(res.scores), np.asarray(res.ids)


def _case(world, name):
    return next(c for c in R.SHARDED_CASES[world] if c[0] == name)


def test_queries_match_jax(ranks, jax_states):
    np.testing.assert_allclose(ranks[4][0]["q"], np.asarray(jax_states["q"]), rtol=TOL, atol=TOL)


def test_every_rank_returns_the_same_list(ranks):
    for world, outs in ranks.items():
        for name, *_ in R.SHARDED_CASES[world]:
            for other in outs[1:]:
                for a, b in zip(outs[0][name], other[name]):
                    np.testing.assert_array_equal(a, b, err_msg=f"{world} ranks, {name}")


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_brute_force_exact(ranks, jax_states, world):
    """301 items over 2 and 4 shards (padding) == JAX's unsharded brute force."""
    ref = jax_states["es"].top_k_fn(jax_states["q"], 20, user_ids=jax_states["feats"].user_ids)
    assert_topk_match(ranks[world][0]["bf"], (ref.scores, ref.ids))


@pytest.mark.parametrize("world,name", [(4, "fused"), (2, "fused_only")])
def test_sharded_fused_matches_single_device(ranks, jax_states, world, name):
    """Per-shard fused scoring, also of a fused_only state, == the unsharded
    brute force."""
    ref = jax_states["es"].top_k_fn(jax_states["q"], 15, user_ids=jax_states["feats"].user_ids)
    assert_topk_match(ranks[world][0][name], (ref.scores, ref.ids))


def test_sharded_int8_tables_match_unsharded_int8(ranks, trained, jax_states):
    from rails_tpu.index.top_k import mol_brute_force_top_k_fused

    ref = mol_brute_force_top_k_fused(trained["model"], trained["params"], jax_states["int8"],
                                      jax_states["q"], 15, user_ids=jax_states["feats"].user_ids)
    assert_topk_match(ranks[2][0]["int8"], (ref.scores, ref.ids))


@pytest.mark.parametrize("name", ["naive_full", "comb_full", "naive301", "avg_full"])
def test_sharded_full_budget_is_exact(ranks, jax_states, name):
    """Naive, Comb and Avg with budgets >= the slab, given as parameters or
    in the method's name (MoLNaiveTopK301 with k_per_group left at 50), ==
    exact."""
    ref = jax_states["es"].top_k_fn(jax_states["q"], 10, user_ids=jax_states["feats"].user_ids)
    assert_topk_match(ranks[4][0][name], (ref.scores, ref.ids))


@pytest.mark.parametrize("world,name", [(4, "naive5"), (4, "avg40"), (4, "comb5_40"),
                                        (4, "cert"), (4, "tile"), (2, "naive5"), (2, "cert"),
                                        (2, "ivf")])
def test_approximate_methods_match_jax_sharded(ranks, trained, jax_states, world, name):
    _, kind, method, k, kw = _case(world, name)
    want = _jax_sharded(trained, jax_states, world, kind, method, k, kw)
    assert_topk_match(ranks[world][0][name], want)


@pytest.mark.parametrize("method", R.NEGATIVE_METHODS)
def test_pad_rows_never_displace_real_items(ranks, negative_corpus, method):
    """37 items pad to 40 over 4 shards; on an all-negative corpus the pad
    rows (id 0, score 0 before masking) must not surface."""
    out = ranks[4][0]
    assert out["negative_slab_rows"] == 10
    q, items = negative_corpus["q"], negative_corpus["items"]
    scores = q @ items.T
    want_i = np.argsort(-scores, axis=1, kind="stable")[:, :5] + 1
    got_s, got_i = out[f"negative_{method}"]
    assert (got_i > 0).all()
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, np.take_along_axis(scores, want_i - 1, axis=1),
                               rtol=1e-5, atol=1e-5)


def test_recall_vs_exact_with_sharded_steps(ranks):
    """A per-shard Avg budget of 400 >= the slab: recall@50 of the sharded
    exact top-1 is 1."""
    assert ranks[4][0]["recall_MoLAvgTopK400"]["recall@50"] == 1.0


def test_sharded_avg_tight_budget_recall_floor(ranks):
    """Per-shard budgets spend 4x the candidates: sharded recall >= the
    single-device method's at the same budget."""
    out = ranks[4][0]
    assert (out["recall_MoLAvgTopK60"]["recall@50"]
            >= out["recall_single_MoLAvgTopK60"]["recall@50"])


def test_sharded_eval_step_matches_jax(ranks, trained):
    """`make_sharded_eval_step` ranks, ids and scores vs JAX's at 4 shards."""
    import jax.numpy as jnp

    from rails_tpu.core.config import MeshConfig
    from rails_tpu.core.mesh import make_mesh
    from rails_tpu.train.evaluation import get_eval_state, make_sharded_eval_step

    t = trained
    es = get_eval_state(t["model"], t["params"], t["ds"].all_item_ids, "MoLBruteForceTopK",
                        table_dtype=jnp.float32)
    seq_len = t["batches"][0].features.ids.shape[1]
    step = make_sharded_eval_step(t["model"], t["params"], es,
                                  make_mesh(MeshConfig(item_parallel=4)), k=20, seq_len=seq_len)
    for b, got in zip(t["batches"][:2], ranks[4][0]["eval_exact"]):
        want_ranks, want_ids, want_scores = (np.asarray(a) for a in
                                             step(t["params"], b.features, b.target_ids))
        assert_topk_match((got[2], got[1]), (want_scores, want_ids))
        same = (got[1] == want_ids).all(axis=1)
        np.testing.assert_array_equal(got[0][same], want_ranks[same])


def test_build_sharded_ivf_matches_jax(port_ivf):
    """From JAX's per-shard centroids: the lists, overflow and their padding
    to the largest shard bit-equal, slab-local positions."""
    got, want = port_ivf
    for field in ("centroids", "buckets", "overflow"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    # Slab-local positions: 301 items pad to 302, 151 a shard.
    assert int(got.buckets.max()) < 151
    assert got.overflow.numel() == 0 or int(got.overflow.max()) < 151


def test_build_fused_state_chunked_keeps_host_tables(trained):
    """JAX's host-staged `build_fused_state_chunked(keep_on_host=True)` at
    chunk 128 vs the slab builds that take its place in the port
    (`build_fused_state_chunked_on_device(span=)` at 2 and 4 shards):
    the slabs side by side hold JAX's tables (bf16), the gating rows in the
    port's n-major order, ids zero-padded; the slabs past the corpus hold
    padding only."""
    import jax
    import jax.numpy as jnp

    from rails_tpu.index.top_k import build_fused_state_chunked
    from rails_tpu_torch.index.sharded import slab_span

    t = trained
    x = 301
    ids = np.arange(1, x + 1, dtype=np.int32)
    want = build_fused_state_chunked(
        t["model"], t["params"], jnp.asarray(ids),
        lambda s, c: t["model"].apply(t["params"], c, method=t["model"].get_item_embeddings),
        chunk_size=128, keep_on_host=True)
    assert isinstance(want.fused_tables.item_comp_t, np.ndarray)
    wft = fused_tables_from_jax(jax.tree_util.tree_map(np.asarray, want.fused_tables))
    xp = int(want.item_ids.shape[0])
    model = R.port_model(t["port_cfg"], t["ds"].max_item_id, t["state_dict"])
    for world in (2, 4):
        with torch.inference_mode():
            slabs = [ptk.build_fused_state_chunked_on_device(
                model, torch.from_numpy(ids), lambda s, c: model.get_item_embeddings(c),
                chunk_size=128, span=slab_span(x, world * 256, world, si))
                for si in range(world)]
        got_ids = torch.cat([s.item_ids for s in slabs])
        np.testing.assert_array_equal(got_ids[:xp].numpy(), np.asarray(want.item_ids))
        assert not got_ids[xp:].any()
        comp = torch.cat([s.fused_tables.item_comp_t for s in slabs], dim=2)
        part = torch.cat([s.fused_tables.item_partial_t for s in slabs], dim=1)
        avg = torch.cat([s.avg_component for s in slabs])
        assert all(s.fused_tables.num_items == x for s in slabs) and wft.num_items == x
        for a, b in ((comp[:, :, :xp], wft.item_comp_t), (part[:, :xp], wft.item_partial_t),
                     (avg[:xp], torch.from_numpy(np.asarray(want.avg_component, np.float32)))):
            assert a.dtype == torch.bfloat16
            # One bf16 step apart at most: the port's f32 item MLPs against JAX's.
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=2 ** -7,
                                       atol=1e-6)
        assert not comp[:, :, xp:].any() and not part[:, xp:].any() and not avg[xp:].any()
        assert all(s.item_tables.component_embeddings.shape[0] == 0 for s in slabs)


@pytest.fixture(scope="module")
def whole_builds(trained):
    """The port's whole chunked build of the slab tests' corpus, bf16 and
    int8, in this process."""
    t = trained
    model = R.port_model(t["port_cfg"], t["ds"].max_item_id, t["state_dict"])
    ids = torch.arange(1, R.SLAB_ITEMS + 1, dtype=torch.int32)
    with torch.inference_mode():
        return {q: ptk.build_fused_state_chunked_on_device(model, ids, R.keyed_embed(model),
                                                           R.SLAB_CHUNK, quantize=q)
                for q in (False, True)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("quantize", [False, True])
def test_shard_state_build_equals_the_whole_build_sliced(ranks, whole_builds, world, quantize):
    """Each rank's `build_shard_state`, which runs only the chunks that meet
    its slab (chunks of 96, slabs of 256), == its slab of the whole build
    bit for bit: ids, kernel-layout tables or int8 codes, the real columns'
    scales, avg rows; zeros past the corpus; num_items the corpus's."""
    from rails_tpu_torch.index.sharded import slab_span

    whole = whole_builds[quantize]
    xp = int(whole.item_ids.shape[0])
    wft = whole.fused_tables

    def cut(t, axis, lo, hi):
        part = t.narrow(axis, min(lo, xp), max(0, min(hi, xp) - lo))
        shape = list(part.shape)
        shape[axis] = hi - lo - part.shape[axis]
        return torch.cat([part, torch.zeros(shape, dtype=t.dtype)], dim=axis)

    for si, out in enumerate(ranks[world]):
        got = out["slab"][quantize]
        lo, hi = slab_span(R.SLAB_ITEMS, world * 256, world, si)
        ft = got.fused_tables
        assert ft.num_items == R.SLAB_ITEMS and got.item_ids.shape[0] == hi - lo
        assert torch.equal(got.item_ids, cut(whole.item_ids, 0, lo, hi))
        assert torch.equal(ft.item_comp_t, cut(wft.item_comp_t, 2, lo, hi))
        assert torch.equal(ft.item_partial_t, cut(wft.item_partial_t, 1, lo, hi))
        assert torch.equal(got.avg_component, cut(whole.avg_component, 0, lo, hi))
        real = got.item_ids != 0
        if quantize:
            assert torch.equal(ft.comp_scale[:, real], cut(wft.comp_scale, 1, lo, hi)[:, real])
            assert torch.equal(ft.partial_scale[:, real],
                               cut(wft.partial_scale, 1, lo, hi)[:, real])
        else:
            assert ft.comp_scale is None


@pytest.mark.parametrize("world", [2, 4])
def test_rank_ivf_equals_the_stacked_build(ranks, whole_builds, world):
    """Each rank's `build_rank_ivf` over its own slab == its index of
    `build_sharded_ivf` over the whole build, bit for bit, padding to the
    largest shard's lists included (at 4 ranks two slabs hold padding
    only)."""
    want = pivf.build_sharded_ivf(whole_builds[False], world, **R.SLAB_IVF)
    for si, out in enumerate(ranks[world]):
        for field in ("centroids", "buckets", "overflow"):
            assert torch.equal(getattr(out["rank_ivf"], field), getattr(want, field)[si]), (
                si, field)


@pytest.mark.parametrize("method,extra", [
    ("MoLBruteForceTopKFused", []),
    ("MoLIVFTopK16", ["--ivf-nlist", "64", "--ivf-iters", "2", "--ivf-recall-floor", "0.5"]),
])
def test_shard_bench_serves_a_corpus_built_by_slabs(tmp_path, method, extra):
    """`cli/shard_bench.py` on 2 gloo ranks over 1,100,000 items, above the
    size where each rank builds only its slab (`build_shard_state`; IVF:
    `build_rank_ivf`): on every rank the merged top-200 passes the CLI's
    check against the streamed exact scan of the whole corpus (exact:
    scores within 5e-2, id overlap above 0.95; IVF: recall@200 at least
    0.5), and rank 0 reports."""
    argv = ["--device", "cpu", "--config", "synthetic-small", "--num-items", "1100000",
            "--batch-size", "4", "--runs", "1", "--method", method,
            "--check-against-chunked"] + extra
    run_ranks(R.shard_bench_rank, 2, (2, str(tmp_path / "store"), str(tmp_path), argv),
              timeout=RANK_TIMEOUT)
    outs = R.load_results(str(tmp_path), 2)
    assert outs[1]["summary"] is None
    got = outs[0]["summary"]
    assert got["item_parallel"] == 2 and got["num_items"] == 1_100_000 and got["ms_per_batch"] > 0


@pytest.mark.parametrize("method", ["naive", "avg", "comb"])
def test_rerank_without_an_item_gating_partial_matches_jax(negative_corpus, method):
    """A state whose similarity has no item gating partial (None) reranks
    in one process as JAX's does: the candidate gather used to index the
    missing table (`top_k._gathered_candidate_tables`)."""
    import jax.numpy as jnp

    from rails_tpu.index import top_k as jtk
    from rails_tpu.similarity.mol import MoLItemTables as JaxTables

    class JaxDot:
        def apply(self, params, *args, method=None, **kw):
            return method(params, *args, **kw)

        def score_precomputed(self, params, q, tables, user_ids=None, item_indices=None):
            return jnp.einsum("bd,xd->bx", q, tables.component_embeddings[:, 0, :])

        def score_gathered(self, params, q, comp, gating_partial, user_ids=None):
            return jnp.einsum("bd,bcd->bc", q, comp[:, :, 0, :])

        def query_components(self, params, q, user_ids=None):
            return q[:, None, :]

    q, items = negative_corpus["q"], negative_corpus["items"]
    x = items.shape[0]
    jstate = jtk.MoLTopKState(item_ids=jnp.arange(1, x + 1, dtype=jnp.int32),
                              item_tables=JaxTables(jnp.asarray(items)[:, None, :], None),
                              avg_component=jnp.asarray(items))
    pstate = ptk.MoLTopKState(item_ids=torch.arange(1, x + 1, dtype=torch.int32),
                              item_tables=MoLItemTables(torch.from_numpy(items)[:, None, :], None),
                              avg_component=torch.from_numpy(items))
    kw = {"naive": dict(k_per_group=6), "avg": dict(avg_top_k=6),
          "comb": dict(k_per_group=3, avg_top_k=3)}[method]
    want = getattr(jtk, f"mol_{method}_top_k")(JaxDot(), {}, jstate, jnp.asarray(q), 5, **kw)
    with torch.inference_mode():
        got = getattr(ptk, f"mol_{method}_top_k")(R.DotModel(), pstate, torch.from_numpy(q), 5,
                                                  **kw)
    assert_topk_match((got.scores, got.ids), (want.scores, want.ids), tol=1e-5)
