"""rails_tpu_torch exact retrieval at scale vs rails_tpu: `hierarchical_top_k`
and `chunked_top_k`, the fused path's blockmax select, the chunked on-device
corpus build and the streamed exact oracle.

The select cases are `tests/test_index.py:718-853` on numpy-seeded scores.
The others use a `synthetic-small` model over 1,200 items (weights through
`state_dict_from_jax_params`); the JAX package's Pallas kernels run in
interpret mode, the port's wrappers their plain versions. Tolerances: the
select returns the plain top-k's values exactly and its ids wherever the
values are distinct; scores of the two packages to 1e-4 and ids wherever a
score stands 1e-5 apart from both neighbours (ties may order differently).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.core.config import get_experiment_config
from rails_tpu.data import datasets as jax_datasets
from rails_tpu.index import oracle as joracle
from rails_tpu.index import top_k as jtk
from rails_tpu.train.loop import create_train_state
from rails_tpu_torch.compat.from_jax import fused_tables_from_jax, state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.index import oracle as poracle
from rails_tpu_torch.index import top_k as ptk
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.ops.mol_scoring import quantize_fused_tables

NUM_ITEMS = 1200
K = 20


def _select_case(name):
    """(scores (B, X) f32, k, hierarchical kwargs, distinct values?) of the
    JAX package's hierarchical select tests."""
    rng = np.random.default_rng(len(name))
    if name.startswith("random"):
        k, tile = {"random_k1": (1, 256), "random_k13": (13, 256), "random_k200": (200, 256),
                   "random_tile64": (200, 64)}[name]
        return rng.standard_normal((8, 40_000)).astype(np.float32), k, dict(tile=tile), True
    if name == "one_hot_tile":       # every top-k item inside one tile
        s = rng.standard_normal((4, 10_000)).astype(np.float32)
        s[:, 3000:3200] += 100.0
        return s, 150, {}, True
    if name.startswith("ties"):      # tie plateaus spanning tiles
        s = (np.round(rng.standard_normal((8, 20_000)) * 2) / 2).astype(np.float32)
        return s, {"ties_k7": 7, "ties_k200": 200}[name], {}, False
    if name == "uneven_tail_pads":   # X not a multiple of the tile, pad rows at NEG_PAD
        s = rng.standard_normal((4, 9_991)).astype(np.float32)
        s[:, 9_800:] = ptk.NEG_PAD
        return s, 64, {}, True
    if name == "few_tiles":          # k > X / tile: the fall-through
        return rng.standard_normal((4, 2_000)).astype(np.float32), 500, {}, True
    if name == "precomputed_tile_max":
        s = rng.normal(size=(4, 4096)).astype(np.float32)
        return s, 7, dict(tile_max=s.reshape(4, -1, 256).max(axis=2)), True
    # Two tiles' maxima inflated far above the truth; extra_tiles restores exactness.
    s = rng.normal(size=(3, 8192)).astype(np.float32)
    tm = s.reshape(3, -1, 256).max(axis=2)
    tm[:, 3] += 100.0
    tm[:, 17] += 50.0
    return s, 9, dict(tile_max=tm, extra_tiles=2), True


SELECT_CASES = ["random_k1", "random_k13", "random_k200", "random_tile64", "one_hot_tile",
                "ties_k7", "ties_k200", "uneven_tail_pads", "few_tiles", "precomputed_tile_max",
                "inflated_extra_tiles"]


@pytest.mark.parametrize("name", SELECT_CASES)
def test_hierarchical_top_k_matches_jax(name):
    s, k, kw, distinct = _select_case(name)
    want_v, want_i = (np.asarray(a) for a in jax.lax.top_k(jnp.asarray(s), k))
    jv, ji = (np.asarray(a) for a in jtk.hierarchical_top_k(
        jnp.asarray(s), k, **{key: jnp.asarray(v) if key == "tile_max" else v
                              for key, v in kw.items()}))
    pv, pi = ptk.hierarchical_top_k(torch.from_numpy(s), k, **{
        key: torch.from_numpy(v) if key == "tile_max" else v for key, v in kw.items()})
    pv, pi = pv.numpy(), pi.numpy()
    for v in (pv, jv):
        np.testing.assert_array_equal(v, want_v)
    assert (pi < s.shape[1]).all()
    np.testing.assert_array_equal(np.take_along_axis(s, pi, axis=1), pv)
    if distinct:
        np.testing.assert_array_equal(pi, want_i)
        np.testing.assert_array_equal(pi, ji)


def test_chunked_top_k_dispatches_above_the_chunk_width():
    """`chunked_top_k` is `torch.topk` up to `_CHUNK_MAX_X` columns and the
    hierarchy above it (`test_index.py:813-822`): the plain top-k's values
    and, with distinct scores, its ids."""
    rng = np.random.default_rng(16)
    x = ptk._CHUNK_MAX_X + 4_096
    s = rng.standard_normal((2, x)).astype(np.float32)
    want_v, want_i = (np.asarray(a) for a in jax.lax.top_k(jnp.asarray(s), 50))
    got_v, got_i = ptk.chunked_top_k(torch.from_numpy(s), 50)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    small = torch.from_numpy(s[:, :50])
    v, i = ptk.chunked_top_k(small, 30)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(s[:, :50]), 30)[0]))
    assert i.shape == (2, 30)


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
    q = model.apply(params, batch.features, method=model.encode)
    return dict(model=model, params=params, port=port, ids=all_ids, q=q,
                uids=batch.features.user_ids, tq=torch.from_numpy(np.array(q)),
                tuids=torch.from_numpy(np.array(batch.features.user_ids)))


def assert_same_result(got_scores, got_ids, want_scores, want_ids):
    """Scores to 1e-4; ids wherever a score stands 1e-5 apart from both neighbours."""
    want_scores, want_ids = np.asarray(want_scores), np.asarray(want_ids)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-4, atol=1e-4)
    gap = np.abs(np.diff(want_scores, axis=1)) > 1e-5
    isolated = np.ones_like(want_scores, dtype=bool)
    isolated[:, 1:] &= gap
    isolated[:, :-1] &= gap
    assert isolated.mean() > 0.8
    np.testing.assert_array_equal(got_ids[isolated], want_ids[isolated])


def test_blockmax_path_matches_plain_fused_path(setup, monkeypatch):
    """`test_index.py:855-889`: with `_CHUNK_MAX_X` at 64 the fused path runs
    K2's blockmax and the hierarchical select; with ids 5 and 77 poisoned to
    the padding id it returns the plain fused path's result, no id 0, and the
    JAX package's blockmax result."""
    s = setup
    with torch.inference_mode():
        t_ids = torch.from_numpy(s["ids"])
        state = ptk.build_mol_topk_state(s["port"], t_ids, s["port"].get_item_embeddings(t_ids),
                                         table_dtype=torch.float32, build_fused=True)
    ids = state.item_ids.clone()
    ids[[5, 77]] = 0
    poisoned = state._replace(item_ids=ids)
    with torch.inference_mode():
        ref = ptk.mol_brute_force_top_k_fused(s["port"], poisoned, s["tq"], 7, s["tuids"])
        monkeypatch.setattr(ptk, "_CHUNK_MAX_X", 64)
        select, seen = ptk.hierarchical_top_k, []

        def spy(*args, **kw):
            seen.append(tuple(kw["tile_max"].shape))
            return select(*args, **kw)

        monkeypatch.setattr(ptk, "hierarchical_top_k", spy)
        got = ptk.mol_brute_force_top_k_fused(s["port"], poisoned, s["tq"], 7, s["tuids"])
    assert seen == [(16, 5)]
    np.testing.assert_allclose(got.scores.numpy(), ref.scores.numpy(), rtol=1e-5, atol=1e-5)
    assert (got.ids.numpy() >= 1).all()
    jmodel, params = s["model"], s["params"]
    emb = jmodel.apply(params, jnp.asarray(s["ids"]), method=jmodel.get_item_embeddings)
    jstate = jtk.build_mol_topk_state(jmodel, params, jnp.asarray(s["ids"]), emb,
                                      table_dtype=jnp.float32, build_fused=True)
    jstate = jstate._replace(item_ids=jstate.item_ids.at[jnp.asarray([5, 77])].set(0))
    monkeypatch.setattr(jtk, "_CHUNK_MAX_X", 64)
    want = jtk.mol_brute_force_top_k_fused(jmodel, params, jstate, s["q"], 7, user_ids=s["uids"])
    assert_same_result(got.scores.numpy(), got.ids.numpy(), want.scores, want.ids)


def _embed_fns(s):
    port, jmodel, params = s["port"], s["model"], s["params"]
    return (lambda start, ids: port.get_item_embeddings(ids),
            lambda start, ids: jmodel.apply(params, ids, method=jmodel.get_item_embeddings))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_chunked_builder_matches_one_shot_builder(setup, dtype):
    """Chunks of 77 items: the one-shot builder's fused tables (zero-padded
    to 1,280 columns), avg table and ids, ids zero-padded past X."""
    s = setup
    t_ids = torch.from_numpy(s["ids"])
    port_embed, _ = _embed_fns(s)
    with torch.inference_mode():
        one = ptk.build_mol_topk_state(s["port"], t_ids, s["port"].get_item_embeddings(t_ids),
                                       table_dtype=dtype, build_fused=True, fused_only=True)
    chunked = ptk.build_fused_state_chunked_on_device(s["port"], t_ids, port_embed,
                                                      chunk_size=77, table_dtype=dtype)
    ft, ft1 = chunked.fused_tables, one.fused_tables
    assert ft.num_items == NUM_ITEMS and ft.item_comp_t.shape == (2, 16, 1280)
    assert ft.comp_scale is None and chunked.item_tables.component_embeddings.shape[0] == 0
    for a, b in ((ft.item_comp_t, ft1.item_comp_t), (ft.item_partial_t, ft1.item_partial_t),
                 (chunked.avg_component[:NUM_ITEMS], one.avg_component)):
        assert a.dtype == b.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-6, atol=1e-6)
    assert not chunked.avg_component[NUM_ITEMS:].any()
    np.testing.assert_array_equal(chunked.item_ids[:NUM_ITEMS].numpy(), s["ids"])
    assert not chunked.item_ids[NUM_ITEMS:].any()


def test_chunked_builder_quantizes_as_after_the_build(setup):
    """quantize=True gives the bytes of quantizing the bf16 build afterwards
    (scales are per item, so chunking changes none), pad columns the scale
    1e-12 / 127; the JAX in-build int8 tables agree to rtol 1e-6 in the
    scales and one step in the codes (`test_index.py:672-714`)."""
    s = setup
    t_ids = torch.from_numpy(s["ids"])
    port_embed, jax_embed = _embed_fns(s)
    kw = dict(chunk_size=77, table_dtype=torch.bfloat16)
    post = quantize_fused_tables(ptk.build_fused_state_chunked_on_device(
        s["port"], t_ids, port_embed, **kw).fused_tables)
    inb = ptk.build_fused_state_chunked_on_device(s["port"], t_ids, port_embed, quantize=True,
                                                  **kw)
    ft = inb.fused_tables
    assert ft.item_comp_t.dtype == ft.item_partial_t.dtype == torch.int8
    assert inb.avg_component.dtype == torch.bfloat16
    for a, b in zip(post, ft):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert bool((ft.comp_scale[:, NUM_ITEMS:] == post.comp_scale[:, -1:]).all())
    jft = jax.tree_util.tree_map(np.asarray, jtk.build_fused_state_chunked_on_device(
        s["model"], s["params"], jnp.asarray(s["ids"]), jax_embed, chunk_size=77,
        table_dtype=jnp.bfloat16, quantize=True).fused_tables)
    want = fused_tables_from_jax(jft)
    for a, b in ((ft.comp_scale, want.comp_scale), (ft.partial_scale, want.partial_scale)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=0)
    for a, b in ((ft.item_comp_t, want.item_comp_t), (ft.item_partial_t, want.item_partial_t)):
        d = (a.int() - b.int()).abs()
        assert d.max().item() <= 1 and d.float().mean().item() < 1e-2


def test_streamed_oracle_matches_jax_and_brute_force(setup):
    """The oracle over a chunked build (chunks of 77, regenerated tables) and
    over a standard state: the JAX oracle's top-k, and the plain brute force
    over the same bf16 tables."""
    s = setup
    t_ids = torch.from_numpy(s["ids"])
    port_embed, jax_embed = _embed_fns(s)
    chunked = ptk.build_fused_state_chunked_on_device(s["port"], t_ids, port_embed,
                                                      chunk_size=77)
    with torch.inference_mode():
        std = ptk.build_mol_topk_state(s["port"], t_ids, s["port"].get_item_embeddings(t_ids),
                                       table_dtype=torch.bfloat16)
        exact = ptk.mol_brute_force_top_k(s["port"], std, s["tq"], K, s["tuids"])
    got_s, got_i = poracle.streamed_exact_top_k(s["port"], chunked, s["tq"], s["tuids"], K,
                                                embed_chunk_fn=port_embed, chunk=77)
    assert got_s.shape == got_i.shape == (16, K)
    assert (np.diff(got_s, axis=1) <= 0).all()
    assert_same_result(got_s, got_i, exact.scores.numpy(), exact.ids.numpy())
    std_s, std_i = poracle.streamed_exact_top_k(s["port"], std, s["tq"], s["tuids"], K, chunk=500)
    assert_same_result(std_s, std_i, exact.scores.numpy(), exact.ids.numpy())
    jmodel, params = s["model"], s["params"]
    jchunked = jtk.build_fused_state_chunked_on_device(
        jmodel, params, jnp.asarray(s["ids"]), jax_embed, chunk_size=77)
    want_s, want_i = joracle.streamed_exact_top_k(jmodel, params, jchunked, s["q"], s["uids"], K,
                                                  embed_chunk_fn=jax_embed, chunk=77)
    assert_same_result(got_s, got_i, want_s, want_i)


CHUNKED_METHODS = ["MoLBruteForceTopKFused", "MoLBruteForceTopKFusedApprox", "MoLCertTopK600",
                   "MoLTileTopK1", "MoLTileTopK2B2", "MoLNaiveTopK8", "MoLAvgTopK100",
                   "MoLCombTopK8_100"]


@pytest.mark.parametrize("method", CHUNKED_METHODS)
def test_methods_take_a_chunked_state_with_padded_ids(setup, method, monkeypatch):
    """The chunked builder pads item_ids to 1,280 with the padding id; every
    method on that state returns the one-shot fused_only state's result, and
    the exact fused path does so through the blockmax select too."""
    from rails_tpu_torch.index.factory import get_top_k_raw

    s = setup
    t_ids = torch.from_numpy(s["ids"])
    with torch.inference_mode():
        one = ptk.build_mol_topk_state(s["port"], t_ids, s["port"].get_item_embeddings(t_ids),
                                       table_dtype=torch.float32, build_fused=True,
                                       fused_only=True)
    chunked = ptk.build_fused_state_chunked_on_device(
        s["port"], t_ids, _embed_fns(s)[0], chunk_size=500, table_dtype=torch.float32)
    assert chunked.item_ids.shape[0] == 1280 and one.item_ids.shape[0] == NUM_ITEMS
    raw = get_top_k_raw(method)
    with torch.inference_mode():
        want = raw(s["port"], one, s["tq"], K, s["tuids"])
        got = raw(s["port"], chunked, s["tq"], K, s["tuids"])
        assert (got.ids > 0).all()
        assert_same_result(got.scores.numpy(), got.ids.numpy(), want.scores, want.ids)
        if method == "MoLBruteForceTopKFused":
            monkeypatch.setattr(ptk, "_CHUNK_MAX_X", 64)
            got = raw(s["port"], chunked, s["tq"], K, s["tuids"])
            assert_same_result(got.scores.numpy(), got.ids.numpy(), want.scores, want.ids)
