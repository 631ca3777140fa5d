"""The port's SASRec, DotProduct, rated and combined preprocessors,
categorical embedding, MoL combinations, in-batch sampler, BCE losses and the
eval step of every registry config, each against rails_tpu.

Every test feeds the same numpy-seeded inputs to the JAX module and to its
port counterpart, whose weights come from the JAX parameters through
`state_dict_from_jax_params` (strict). The registry configs' eval steps run
at their published widths with one encoder block, a synthetic corpus of
`EVAL_ITEMS` items and a batch of `EVAL_BATCH` users, in the config's dtype
(`model_dtype`). The training steps of the same options are in
`test_torch_port_models_train.py`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.core.config import DataConfig, MoLConfig, SASRecConfig
from rails_tpu.core.config import get_experiment_config as jax_experiment_config
from rails_tpu.data import datasets as jax_datasets
from rails_tpu.losses import samplers as jax_samplers
from rails_tpu.losses.bce import bce_loss as jax_bce_loss
from rails_tpu.losses.bce import bce_loss_with_ratings as jax_bce_ratings
from rails_tpu.models import embedding as jax_embedding
from rails_tpu.models import preprocessors as jax_pre
from rails_tpu.models.encoder import SequentialRecommender as JaxRecommender
from rails_tpu.models.sasrec import SASRecBlock as JaxSASRecBlock
from rails_tpu.similarity.dot_product import DotProductSimilarity as JaxDotProduct
from rails_tpu.similarity.mol import MoLSimilarity as JaxMoL
from rails_tpu.train import evaluation as jax_eval
from rails_tpu.train.loop import model_dtype as jax_model_dtype
from rails_tpu.train.loop import scatter_target as jax_scatter_target
from rails_tpu_torch.compat.from_jax import state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.data.features import SequentialFeatures
from rails_tpu_torch.losses import samplers as port_samplers
from rails_tpu_torch.losses.bce import bce_loss, bce_loss_with_ratings
from rails_tpu_torch.models.embedding import CategoricalEmbeddingModule
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.models.preprocessors import (
    CombinedItemAndRatingInputPreprocessor,
    LearnablePositionalEmbeddingRatedInputPreprocessor,
)
from rails_tpu_torch.models.sasrec import SASRecBlock
from rails_tpu_torch.similarity.dot_product import DotProductSimilarity
from rails_tpu_torch.similarity.mol import MoLSimilarity
from rails_tpu_torch.train import evaluation as port_eval
from rails_tpu_torch.train.loop import model_dtype

EVAL_ITEMS, EVAL_BATCH, EVAL_K = 300, 8, 50
# bf16 forward: max |port - JAX| over max |JAX|. Both sides round to bf16 at
# the same ops and sum in other orders (XLA may keep excess precision across
# a fusion), as tests/test_torch_port_xla_encoder.py's BF16_ROW_TOL.
BF16_TOL = 2e-2
# Eval scores within this share of the row's largest |score|, and ranks
# equal except where the JAX scores of the two rank positions lie that close:
# f32 sums in other orders; bf16 models round every elementwise op to 8 bits,
# at other places than XLA's fusions do (JAX's own bf16 and f32 Books steps
# differ by up to 1.5e-2 of it), the contract of
# tests/test_torch_port_books.py's bf16 eval step.
RANK_SCORE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _state(params, cfg=None) -> dict:
    """Port names of a JAX params tree (`{"params": ...}` with numpy leaves)."""
    cfg = cfg or port_config.get_experiment_config("synthetic-small")
    return state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg)


def _port_features(features) -> SequentialFeatures:
    return SequentialFeatures(*(_t(f) for f in features))


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max()
                 / np.abs(np.asarray(want, np.float32)).max())


# --------------------------------------------------------------------------- #
# SASRec
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_sasrec_block_matches_jax(dtype, activation):
    cfg = SASRecConfig(embedding_dim=32, num_blocks=1, num_heads=2, ffn_hidden_dim=48,
                       ffn_activation_fn=activation, ffn_dropout_rate=0.2)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 9, 32)).astype(np.float32)
    valid = np.arange(9)[None] < np.array([[4], [9], [1]])
    jdt = getattr(jnp, dtype)
    block = JaxSASRecBlock(cfg=cfg, dtype=jdt)
    params = jax.jit(block.init)(jax.random.PRNGKey(1), jnp.asarray(x, jdt), jnp.asarray(valid))
    want = np.asarray(jax.jit(block.apply)(params, jnp.asarray(x, jdt), jnp.asarray(valid)),
                      np.float32)
    port = SASRecBlock(port_config.SASRecConfig(**cfg.to_dict()), getattr(torch, dtype),
                       torch.Generator().manual_seed(0))
    port.load_state_dict(_state(params), strict=True)
    with torch.no_grad():
        got = port(_t(x).to(getattr(torch, dtype)), _t(valid)).float().numpy()
    assert np.all(got[~valid] == 0)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _rel_err(got, want) <= BF16_TOL


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def sasrec_model(request):
    """A synthetic-small SASRec model (2 blocks, D=32) from the JAX package,
    its port and a batch; bf16 as ml-20m-sasrec-mol's `bf16_training`."""
    bf16 = request.param == "bfloat16"
    changes = dict(model_type="SASRec",
                   data=DataConfig(dataset_name="synthetic", max_sequence_length=24,
                                   synthetic_num_users=64, synthetic_num_items=200))
    cfg = jax_experiment_config("synthetic-small").replace(**changes)
    cfg = cfg.replace(mol=cfg.mol.replace(bf16_training=bf16))
    port_cfg = port_config.get_experiment_config("synthetic-small").replace(
        model_type="SASRec", data=port_config.DataConfig(**changes["data"].to_dict()))
    port_cfg = port_cfg.replace(mol=port_cfg.mol.replace(bf16_training=bf16))
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.eval_dataset.batches(batch_size=16,
                                         max_output_length=cfg.train.gr_output_length + 1,
                                         shuffle=False))
    model, params = _jax_model(cfg, ds.max_item_id, batch.features)
    port = SequentialRecommender(port_cfg, ds.max_item_id, compute_dtype=model_dtype(port_cfg),
                                 device="cpu")
    port.load_state_dict(_state(params, port_cfg), strict=True)
    return request.param, model, params, port, batch


def test_sasrec_stack_matches_jax(sasrec_model):
    dtype, model, params, port, batch = sasrec_model
    feats = jax_scatter_target(batch.features, batch.target_ids)
    want = np.asarray(model.apply(params, feats, method=model.encode_sequence), np.float32)
    with torch.no_grad():
        got = port.encode_sequence(_port_features(feats)).numpy()
    assert got.shape == want.shape == (16, 27, 32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    else:
        assert _rel_err(got, want) <= BF16_TOL


def test_sasrec_causality(sasrec_model):
    """JAX's `test_causality`: changing the last valid id moves that
    position's output and no earlier one's, in the port as in JAX."""
    _, model, params, port, batch = sasrec_model
    feats = batch.features
    pos = int(feats.lengths[0]) - 1
    ids2 = feats.ids.at[0, pos].set((int(feats.ids[0, pos]) % 100) + 1)
    outs = []
    for f in (feats, feats._replace(ids=ids2)):
        with torch.no_grad():
            got = port.encode_sequence(_port_features(f)).numpy()
        want = np.asarray(model.apply(params, f, method=model.encode_sequence), np.float32)
        outs.append((got, want))
    (a, ja), (b, jb) = outs
    np.testing.assert_allclose(a[0, :pos], b[0, :pos], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ja[0, :pos], jb[0, :pos], rtol=1e-5, atol=1e-6)
    assert np.abs(a[0, pos] - b[0, pos]).max() > 1e-6
    assert np.abs(ja[0, pos] - jb[0, pos]).max() > 1e-6


# --------------------------------------------------------------------------- #
# DotProduct, preprocessors, categorical embedding
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("case", ["shared", "rowwise", "r_per_row"])
def test_dot_product_cases_match_jax(case):
    rng = np.random.default_rng(1)
    b, x, d = 6, 5, 16
    items = {"shared": (1, x, d), "rowwise": (b, x, d), "r_per_row": (2, x, d)}[case]
    q = rng.standard_normal((b, d)).astype(np.float32)
    i = rng.standard_normal(items).astype(np.float32)
    want, aux = JaxDotProduct().apply({}, jnp.asarray(q), jnp.asarray(i))
    got, port_aux = DotProductSimilarity()(_t(q), _t(i))
    assert aux == {} and port_aux == {} and got.shape == (b, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _pre_inputs(d: int):
    rng = np.random.default_rng(2)
    lengths = np.array([3, 7, 1], np.int32)
    emb = rng.standard_normal((3, 7, d)).astype(np.float32)
    ratings = rng.integers(-2, 9, (3, 7)).astype(np.int32)   # clipped to [0, 5]
    return lengths, emb, ratings


def test_rated_preprocessor_matches_jax():
    lengths, emb, ratings = _pre_inputs(12)
    jm = jax_pre.LearnablePositionalEmbeddingRatedInputPreprocessor(
        max_sequence_len=9, item_embedding_dim=12, rating_embedding_dim=4, num_ratings=6,
        dropout_rate=0.0)
    args = (jnp.asarray(lengths), jnp.asarray(emb), jnp.asarray(ratings))
    params = jm.init(jax.random.PRNGKey(3), *args)
    x, valid = jm.apply(params, *args)
    port = LearnablePositionalEmbeddingRatedInputPreprocessor(
        9, 12, 4, 6, torch.float32, torch.Generator().manual_seed(0))
    port.load_state_dict(_state(params), strict=True)
    gx, gvalid = port(_t(lengths), _t(emb), _t(ratings))
    assert gx.shape == (3, 7, 16)
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(valid))
    np.testing.assert_allclose(gx.detach().numpy(), np.asarray(x), rtol=1e-6, atol=1e-6)


def test_combined_preprocessor_matches_jax():
    lengths, emb, ratings = _pre_inputs(8)
    jm = jax_pre.CombinedItemAndRatingInputPreprocessor(
        max_sequence_len=14, embedding_dim=8, rating_embedding_dim=8, num_ratings=6,
        dropout_rate=0.0)
    args = (jnp.asarray(lengths), jnp.asarray(emb), jnp.asarray(ratings))
    params = jm.init(jax.random.PRNGKey(4), *args)
    x, valid, enc_lengths = jm.apply(params, *args)
    port = CombinedItemAndRatingInputPreprocessor(
        14, 8, 8, 6, torch.float32, torch.Generator().manual_seed(0))
    port.load_state_dict(_state(params), strict=True)
    gx, gvalid, glengths = port(_t(lengths), _t(emb), _t(ratings))
    assert gx.shape == (3, 14, 8)
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(glengths.numpy(), np.asarray(enc_lengths))
    np.testing.assert_allclose(gx.detach().numpy(), np.asarray(x), rtol=1e-6, atol=1e-6)


def test_categorical_lookup_matches_jax():
    remap = np.array([0, 0, 1, 1, 2, 4, 3], np.int32)          # items 1..7
    ids = np.array([[0, 1, 2, 3, 7], [5, 6, 0, 0, 4]], np.int32)
    jm = jax_embedding.CategoricalEmbeddingModule(
        num_categories=5, item_embedding_dim=6, item_id_to_category_id=remap)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(ids))
    params = jax.tree_util.tree_map(lambda a: a + 1.0, params)   # row 0 nonzero too
    want = np.asarray(jm.apply(params, jnp.asarray(ids)))
    for scatter in (False, True):
        port = CategoricalEmbeddingModule(5, 6, remap, torch.Generator().manual_seed(0),
                                          scatter_grad_kernel=scatter)
        port.load_state_dict(_state(params), strict=True)
        got = port(_t(ids))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[0, 0].detach().numpy(), want[1, 3])   # id 0 -> row 0
        got.sum().backward()
        counts = np.bincount(port.category_ids(_t(ids)).numpy().ravel(), minlength=6)
        np.testing.assert_array_equal(port.embedding.grad[:, 0].numpy(), counts)


# --------------------------------------------------------------------------- #
# MoL combinations
# --------------------------------------------------------------------------- #

MOL_CASES = {
    "glu_silu_ln": dict(gating_combination_type="glu_silu_ln"),
    "none": dict(gating_combination_type="none"),
    "none, gating_item_fn=False": dict(gating_combination_type="none", gating_item_fn=False),
    "none, gating_query_fn=False": dict(gating_combination_type="none", gating_query_fn=False),
}


@pytest.mark.parametrize("case", list(MOL_CASES))
def test_mol_combinations_match_jax(case):
    cfg = MoLConfig(query_embedding_dim=24, item_embedding_dim=24, dot_product_dimension=8,
                    query_dot_product_groups=4, item_dot_product_groups=2, query_hidden_dim=32,
                    gating_query_hidden_dim=16, gating_item_hidden_dim=16,
                    gating_qi_hidden_dim=16, softmax_dropout_rate=0.0, item_dropout_rate=0.0,
                    **MOL_CASES[case])
    rng = np.random.default_rng(6)
    q = rng.standard_normal((5, 24)).astype(np.float32)
    items = rng.standard_normal((1, 30, 24)).astype(np.float32)
    jm = JaxMoL(cfg=cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(7), jnp.asarray(q), jnp.asarray(items))

    @jax.jit
    def scores(p):
        tables = jm.apply(p, jnp.asarray(items[0]), method=jm.build_item_tables)
        return (jm.apply(p, jnp.asarray(q), jnp.asarray(items))[0], tables,
                jm.apply(p, jnp.asarray(q), tables, method=jm.score_precomputed))

    want, tables, want_pre = scores(params)
    port = MoLSimilarity(port_config.MoLConfig(**cfg.to_dict()), torch.float32,
                         torch.Generator().manual_seed(0))
    port.load_state_dict(_state(params), strict=True)
    with torch.no_grad():
        got = port(_t(q), _t(items))[0].numpy()
        pt = port.build_item_tables(_t(items[0]))
        got_pre = port.score_precomputed(_t(q), pt).numpy()
    assert (pt.gating_partial is None) == (tables.gating_partial is None)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_pre, np.asarray(want_pre), rtol=1e-5, atol=1e-5)


def test_glu_silu_requires_both_gating_partials():
    cfg = port_config.MoLConfig(gating_item_fn=False)
    with pytest.raises(ValueError, match="gating_item_fn"):
        MoLSimilarity(cfg, torch.float32, torch.Generator())


# --------------------------------------------------------------------------- #
# In-batch sampler
# --------------------------------------------------------------------------- #

def _in_batch_inputs(num_ids: int = 12):
    rng = np.random.default_rng(8)
    ids = rng.integers(0, num_ids, 40).astype(np.int32)         # repeats and padding
    emb = rng.standard_normal((40, 6)).astype(np.float32)
    emb[ids == 0] = 0.0
    return ids, ids != 0, emb


@pytest.mark.parametrize("num_ids", [12, 4000])     # many repeats; almost none
@pytest.mark.parametrize("l2_norm", [False, True])
def test_in_batch_process_batch_is_bit_equal(num_ids, l2_norm):
    ids, pres, emb = _in_batch_inputs(num_ids)
    want = jax_samplers.InBatchNegativesSampler(l2_norm, 1e-6).process_batch(
        jnp.asarray(ids), jnp.asarray(pres), jnp.asarray(emb))
    got = port_samplers.InBatchNegativesSampler(l2_norm, 1e-6).process_batch(
        _t(ids), _t(pres), _t(emb))
    for field in ("sorted_ids", "cum_unique", "num_unique"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    emb, want_emb = got.sorted_embeddings.numpy(), np.asarray(want.sorted_embeddings)
    if l2_norm:
        # The l2 norm sums its squares in another order than XLA.
        np.testing.assert_allclose(emb, want_emb, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(emb, want_emb)


def test_in_batch_draw_is_bit_equal():
    ids, pres, emb = _in_batch_inputs()
    sampler = jax_samplers.InBatchNegativesSampler()
    state = sampler.process_batch(jnp.asarray(ids), jnp.asarray(pres), jnp.asarray(emb))
    key = jax.random.PRNGKey(9)
    want_ids, want_emb = sampler.sample(state, key, (50, 7))
    u = np.asarray(jax.random.uniform(key, (50, 7)))
    port_state = port_samplers.InBatchNegativesSampler().process_batch(
        _t(ids), _t(pres), _t(emb))
    got_ids, got_emb = port_samplers.InBatchNegativesSampler.sample_from_uniforms(
        port_state, _t(u))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_emb.numpy(), np.asarray(want_emb))
    assert set(np.unique(got_ids.numpy())) <= set(ids[ids != 0])
    # The generator draw covers the unique pool.
    drawn, _ = port_samplers.InBatchNegativesSampler().sample(
        port_state, torch.Generator().manual_seed(0), (4000,))
    assert set(np.unique(drawn.numpy())) == set(ids[ids != 0])


# --------------------------------------------------------------------------- #
# BCE losses
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def small_model():
    """A synthetic-small HSTU-MoL model with every dropout off, its port and
    a target-scattered batch."""
    cfg = jax_experiment_config("synthetic-small")
    cfg = _no_dropout(cfg).replace(
        data=DataConfig(dataset_name="synthetic", max_sequence_length=16,
                        synthetic_num_users=32, synthetic_num_items=100))
    port_cfg = _no_dropout(port_config.get_experiment_config("synthetic-small")).replace(
        data=port_config.DataConfig(**cfg.data.to_dict()))
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.train_dataset.batches(
        batch_size=8, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    model, params = _jax_model(cfg, ds.max_item_id, batch.features)
    port = SequentialRecommender(port_cfg, ds.max_item_id, device="cpu")
    port.load_state_dict(_state(params, port_cfg), strict=True)
    feats = jax_scatter_target(batch.features, batch.target_ids)
    return model, params, port, feats, ds


def _no_dropout(cfg):
    return cfg.replace(
        train=cfg.train.replace(dropout_rate=0.0),
        hstu=cfg.hstu.replace(linear_dropout_rate=0.0),
        mol=cfg.mol.replace(query_dropout_rate=0.0, uid_dropout_rate=0.0,
                            item_dropout_rate=0.0, softmax_dropout_rate=0.0,
                            gating_qi_dropout_rate=0.0, gating_item_dropout_rate=0.0))


@pytest.mark.parametrize("with_ratings", [False, True], ids=["bce", "bce_with_ratings"])
def test_bce_losses_match_jax(small_model, with_ratings, monkeypatch):
    model, params, port, feats, ds = small_model
    b, n = feats.ids.shape
    negatives = np.random.default_rng(10).choice(ds.all_item_ids, (b * (n - 1), 1)).astype(
        np.int32)
    monkeypatch.setattr(jax_samplers.LocalNegativesSampler, "sample",
                        lambda self, rng, shape: jnp.asarray(negatives))
    monkeypatch.setattr(port_samplers.LocalNegativesSampler, "sample",
                        lambda self, generator, shape: _t(negatives))
    all_ids = np.asarray(ds.all_item_ids, np.int32)
    jsampler = jax_samplers.LocalNegativesSampler(jnp.asarray(all_ids))
    psampler = port_samplers.LocalNegativesSampler(_t(all_ids))
    jfn, pfn = (jax_bce_ratings, bce_loss_with_ratings) if with_ratings else (jax_bce_loss,
                                                                                bce_loss)
    want, want_aux = jax.jit(lambda p: model.apply(
        p, feats, jsampler, 0.5, True, method=jfn,
        rngs={"sampler": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}))(params)
    with torch.no_grad():
        got, got_aux = pfn(port, _port_features(feats), psampler, 0.5, True,
                           torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert set(got_aux) == set(want_aux)
    for key in want_aux:
        np.testing.assert_allclose(got_aux[key].item(), float(want_aux[key]), rtol=1e-5)


# --------------------------------------------------------------------------- #
# Every registry config's eval step
# --------------------------------------------------------------------------- #

def _jax_model(cfg, num_items: int, features):
    """A JAX `SequentialRecommender` and its parameters, initialised through
    `encode` and `similarity_fn` (every parameter of the model, without
    tracing a training loss)."""
    model = JaxRecommender(cfg=cfg, num_items=num_items, dtype=jax_model_dtype(cfg))

    def init_all(m, feats):
        q = m.encode(feats)
        items = m.get_item_embeddings(feats.ids[:, :4])
        return m.similarity_fn(q, items, user_ids=feats.user_ids)

    return model, jax.jit(lambda key: model.init(key, features, method=init_all))(
        jax.random.PRNGKey(0))


def _reduced(cfg, data_cls):
    """One encoder block and a synthetic corpus; every width as published."""
    return cfg.replace(
        hstu=cfg.hstu.replace(num_blocks=1), sasrec=cfg.sasrec.replace(num_blocks=1),
        data=data_cls(dataset_name="synthetic",
                      max_sequence_length=cfg.data.max_sequence_length,
                      synthetic_num_users=2 * EVAL_BATCH, synthetic_num_items=EVAL_ITEMS))


def _assert_ranks_match(got, want, rel: float):
    """Scores within `rel` of each row's largest |score|, and equal ranks
    except where the JAX scores at the two rank positions tie that closely (a
    near-tie that the two sides' rounding may order either way)."""
    ranks, _, p_scores = (a.float().numpy() for a in got)
    j_ranks, j_ids, j_scores = (np.asarray(a, np.float32) for a in want)
    tol = rel * np.abs(j_scores).max(axis=1)
    assert (np.abs(p_scores - j_scores).max(axis=1) <= tol).all()
    for row in np.nonzero(ranks != j_ranks)[0]:
        a, b = sorted((ranks[row], j_ranks[row]))
        assert b <= j_ids.shape[1], (row, ranks[row], j_ranks[row])
        assert j_scores[row, int(a) - 1] - j_scores[row, int(b) - 1] <= tol[row], (row, a, b)
    assert (ranks == j_ranks).mean() >= 0.75


@pytest.mark.parametrize("name", port_config.list_experiment_configs())
def test_registry_config_eval_step_matches_jax(name):
    """Each registry config builds, loads a rails_tpu model's weights
    strictly and serves its `top_k_method` (MIPS over l2-normalised items for
    the `*-dot` configs) with JAX's eval-step ranks."""
    cfg = _reduced(jax_experiment_config(name), DataConfig)
    port_cfg = _reduced(port_config.get_experiment_config(name), port_config.DataConfig)
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.eval_dataset.batches(batch_size=EVAL_BATCH,
                                         max_output_length=cfg.train.gr_output_length + 1,
                                         shuffle=False))
    model, params = _jax_model(cfg, ds.max_item_id, batch.features)
    port = SequentialRecommender(port_cfg, ds.max_item_id, compute_dtype=model_dtype(port_cfg),
                                 device="cpu")
    port.load_state_dict(_state(params, port_cfg), strict=True)
    t, method = cfg.train, cfg.train.top_k_method
    assert method == ("MIPSBruteForceTopK" if cfg.similarity_type == "DotProduct"
                      else "MoLBruteForceTopK")
    es = jax_eval.get_eval_state(model, params, ds.all_item_ids, method,
                                 item_l2_norm=t.item_l2_norm, l2_norm_eps=t.l2_norm_eps)
    jstep = jax_eval.make_eval_step_fn(model, method, k=EVAL_K, num_objects=es.num_objects)
    # Targets at ranks 1..EVAL_BATCH of the JAX step, so every rank is a hit.
    first = jstep(params, es.topk_state, es.item_embeddings, batch.features, batch.target_ids)
    targets = np.asarray(first[1])[np.arange(EVAL_BATCH), np.arange(EVAL_BATCH)]
    want = jstep(params, es.topk_state, es.item_embeddings, batch.features, targets)
    pes = port_eval.get_eval_state(port, ds.all_item_ids, method, device="cpu",
                                   item_l2_norm=t.item_l2_norm, l2_norm_eps=t.l2_norm_eps)
    if t.item_l2_norm:
        np.testing.assert_allclose(pes.item_embeddings.norm(dim=1)[1:].numpy(), 1.0, rtol=1e-5)
    pstep = port_eval.make_eval_step_fn(port, method, k=EVAL_K, num_objects=pes.num_objects)
    got = pstep(pes.topk_state, _port_features(batch.features), _t(targets),
                pes.item_embeddings)
    _assert_ranks_match(got, want, RANK_SCORE_TOL[str(model_dtype(port_cfg))[6:]])


def test_dot_product_model_refuses_mol_methods():
    cfg = port_config.get_experiment_config("ml-1m-hstu-dot")
    port = SequentialRecommender(cfg, 20, device="cpu")
    with pytest.raises(TypeError, match="MIPSBruteForceTopK"):
        port_eval.get_eval_state(port, np.arange(1, 21), "MoLBruteForceTopK", device="cpu")


def test_max_num_invalid_matches_jax(small_model):
    """`max_num_invalid` caps the seen ids that k' makes room for: with a cap
    below N, k' shrinks and both steps return the same ranks."""
    model, params, port, feats, ds = small_model
    method, k = "MoLBruteForceTopK", 20
    es = jax_eval.get_eval_state(model, params, ds.all_item_ids, method)
    pes = port_eval.get_eval_state(port, ds.all_item_ids, method, device="cpu")
    for cap in (None, 4):
        jstep = jax_eval.make_eval_step_fn(model, method, k=k, num_objects=es.num_objects,
                                           max_num_invalid=cap)
        want = jstep(params, es.topk_state, es.item_embeddings, feats, feats.ids[:, 0])
        pstep = port_eval.make_eval_step_fn(port, method, k=k, num_objects=pes.num_objects,
                                            max_num_invalid=cap)
        got = pstep(pes.topk_state, _port_features(feats), _t(feats.ids[:, 0]))
        _assert_ranks_match(got, want, RANK_SCORE_TOL["float32"])
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
