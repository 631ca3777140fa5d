"""The port's incremental decode and LM MoL embeddings vs rails_tpu's.

Mirrors `tests/test_incremental_decode.py` and the `TestLMEmbeddings` cases
of `tests/test_checkpoint_and_lm.py`. The decode model is `synthetic-small`
with JAX's random weights loaded through `state_dict_from_jax_params`
(64 users, 200 items, batch 8); the port's prefill and decode run the XLA
block path in plain torch, as JAX's do. Tolerances: the JAX tests' own
(decode against the full forward 2e-4, prefill against encode 1e-5), and
the port against JAX's prefill, decode and LM components within 1e-5
relative and 2e-6 absolute.
"""

import numpy as np
import pytest
import torch

from rails_tpu_torch.compat.from_jax import state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.similarity.lm_embeddings import LMMoLEmbeddingsFn, mask_mixing_weights


def _small(cfg):
    return cfg.replace(
        data=cfg.data.replace(synthetic_num_users=64, synthetic_num_items=200),
        train=cfg.train.replace(local_batch_size=8, num_negatives=8),
    )


def _feats(f):
    from rails_tpu_torch.data.features import SequentialFeatures

    return SequentialFeatures(*(torch.from_numpy(np.array(a)) for a in f))


@pytest.fixture(scope="module")
def setup():
    import jax

    from rails_tpu.core.config import get_experiment_config
    from rails_tpu.data.datasets import get_reco_dataset
    from rails_tpu.train.loop import create_train_state

    cfg = _small(get_experiment_config("synthetic-small"))
    ds = get_reco_dataset(cfg.data)
    batch = next(ds.train_dataset.batches(
        batch_size=8, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    model, state, _, _ = create_train_state(cfg, ds.max_item_id, ds.all_item_ids, batch)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    port_cfg = _small(port_config.get_experiment_config("synthetic-small"))
    port = SequentialRecommender(port_cfg, ds.max_item_id, device="cpu")
    port.load_state_dict(state_dict_from_jax_params(params, port_cfg), strict=True)
    return dict(cfg=cfg, ds=ds, model=model, params=params, batch=batch, port=port.eval())


def _appended(feats, lengths, ids):
    """Features with `ids` (B,) at position `lengths` and lengths + 1."""
    out = feats._replace(ids=feats.ids.clone(), lengths=lengths + 1)
    out.ids[torch.arange(out.ids.shape[0]), lengths.long()] = ids
    return out


@torch.inference_mode()
def test_prefill_matches_encode_and_jax(setup):
    s = setup
    feats = _feats(s["batch"].features)
    got, cache = s["port"].encode_prefill(feats)
    np.testing.assert_allclose(got.numpy(), s["port"].encode(feats).numpy(), rtol=1e-5, atol=1e-6)
    assert len(cache) == s["cfg"].hstu.num_blocks
    want, want_cache = s["model"].apply(s["params"], s["batch"].features,
                                        method=s["model"].encode_prefill)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-6)
    for (k, v), (wk, wv) in zip(cache, want_cache):
        np.testing.assert_allclose(k.numpy(), np.asarray(wk), rtol=1e-5, atol=2e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(wv), rtol=1e-5, atol=2e-6)


@torch.inference_mode()
def test_decode_step_matches_full_forward(setup):
    """prefill(length L) + decode_step(new item) == encode(length L + 1),
    and == JAX's decode step."""
    s = setup
    feats = _feats(s["batch"].features)
    target = torch.from_numpy(np.array(s["batch"].target_ids))
    expected = s["port"].encode(_appended(feats, feats.lengths, target))
    _, cache = s["port"].encode_prefill(feats)
    got, _ = s["port"].decode_step(target, feats, cache)
    np.testing.assert_allclose(got.numpy(), expected.numpy(), rtol=2e-4, atol=2e-4)
    _, jcache = s["model"].apply(s["params"], s["batch"].features, method=s["model"].encode_prefill)
    want, _ = s["model"].apply(s["params"], s["batch"].target_ids, s["batch"].features, jcache,
                               method=s["model"].decode_step)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-6)


@torch.inference_mode()
def test_multi_step_decode(setup):
    """Two successive decode steps == the full forward with two appended
    items."""
    s = setup
    feats = _feats(s["batch"].features)
    target = torch.from_numpy(np.array(s["batch"].target_ids))
    second = (target % s["ds"].max_item_id) + 1
    full = _appended(_appended(feats, feats.lengths, target), feats.lengths + 1, second)
    expected = s["port"].encode(full)
    _, cache = s["port"].encode_prefill(feats)
    _, cache = s["port"].decode_step(target, feats, cache)
    got, _ = s["port"].decode_step(second, feats._replace(lengths=feats.lengths + 1), cache)
    np.testing.assert_allclose(got.numpy(), expected.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("change", [dict(model_type="SASRec"),
                                    dict(input_preprocessor_type="rated")])
def test_decode_refuses_what_jax_refuses(change):
    cfg = port_config.get_experiment_config("synthetic-small").replace(**change)
    model = SequentialRecommender(cfg, 50, device="cpu")
    feats = _feats([np.ones(2, np.int32)] + [np.ones((2, 6), np.int32)] * 3
                   + [np.arange(2, dtype=np.int32)])
    with pytest.raises(NotImplementedError):
        model.encode_prefill(feats)


def test_mask_mixing_weights():
    logits = torch.zeros(2, 4, 3)
    ids = torch.tensor([[1, 2, 0, 0], [1, 1, 1, 1]])
    w = mask_mixing_weights(logits, ids, 4).numpy()
    np.testing.assert_allclose(w[0, :2], 0.5, atol=1e-3)
    np.testing.assert_allclose(w[0, 2:], 0.0, atol=1e-3)
    np.testing.assert_allclose(w[1], 0.25, atol=1e-3)
    np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-5)


def test_first_p_mode():
    mod = LMMoLEmbeddingsFn(input_max_length=8, input_embedding_dim=6, dot_product_groups=3,
                            dot_product_l2_norm=False)
    x = torch.arange(2 * 8 * 6, dtype=torch.float32).reshape(2, 8, 6)
    comps, aux = mod(x)
    np.testing.assert_array_equal(comps.numpy(), x[:, :3, :].numpy())
    assert aux == {}


@pytest.mark.parametrize("version", ["v2", "v4", "first_p"])
def test_lm_embeddings_match_jax(version):
    """The port's components from JAX's weights vs JAX's, on a short (N' <
    input_max_length) sequence with padded ids: the pad path and the masked
    softmax."""
    import jax
    import jax.numpy as jnp

    from rails_tpu.similarity.lm_embeddings import LMMoLEmbeddingsFn as JaxLM

    kw = dict(input_max_length=8, input_embedding_dim=6, dot_product_groups=3,
              apply_mixing_weights_v2=version == "v2", apply_mixing_weights_v4=version == "v4",
              mixing_weights_hidden_dim=16)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 6)).astype(np.float32)
    ids = rng.integers(1, 50, size=(2, 6))
    ids[0, 4:] = 0
    jmod = JaxLM(**kw)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), input_ids=jnp.asarray(ids))
    want, want_aux = jmod.apply(params, jnp.asarray(x), input_ids=jnp.asarray(ids))
    mod = LMMoLEmbeddingsFn(**kw)
    if version != "first_p":
        from rails_tpu_torch.compat.from_jax import _port_names

        mod.load_state_dict(_port_names(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    got, aux = mod(torch.from_numpy(x), input_ids=torch.from_numpy(ids))
    assert aux == {} and want_aux == {}
    assert got.shape == (2, 3, 6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=2e-6)
    if version != "first_p":
        np.testing.assert_allclose(np.linalg.norm(got.detach().numpy(), axis=-1), 1.0, rtol=1e-4)
