"""The port's XLA-path eval encoder (`fused_inference=False`) vs rails_tpu.

Every registry config leaves `HSTUConfig.fused_inference` False, so JAX
encodes through the XLA block path (`rails_tpu/models/hstu.py:524-535`), not
K1. A `synthetic-small` model (2 blocks, D=32) built by
`rails_tpu.train.loop.create_train_state` reaches the port through
`state_dict_from_jax_params`; both encode the same 256 users of the eval set,
in f32 and in bf16 (`main_module_bf16`, where both sides round at every op).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.core.config import get_experiment_config
from rails_tpu.data import datasets as jax_datasets
from rails_tpu.models import hstu as jax_hstu
from rails_tpu.train import evaluation as jax_eval
from rails_tpu.train.loop import create_train_state
from rails_tpu_torch.compat.from_jax import state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.data.features import SequentialFeatures
from rails_tpu_torch.models import hstu as port_hstu
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.train import evaluation as port_eval

ROWS = 256
# bf16: each row of the query within this share of its largest |value|. Both
# sides round to bf16 at every op, in other orders of summation (XLA may also
# keep excess precision across a fusion); measured: max 1.06e-2, median
# 2.1e-3 over the 256 rows.
BF16_ROW_TOL = 2e-2


def _configure(cfg, bf16: bool):
    return cfg.replace(
        data=cfg.data.replace(synthetic_num_users=ROWS),
        train=cfg.train.replace(main_module_bf16=bf16),
    )


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "bf16"])
def encoder_setup(request):
    bf16 = request.param
    cfg = _configure(get_experiment_config("synthetic-small"), bf16)
    port_cfg = _configure(port_config.get_experiment_config("synthetic-small"), bf16)
    assert not cfg.hstu.fused_inference and not port_cfg.hstu.fused_inference
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.eval_dataset.batches(
        batch_size=ROWS, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    model, state, _, _ = create_train_state(cfg, ds.max_item_id, ds.all_item_ids, batch)
    port = SequentialRecommender(port_cfg, ds.max_item_id,
                                 compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                                 device="cpu")
    port.load_state_dict(
        state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, state.params), port_cfg),
        strict=True)
    return bf16, ds, batch, model, state.params, port


def _torch_features(features) -> SequentialFeatures:
    return SequentialFeatures(*(torch.from_numpy(np.array(f)) for f in features))


def _boundary_deltas() -> np.ndarray:
    """|delta| at the bucket boundaries e^(0.301 k) +- 1 inside int32."""
    centres = [np.exp(0.301 * k) for k in range(1, 72)]
    vals = {int(round(c)) + o for c in centres for o in (-1, 0, 1)}
    return np.array(sorted(v for v in vals if 1 <= v < 2**31 - 1), dtype=np.int64)


@pytest.mark.parametrize("num_buckets", [128, 32])
def test_bucketize_time_delta_is_bit_equal(num_buckets):
    deltas = _boundary_deltas()
    deltas = np.concatenate([deltas, -deltas, [0, -1, 2**31 - 1, -(2**31)]]).astype(np.int32)
    got = port_hstu.bucketize_time_delta(torch.from_numpy(deltas), num_buckets)
    want = np.asarray(jax_hstu._bucketize_time_delta(jnp.asarray(deltas), num_buckets))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_matches_jax_without_k1(encoder_setup, monkeypatch):
    bf16, _, batch, model, params, port = encoder_setup

    def no_k1(*args, **kwargs):
        raise AssertionError("fused_inference=False must not run K1")

    monkeypatch.setattr(port_hstu, "fused_hstu_block", no_k1)
    want = np.asarray(model.apply(params, batch.features, method=model.encode), np.float32)
    with torch.inference_mode():
        got = port.encode(_torch_features(batch.features)).float().numpy()
    assert got.shape == want.shape == (ROWS, 32)
    if not bf16:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)
        return
    scale = np.abs(want).max(axis=1, keepdims=True)
    row_err = (np.abs(got - want) / scale).max(axis=1)
    assert row_err.max() <= BF16_ROW_TOL, row_err.max()


def test_fused_inference_runs_k1(encoder_setup, monkeypatch):
    """fused_inference=True dispatches every block to K1's wrapper."""
    *_, batch, _, _, port = encoder_setup
    calls = []
    real = port_hstu.fused_hstu_block

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_hstu, "fused_hstu_block", counting)
    monkeypatch.setattr(port.hstu, "cfg", port.hstu.cfg.replace(fused_inference=True))
    with torch.inference_mode():
        port.encode(_torch_features(batch.features))
    assert len(calls) == port.hstu.cfg.num_blocks


def test_eval_step_ranks_match_jax(encoder_setup):
    """The default-config eval step: identical ranks in f32; in bf16 on at
    least 95% of the rows."""
    bf16, ds, batch, model, params, port = encoder_setup
    method, k = "MoLBruteForceTopKFused", 60
    dt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    es = jax_eval.get_eval_state(model, params, ds.all_item_ids, method, table_dtype=dt[0])
    jstep = jax_eval.make_eval_step_fn(model, method, k=k, num_objects=es.num_objects)
    ranks = np.asarray(jstep(params, es.topk_state, es.item_embeddings, batch.features,
                             batch.target_ids)[0])
    pes = port_eval.get_eval_state(port, ds.all_item_ids, method, table_dtype=dt[1],
                                   device="cpu")
    pstep = port_eval.make_eval_step_fn(port, method, k=k, num_objects=pes.num_objects)
    p_ranks = pstep(pes.topk_state, _torch_features(batch.features),
                    torch.from_numpy(np.array(batch.target_ids)))[0].numpy()
    assert ranks.shape == (ROWS,) and (ranks < 1001).sum() >= 5
    agree = (p_ranks == ranks).mean()
    assert agree >= (0.95 if bf16 else 1.0), agree
