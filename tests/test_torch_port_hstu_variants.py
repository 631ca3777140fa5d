"""K1's block variants in the port vs rails_tpu.

A `synthetic-small` model (2 blocks, D=32, h=2, dqk=dv=16, batch 8, N=35)
with one of the variant flags of `tests/test_pallas_hstu.py:128-135`
(concat_ua, softmax_rel_bias, linear_activation none, concat_ua + softmax),
without the relative-attention bias, or fed non-int32 timestamps, is built
by `rails_tpu.train.loop.create_train_state` and carried into the port by
`state_dict_from_jax_params`. The port's `encode_sequence` through the XLA
block path (`fused_inference=False`) is held to JAX's XLA path, and through
K1 (`fused_inference=True`; its plain version on CPU tensors) to JAX's fused
path (the Pallas kernel in interpret mode). JAX without x64 has no int64, so
its side of the int64 case gets the same timestamps as float32 (exact below
2^24), which takes the same non-int32 branch: a precomputed bias, with the
mask penalty folded in unless softmax. K1's plain version alone is held to
`fused_hstu_block(..., interpret=True)` for every bias, activation, softmax
and concat_ua case; the eval step and three training steps to JAX's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.core.config import get_experiment_config
from rails_tpu.data import datasets as jax_datasets
from rails_tpu.models.encoder import SequentialRecommender as JaxRecommender
from rails_tpu.ops.pallas.hstu_block import fused_hstu_block as jax_fused_hstu_block
from rails_tpu.train import evaluation as jax_eval
from rails_tpu.train import loop as jax_loop
from rails_tpu_torch.compat.from_jax import state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.data.features import SequentialFeatures
from rails_tpu_torch.models import hstu as port_hstu
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.ops import hstu_block
from rails_tpu_torch.train import evaluation as port_eval
from tests.test_torch_port_train_step import (
    NO_DROPOUT,
    _configure,
    _fix_negatives,
    _port_batch,
    _port_state,
)

# f32: JAX's own tolerance between its fused and XLA encoders
# (`tests/test_pallas_hstu.py:158-160`).
F32_TOL = dict(rtol=2e-4, atol=2e-5)
# bf16: each row of the sequence output within this share of its largest
# |value|, the bf16 encoder tolerance of `test_torch_port_xla_encoder.py`:
# both sides round to bf16 at the same points, in other orders of summation.
BF16_ROW_TOL = 2e-2

VARIANTS = {
    "concat_ua": dict(hstu=dict(concat_ua=True)),
    "softmax": dict(hstu=dict(normalization="softmax_rel_bias")),
    "act_none": dict(hstu=dict(linear_activation="none")),
    "concat_ua+softmax": dict(hstu=dict(concat_ua=True, normalization="softmax_rel_bias")),
    "no_bias": dict(hstu=dict(enable_relative_attention_bias=False)),
    "int64_ts": dict(),
    "int64_ts+softmax": dict(hstu=dict(normalization="softmax_rel_bias")),
}
BF16_VARIANTS = ("concat_ua+softmax", "act_none", "int64_ts")
SMALL = dict(train=dict(local_batch_size=8, num_negatives=8),
             data=dict(synthetic_num_users=64, synthetic_num_items=150))


def _merge(*changes):
    out = {}
    for ch in changes:
        for k, v in ch.items():
            out[k] = dict(out.get(k, {}), **v)
    return out


def _torch_features(features, int64: bool) -> SequentialFeatures:
    feats = SequentialFeatures(*(torch.from_numpy(np.array(f)) for f in features))
    return feats._replace(timestamps=feats.timestamps.long()) if int64 else feats


@pytest.fixture(scope="module", params=[(v, False) for v in VARIANTS]
                + [(v, True) for v in BF16_VARIANTS],
                ids=[v for v in VARIANTS] + [f"{v}-bf16" for v in BF16_VARIANTS])
def variant_setup(request):
    name, bf16 = request.param
    changes = _merge(SMALL, VARIANTS[name], dict(train=dict(main_module_bf16=bf16)))
    cfg = _configure(get_experiment_config("synthetic-small"), changes)
    port_cfg = _configure(port_config.get_experiment_config("synthetic-small"), changes)
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.train_dataset.batches(
        batch_size=8, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    _, state, _, _ = jax_loop.create_train_state(cfg, ds.max_item_id, ds.all_item_ids, batch)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    int64 = name.startswith("int64")
    features = batch.features
    if int64:
        assert int(np.abs(np.asarray(features.timestamps)).max()) < 2**24
        features = features._replace(timestamps=features.timestamps.astype(jnp.float32))
    return dict(name=name, bf16=bf16, cfg=cfg, port_cfg=port_cfg, ds=ds, params=params,
                batch=batch, jax_features=features,
                port_features=_torch_features(batch.features, int64))


def _jax_encode(s, fused: bool) -> np.ndarray:
    cfg = s["cfg"].replace(hstu=s["cfg"].hstu.replace(fused_inference=fused))
    model = JaxRecommender(cfg=cfg, num_items=s["ds"].max_item_id)
    return np.asarray(model.apply(s["params"], s["jax_features"], method=model.encode_sequence),
                      np.float32)


def _port_encode(s, fused: bool) -> np.ndarray:
    cfg = s["port_cfg"].replace(hstu=s["port_cfg"].hstu.replace(fused_inference=fused))
    port = SequentialRecommender(cfg, s["ds"].max_item_id,
                                 compute_dtype=torch.bfloat16 if s["bf16"] else torch.float32,
                                 device="cpu")
    port.load_state_dict(state_dict_from_jax_params(s["params"], cfg), strict=True)
    with torch.inference_mode():
        return port.encode_sequence(s["port_features"]).float().numpy()


def _assert_close(s, got, want):
    assert got.shape == want.shape
    if not s["bf16"]:
        np.testing.assert_allclose(got, want, **F32_TOL)
        return
    scale = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 1e-6)
    row_err = (np.abs(got - want) / scale).max()
    assert row_err <= BF16_ROW_TOL, row_err


def test_xla_path_matches_jax(variant_setup, monkeypatch):
    s = variant_setup

    def no_k1(*args, **kwargs):
        raise AssertionError("fused_inference=False must not run K1")

    monkeypatch.setattr(port_hstu, "fused_hstu_block", no_k1)
    _assert_close(s, _port_encode(s, fused=False), _jax_encode(s, fused=False))


def test_k1_path_matches_jax_fused(variant_setup, monkeypatch):
    """fused_inference=True: every block through K1's wrapper (its plain
    version on the CPU) in the mode JAX picks, against the Pallas kernel."""
    s = variant_setup
    calls = []
    real = port_hstu.fused_hstu_block

    def counting(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_hstu, "fused_hstu_block", counting)
    got = _port_encode(s, fused=True)
    assert len(calls) == s["cfg"].hstu.num_blocks
    mode = ("internal" if "rel_pos" in calls[0] else "bias" if "bias" in calls[0] else "none")
    softmax = s["cfg"].hstu.normalization == "softmax_rel_bias"
    want_mode = ("none" if s["name"] == "no_bias"
                 else "bias" if s["name"].startswith("int64") else "internal")
    assert mode == want_mode, (mode, calls[0].keys())
    if mode == "bias":
        assert calls[0]["mask_in_bias"] is (not softmax)
        assert calls[0]["bias"].dtype == (torch.bfloat16 if s["bf16"] else torch.float32)
    _assert_close(s, got, _jax_encode(s, fused=True))


# (bias mode, activation, softmax, concat_ua, dtype) of K1's plain version vs
# the Pallas kernel: every bias mode with and without softmax (the penalty
# form only without), each activation and output projection more than once.
K1_CASES = [
    ("internal", "none", False, True, "float32"),
    ("internal", "silu", True, False, "float32"),
    ("penalty", "silu", False, True, "float32"),
    ("raw", "none", False, False, "float32"),
    ("raw", "silu", True, True, "float32"),
    ("none", "silu", False, False, "float32"),
    ("none", "none", True, True, "float32"),
    ("internal", "silu", True, True, "bfloat16"),
    ("penalty", "none", False, True, "bfloat16"),
]


@pytest.mark.parametrize("case", K1_CASES, ids=lambda c: "-".join(str(v) for v in c))
def test_k1_plain_version_matches_pallas(case):
    mode, activation, softmax, concat_ua, dtype = case
    b, n, d, h, dqk, dv, nb = 4, 16, 32, 2, 8, 8, 32
    rng = np.random.default_rng(7)
    f = 2 * h * dv + 2 * h * dqk
    lengths = np.array([16, 9, 3, 12])
    colmask = (np.arange(n)[None] < lengths[:, None]).astype(np.float32)
    ts = np.cumsum(rng.integers(1, 5000, (b, n)), axis=1).astype(np.int32)
    ext = np.concatenate([ts, ts[:, -1:]], axis=1)
    i, j = np.arange(n)[:, None], np.arange(n)[None, :]
    pos_w = (0.3 * rng.standard_normal(2 * n - 1)).astype(np.float32)
    rel_pos = pos_w[j - i + n - 1]
    tsw = np.zeros(128, np.float32)
    tsw[: nb + 1] = 0.3 * rng.standard_normal(nb + 1)
    jdt = getattr(jnp, dtype)
    ops = dict(
        x=rng.standard_normal((b, n, d)).astype(np.float32),
        uvqk=(rng.standard_normal((d, f)) / d**0.5).astype(np.float32),
        o_kernel=(rng.standard_normal(((3 if concat_ua else 1) * h * dv, d))
                  / (h * dv) ** 0.5).astype(np.float32),
        o_bias=(0.1 * rng.standard_normal(d)).astype(np.float32),
    )
    bias = None
    if mode in ("penalty", "raw"):
        delta = ext[:, 1:, None] - ext[:, None, :n]
        bk = np.clip((np.log(np.maximum(np.abs(delta), 1).astype(np.float32))
                      / np.float32(0.301)).astype(np.int32), 0, nb)
        bias = rel_pos[None] + tsw[bk]
        if mode == "penalty":
            bias = bias + ((j <= i)[None] * colmask[:, None, :] - 1.0) * 30000.0
        bias = bias.astype(np.float32)
    kw = dict(num_heads=h, dqk=dqk, dv=dv, inv_n=1.0 / n, eps=1e-6, num_buckets=nb,
              activation=activation,
              normalization="softmax_rel_bias" if softmax else "rel_bias")
    mm = {k: jnp.asarray(v, jdt) for k, v in ops.items() if k != "o_bias"}
    want = jax_fused_hstu_block(
        mm["x"], None if bias is None else jnp.asarray(bias, jdt), jnp.asarray(colmask),
        mm["uvqk"], mm["o_kernel"], jnp.asarray(ops["o_bias"]),
        mask_in_bias=mode == "penalty",
        time_bias=(jnp.asarray(rel_pos), jnp.asarray(ext), jnp.asarray(tsw))
        if mode == "internal" else None,
        interpret=True, **kw)
    tdt = getattr(torch, dtype)
    args = dict(x=torch.from_numpy(ops["x"]).to(tdt), colmask=torch.from_numpy(colmask),
                uvqk=torch.from_numpy(ops["uvqk"]).to(tdt),
                o_kernel=torch.from_numpy(ops["o_kernel"]).to(tdt),
                o_bias=torch.from_numpy(ops["o_bias"]))
    if mode == "internal":
        args.update(rel_pos=torch.from_numpy(rel_pos), ext=torch.from_numpy(ext),
                    tsw=torch.from_numpy(tsw))
    elif bias is not None:
        args.update(bias=torch.from_numpy(bias).to(tdt), mask_in_bias=mode == "penalty")
    got = hstu_block.fused_hstu_block(**args, **kw)
    assert hstu_block.fused_hstu_block.launches == 0
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    else:
        # One bf16 ulp of the output (2^-8 relative), from other f32 orders.
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


def test_eval_step_ranks_match_jax_for_concat_ua_softmax():
    """The slice as a whole: the concat_ua + softmax model's eval step through
    K1 (plain on the CPU) gives JAX's fused eval step's ranks."""
    changes = _merge(SMALL, VARIANTS["concat_ua+softmax"],
                     dict(hstu=dict(fused_inference=True), data=dict(synthetic_num_users=128)))
    cfg = _configure(get_experiment_config("synthetic-small"), changes)
    port_cfg = _configure(port_config.get_experiment_config("synthetic-small"), changes)
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.eval_dataset.batches(
        batch_size=64, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    model, state, _, _ = jax_loop.create_train_state(cfg, ds.max_item_id, ds.all_item_ids,
                                                     batch)
    method, k = "MoLBruteForceTopKFused", 60
    es = jax_eval.get_eval_state(model, state.params, ds.all_item_ids, method)
    jstep = jax_eval.make_eval_step_fn(model, method, k=k, num_objects=es.num_objects)
    ranks = np.asarray(jstep(state.params, es.topk_state, es.item_embeddings, batch.features,
                             batch.target_ids)[0])
    port = SequentialRecommender(port_cfg, ds.max_item_id, device="cpu")
    port.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, state.params), port_cfg), strict=True)
    pes = port_eval.get_eval_state(port, ds.all_item_ids, method, device="cpu")
    pstep = port_eval.make_eval_step_fn(port, method, k=k, num_objects=pes.num_objects)
    p_ranks = pstep(pes.topk_state, _torch_features(batch.features, False),
                    torch.from_numpy(np.array(batch.target_ids)))[0].numpy()
    assert (ranks < 1001).sum() >= 5
    np.testing.assert_array_equal(p_ranks, ranks)


def test_three_xla_train_steps_match_jax_for_concat_ua_softmax(monkeypatch):
    """fused_train=False: three steps of the concat_ua + softmax model
    (autograd through the XLA block path) give JAX's losses."""
    changes = _merge(NO_DROPOUT, VARIANTS["concat_ua+softmax"], dict(hstu=dict(fused_train=False)))
    cfg = _configure(get_experiment_config("synthetic-small"), changes)
    port_cfg = _configure(port_config.get_experiment_config("synthetic-small"), changes)
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.train_dataset.batches(
        batch_size=8, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    b, n = batch.features.ids.shape
    negatives = np.random.default_rng(5).choice(
        ds.all_item_ids, size=(b * (n - 1), cfg.train.num_negatives)).astype(np.int32)
    _fix_negatives(monkeypatch, negatives)
    _, state, train_step, _ = jax_loop.create_train_state(cfg, ds.max_item_id, ds.all_item_ids,
                                                          batch)
    s = dict(port_cfg=port_cfg, ds=ds, params=jax.tree_util.tree_map(np.asarray, state.params),
             opt_state=jax.tree_util.tree_map(np.asarray, state.opt_state))
    want, rng = [], jax.random.PRNGKey(0)
    for _ in range(3):
        state, m = train_step(state, batch, rng)
        want.append(float(m["loss"]))
    _, port_state, port_step = _port_state(s)
    pbatch, gen = _port_batch(batch), torch.Generator().manual_seed(0)
    got = []
    for _ in range(3):
        port_state, m = port_step(port_state, pbatch, gen)
        got.append(m["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("variant", ["concat_ua", "softmax", "act_none", "no_bias"])
def test_fused_train_with_a_variant_raises(variant, monkeypatch):
    """fused_train=True with a variant flag once raised NotImplementedError
    naming `K4 variants`; it now trains through K4 (its plain versions on the
    CPU) with the variant in the block's meta and, without the bias, no bias
    operands; gradients reach x and every block weight."""
    changes = _merge(VARIANTS[variant], dict(hstu=dict(fused_train=True)))
    cfg = _configure(port_config.get_experiment_config("synthetic-small"), changes)
    stack = port_hstu.HSTUStack(cfg.hstu, 8, torch.float32, torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, cfg.hstu.embedding_dim, generator=torch.Generator().manual_seed(1))
    x.requires_grad_(True)
    valid = torch.ones(2, 8, dtype=torch.bool)
    ts = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    calls = []
    real = port_hstu.fused_train_block
    monkeypatch.setattr(port_hstu, "fused_train_block",
                        lambda *a: calls.append(a) or real(*a))
    out = stack(x, valid, ts, train=True, seed0=5)
    out.sum().backward()
    assert len(calls) == cfg.hstu.num_blocks
    meta = calls[0][-1]
    assert (meta.concat_ua, meta.softmax, meta.activation) == (
        cfg.hstu.concat_ua, cfg.hstu.normalization == "softmax_rel_bias",
        cfg.hstu.linear_activation)
    assert (calls[0][1] is None) == (variant == "no_bias")
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    for name, p in stack.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name


def test_no_bias_state_dict_has_no_rel_attn_bias():
    """Without the bias the port, like the flax tree, has no rel_attn_bias
    entry; concat_ua's o_kernel carries 3*h*dv rows."""
    cfg = _configure(port_config.get_experiment_config("synthetic-small"),
                     _merge(VARIANTS["no_bias"], VARIANTS["concat_ua"]))
    port = SequentialRecommender(cfg, 20, device="cpu")
    names = port.state_dict().keys()
    assert not any("rel_attn_bias" in k for k in names)
    h = cfg.hstu
    assert port.state_dict()["hstu.block_0.o_kernel"].shape == (3 * h.num_heads * h.dv,
                                                                 h.embedding_dim)
