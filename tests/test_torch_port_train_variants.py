"""K4's variants in the port vs rails_tpu's `make_fused_train_block`.

Each variant of the fused HSTU train block (concat_ua, softmax_rel_bias,
linear_activation none, no relative-attention bias, attention dropout in the
pointwise and the softmax map, concat_ua + softmax, and head dims above 32)
runs through the port's `fused_train_block` on CPU tensors (its plain
forward and attention backward inside the block's glue) and through
`make_fused_train_block(..., interpret=True)` on the same numpy inputs and
the same explicit dropout seed. The attention keep mask is held bit for bit
to `_attn_dropout_mask`, and three training steps of `synthetic-small` with
`fused_train=True` and each structural flag to JAX's `make_train_step`.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.core.config import get_experiment_config
from rails_tpu.data import datasets as jax_datasets
from rails_tpu.ops.pallas.hash_dropout import i32
from rails_tpu.ops.pallas.hstu_block_train import _attn_dropout_mask, make_fused_train_block
from rails_tpu.train import loop as jax_loop
from rails_tpu_torch.compat.from_jax import state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.models import hstu as port_hstu
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.ops import hash_dropout, hstu_block_train
from rails_tpu_torch.ops.hstu_block_train import BlockMeta, fused_train_block
from tests.test_torch_port_bf16_train import GRAD_TOL as BF16_GRAD_TOL
from tests.test_torch_port_bf16_train import OUT_TOL as BF16_OUT_TOL
from tests.test_torch_port_train_kernels import BLOCK_FWD_TOL, BLOCK_GRAD_TOL
from tests.test_torch_port_train_step import (
    NO_DROPOUT,
    _configure,
    _fix_negatives,
    _port_batch,
    _port_state,
)

# name -> (h, dqk, dv, activation, softmax, concat_ua, bias, attn_rate)
VARIANTS = {
    "concat_ua": (2, 16, 16, "silu", False, True, True, 0.0),
    "softmax": (2, 16, 16, "silu", True, False, True, 0.0),
    "act_none": (2, 16, 16, "none", False, False, True, 0.0),
    "no_bias": (2, 16, 16, "silu", False, False, False, 0.0),
    "attn_dropout": (2, 16, 16, "silu", False, False, True, 0.2),
    "attn_dropout+softmax": (2, 16, 16, "silu", True, False, True, 0.2),
    "concat_ua+softmax": (2, 16, 16, "silu", True, True, True, 0.0),
    "no_bias+softmax+attn_dropout": (2, 16, 16, "silu", True, False, False, 0.2),
    "wide_h2_d40": (2, 40, 40, "silu", False, False, True, 0.0),
}
BF16_VARIANTS = ("concat_ua+softmax", "act_none")
GRAD_ARGS = ("x", "rel_pos", "tsw", "uvqk", "o_kernel", "o_bias")
RATE = 0.2        # o_input dropout, over o_input's whole width
# The glue against autograd of the plain forward: each gradient within this
# share of its largest |value|. Both sum the same f32 terms in other orders
# (measured: at most 4.1e-7); an elementwise rtol fails where the LayerNorm
# backward cancels to a small value.
GLUE_TOL = 1e-5
SEED = -987_654_321
B, N, D = 4, 21, 32


def _meta(name: str) -> BlockMeta:
    h, dqk, dv, act, softmax, concat_ua, _, attn_rate = VARIANTS[name]
    return BlockMeta(h, dqk, dv, 1.0 / N, 1e-6, 128, RATE, act, softmax, concat_ua, attn_rate)


def _inputs(name: str, seed: int = 0) -> dict:
    h, dqk, dv, _, _, concat_ua, _, _ = VARIANTS[name]
    rng = np.random.default_rng(seed)
    f = 2 * h * dv + 2 * h * dqk
    rows = (3 if concat_ua else 1) * h * dv
    lengths = np.array([N, 1, N // 2, N - 3])
    ts = np.sort(rng.integers(0, 1 << 30, (B, N)), axis=1)
    pos_w = 0.02 * rng.standard_normal(2 * N - 1)
    i, j = np.arange(N)[:, None], np.arange(N)[None, :]
    colmask = (np.arange(N)[None, :] < lengths[:, None]).astype(np.float32)
    return {
        "x": (rng.standard_normal((B, N, D)) * colmask[..., None]).astype(np.float32),
        "colmask": colmask,
        "rel_pos": pos_w[j - i + N - 1].astype(np.float32),
        "ext": np.concatenate([ts, ts[:, N - 1:]], axis=1).astype(np.int32),
        "tsw": (0.1 * rng.standard_normal(128)).astype(np.float32),
        "uvqk": (rng.standard_normal((D, f)) / math.sqrt(D)).astype(np.float32),
        "o_kernel": (rng.standard_normal((rows, D)) / math.sqrt(rows)).astype(np.float32),
        "o_bias": (0.02 * rng.standard_normal(D)).astype(np.float32),
    }


def _grad_args(name: str) -> tuple:
    return GRAD_ARGS if VARIANTS[name][6] else ("x", "uvqk", "o_kernel", "o_bias")


def _jax_block(name: str, o: dict, weight: np.ndarray, bf16: bool):
    """JAX's forward and the gradients of sum(out * weight) over the
    variant's differentiable arguments."""
    meta = _meta(name)
    blk = make_fused_train_block(
        num_heads=meta.num_heads, dqk=meta.dqk, dv=meta.dv, inv_n=meta.inv_n, eps=meta.eps,
        dropout_rate=meta.rate, num_buckets=meta.num_buckets, interpret=True,
        activation=meta.activation,
        normalization="softmax_rel_bias" if meta.softmax else "rel_bias",
        concat_ua=meta.concat_ua, attn_dropout_rate=meta.attn_rate)
    low = ("x", "uvqk", "o_kernel") if bf16 else ()
    j = {k: jnp.asarray(v, jnp.bfloat16 if k in low else None) for k, v in o.items()}
    names = _grad_args(name)
    has_bias = VARIANTS[name][6]

    def loss(*leaves):
        kw = dict(zip(names, leaves))
        out = blk(kw["x"], j["colmask"], kw.get("rel_pos"), j["ext"] if has_bias else None,
                  kw.get("tsw"), kw["uvqk"], kw["o_kernel"], kw["o_bias"], jnp.int32(SEED))
        return jnp.sum(out.astype(jnp.float32) * weight), out

    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(len(names))), has_aux=True)(
        *(j[k] for k in names))
    return np.asarray(out.astype(jnp.float32)), {
        k: np.asarray(g.astype(jnp.float32)) for k, g in zip(names, grads)}


def _port_block(name: str, o: dict, weight: np.ndarray, bf16: bool, fn=fused_train_block):
    """The port's forward (f32 copy) and gradients, from CPU tensors."""
    names = _grad_args(name)
    low = ("x", "uvqk", "o_kernel") if bf16 else ()
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    leaves = {k: t[k].to(torch.bfloat16 if k in low else torch.float32).clone()
              .requires_grad_(True) for k in names}
    out = fn(leaves["x"], leaves.get("rel_pos"), leaves.get("tsw"), leaves["uvqk"],
             leaves["o_kernel"], leaves["o_bias"], t["colmask"],
             t["ext"] if VARIANTS[name][6] else None, SEED, _meta(name))
    assert out.dtype == (torch.bfloat16 if bf16 else torch.float32)
    (out.float() * torch.from_numpy(weight)).sum().backward()
    for k in names:
        assert leaves[k].grad.dtype == leaves[k].dtype, k
    return out.detach().float().numpy(), {k: leaves[k].grad.float().numpy() for k in names}


def _weight() -> np.ndarray:
    return np.cos(np.arange(B * N * D).reshape(B, N, D) * 0.01).astype(np.float32)


def _share(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_attn_keep_mask_is_bit_equal_to_attn_dropout_mask(rate):
    """The plain attention keep mask against `_attn_dropout_mask` per (user,
    head), the softmax map's head 0 included, at several layer seeds."""
    b, n, h = 3, 13, 4
    for seed0 in (0, -5, 2**31 - 3, -(2**31), 987654321):
        got = hash_dropout.attn_keep_mask_reference(b, n, h, seed0, rate, "cpu")
        assert got.shape == (b, h, n, n) and got.dtype == torch.float32
        for user in range(b):
            for head in range(h):
                want = np.asarray(_attn_dropout_mask(jnp.int32(i32(seed0)), jnp.int32(user), 1, 0,
                                                     head, n, rate))
                assert np.array_equal(got[user, head].numpy(), want), (seed0, user, head)
    kept = (got > 0).float().mean().item()
    assert abs(kept - (1.0 - rate)) < 0.06


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_block_matches_pallas(name):
    """f32: forward and gradients of x, rel_pos, tsw (with the bias), uvqk,
    o_kernel and o_bias against make_fused_train_block in interpret mode at
    JAX's own fused-train tolerances."""
    o, w = _inputs(name), _weight()
    want_out, want = _jax_block(name, o, w, bf16=False)
    got_out, got = _port_block(name, o, w, bf16=False)
    np.testing.assert_allclose(got_out, want_out, **BLOCK_FWD_TOL)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **BLOCK_GRAD_TOL)


@pytest.mark.parametrize("name", BF16_VARIANTS)
def test_bf16_variant_block_matches_pallas(name):
    """bf16 x, uvqk and o_kernel: the forward within OUT_TOL and each gradient
    within GRAD_TOL of its largest value (`test_torch_port_bf16_train.py`)."""
    o, w = _inputs(name, seed=1), _weight()
    want_out, want = _jax_block(name, o, w, bf16=True)
    got_out, got = _port_block(name, o, w, bf16=True)
    assert _share(got_out, want_out) <= BF16_OUT_TOL
    for k in want:
        assert _share(got[k], want[k]) <= BF16_GRAD_TOL, k


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_glue_matches_autograd_of_the_plain_forward(name):
    """The custom backward (glue + plain attention backward) against
    autograd of the plain forward, on the same dropout masks."""
    o, w = _inputs(name, seed=2), _weight()
    _, got = _port_block(name, o, w, bf16=False)
    _, want = _port_block(name, o, w, bf16=False,
                          fn=hstu_block_train.fused_train_block_autograd_reference)
    for k in want:
        assert _share(got[k], want[k]) <= GLUE_TOL, k


def test_no_bias_block_has_no_bias_gradients():
    """Without the bias the block returns no dbias and takes no rel_pos, ext
    or tsw; mixing them is refused."""
    name = "no_bias"
    o = _inputs(name)
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    meta = _meta(name)
    y = torch.randn(B, N, 2 * 2 * 16 + 2 * 2 * 16)
    d_y, dbias, attn = hstu_block_train.attn_backward_reference(
        y, torch.randn(B, N, 32), None, t["colmask"], None, None, None, meta, SEED)
    assert dbias is None and d_y.shape == y.shape and attn.shape == (B, N, 32)
    with pytest.raises(ValueError, match="all None"):
        hstu_block_train.fused_train_block_forward(
            t["x"], t["colmask"], t["uvqk"], t["o_kernel"], t["o_bias"], t["rel_pos"], None,
            t["tsw"], SEED, meta)
    with pytest.raises(ValueError, match="activation"):
        hstu_block_train.fused_train_block_forward(
            t["x"], t["colmask"], t["uvqk"], t["o_kernel"], t["o_bias"], None, None, None, SEED,
            meta._replace(activation="gelu"))


# Structural flags of the whole step (no dropout anywhere).
STEP_FLAGS = {
    "concat_ua": dict(concat_ua=True),
    "softmax": dict(normalization="softmax_rel_bias"),
    "act_none": dict(linear_activation="none"),
    "no_bias": dict(enable_relative_attention_bias=False),
    "concat_ua+softmax": dict(concat_ua=True, normalization="softmax_rel_bias"),
    "wide_d40": dict(dqk=40, dv=40),
}


@pytest.mark.parametrize("flag", list(STEP_FLAGS))
def test_three_fused_train_steps_match_jax(flag, monkeypatch):
    """synthetic-small with fused_train=True and the flag: three optimizer
    steps of the port (K4's plain versions on the CPU) give JAX's losses
    (K4 in interpret mode) to rtol 1e-4."""
    changes = dict(NO_DROPOUT, hstu=dict(NO_DROPOUT["hstu"], **STEP_FLAGS[flag]))
    cfg = _configure(get_experiment_config("synthetic-small"), changes)
    port_cfg = _configure(port_config.get_experiment_config("synthetic-small"), changes)
    assert cfg.hstu.fused_train and cfg.hstu.attn_dropout_rate == 0.0
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
    calls = []
    real = port_hstu.fused_train_block
    monkeypatch.setattr(port_hstu, "fused_train_block",
                        lambda *a, **k: calls.append(a[-1]) or real(*a, **k))
    _, port_state, port_step = _port_state(s)
    pbatch, gen = _port_batch(batch), torch.Generator().manual_seed(0)
    got = []
    for _ in range(3):
        port_state, m = port_step(port_state, pbatch, gen)
        got.append(m["loss"].item())
    assert len(calls) == 3 * cfg.hstu.num_blocks
    assert calls[0].concat_ua == cfg.hstu.concat_ua
    assert calls[0].softmax == (cfg.hstu.normalization == "softmax_rel_bias")
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("normalization", ["rel_bias", "softmax_rel_bias"])
def test_fused_train_step_with_attention_dropout_trains(normalization, monkeypatch):
    """synthetic-small with fused_train=True and attention dropout 0.1 trains
    a step through K4 (its plain versions on the CPU), with the rate in every
    block's BlockMeta, to a finite loss."""
    from rails_tpu_torch.data.features import batch_from_rows
    from rails_tpu_torch.train.loop import create_train_state

    cfg = port_config.get_experiment_config("synthetic-small")
    cfg = cfg.replace(hstu=cfg.hstu.replace(fused_train=True, attn_dropout_rate=0.1,
                                            normalization=normalization))
    n = cfg.data.max_sequence_length
    lengths = np.array([5, 9])
    ids = (np.arange(1, n + 1)[None] * (np.arange(n)[None] < lengths[:, None])).astype(np.int32)
    batch = batch_from_rows(lengths, ids, ids, ids * 1000, np.array([3, 4]), np.array([1, 1]),
                            np.array([90000, 90000]), np.array([0, 1]),
                            max_output_length=cfg.train.gr_output_length + 1, device="cpu")
    calls = []
    real = port_hstu.fused_train_block
    monkeypatch.setattr(port_hstu, "fused_train_block",
                        lambda *a, **k: calls.append(a[-1]) or real(*a, **k))
    _, state, step, _ = create_train_state(cfg, 60, np.arange(1, 61), device="cpu")
    _, metrics = step(state, batch, torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(metrics["loss"]))
    assert len(calls) == cfg.hstu.num_blocks
    assert all(m.attn_rate == 0.1 for m in calls)
    assert calls[0].softmax == (normalization == "softmax_rel_bias")


@pytest.mark.parametrize("flags", [dict(concat_ua=True), dict(enable_relative_attention_bias=False),
                                   dict(num_heads=4, dqk=64, dv=64)],
                         ids=["concat_ua", "no_bias", "h4_d64"])
def test_variant_weights_load_strict(flags):
    """Each variant's flax tree maps across `compat.from_jax` into a strict
    load: a 3*h*dv o_kernel, no `rel_attn_bias`, and h=4 with dqk=dv=64."""
    changes = dict(NO_DROPOUT, hstu=dict(flags, fused_train=False))
    cfg = _configure(get_experiment_config("synthetic-small"), changes)
    port_cfg = _configure(port_config.get_experiment_config("synthetic-small"), changes)
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.train_dataset.batches(
        batch_size=8, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    _, params = jax_loop.init_model(cfg, ds.max_item_id, jax.random.PRNGKey(0), batch,
                                    all_item_ids=ds.all_item_ids)
    sd = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params), port_cfg)
    port = SequentialRecommender(port_cfg, ds.max_item_id, device="cpu")
    port.load_state_dict(sd, strict=True)
    h = port_cfg.hstu
    hdv = h.num_heads * h.dv
    assert sd["hstu.block_0.o_kernel"].shape == ((3 if h.concat_ua else 1) * hdv,
                                                 h.embedding_dim)
    assert sd["hstu.block_0.uvqk"].shape == (h.embedding_dim, 2 * hdv + 2 * h.num_heads * h.dqk)
    assert any("rel_attn_bias" in k for k in sd) == h.enable_relative_attention_bias
