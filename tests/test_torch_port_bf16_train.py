"""The bf16 training path (the frontier's pre-train) vs the JAX package.

The frontier pre-trains `ml-20m-hstu-mol` with `main_module_bf16=True`: K4's
train block runs with bf16 x, uvqk and o_kernel (f32 accumulation), and the
rest of the step computes in bf16 with f32 parameters. Here the port's plain
versions (CPU tensors) are held against `make_fused_train_block` in
interpret mode and `make_train_step` at `synthetic-small` widths, with the
same numpy inputs, fixed negatives and no dropout in the whole-step tests.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.core.config import get_experiment_config
from rails_tpu.ops.pallas.hash_dropout import i32
from rails_tpu.ops.pallas.hstu_block_train import _dropout_mask_batch, make_fused_train_block
from rails_tpu.train import loop as jax_loop
from rails_tpu_torch.compat.from_jax import state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.ops import hash_dropout, hstu_block_train
from rails_tpu_torch.ops.hstu_block_train import BlockMeta, fused_train_block
from tests.test_torch_port_train_step import (
    NO_DROPOUT,
    _configure,
    _fix_negatives,
    _port_batch,
    _port_state,
)

# Each output within this share of its largest |value|, each gradient within
# GRAD_TOL of its leaf's largest |value|: both sides round the same operands
# to bf16 and sum products in f32, in other orders.
OUT_TOL = 1e-2
GRAD_TOL = 2e-2
GRAD_ARGS = ("x", "rel_pos", "tsw", "uvqk", "o_kernel", "o_bias")
BF16_ARGS = ("x", "uvqk", "o_kernel")
# The whole step: loss within rtol 1e-2; gradients within STEP_GRAD_TOL of
# each parameter group's largest |value|. Measured: at most 6.6e-2
# (`input_preproc.pos_emb`), 5.4e-2 (`hstu`), 3.8e-2 (`item_emb`), 4.1e-2
# (`mol`). That is bf16 noise, not a rounding point the port misses: JAX's
# own bf16 step differs from its f32 step by up to 4.3e-2 on the same
# leaves, the encoder's backward under one cotangent agrees to 7.5e-3, and
# the MoL scores of the two bf16 sides differ by 1.8e-2 of their largest
# value where JAX's bf16 and f32 scores differ by 1.9e-2 (XLA's CPU fusions
# keep f32 across bf16 elementwise chains, which torch rounds op by op).
STEP_LOSS_RTOL = 1e-2
STEP_GRAD_TOL = 7e-2


def _block_inputs(b, n, d=32, h=2, dqk=16, dv=16, seed=0):
    rng = np.random.default_rng(seed)
    f = 2 * h * dv + 2 * h * dqk
    lengths = np.maximum(1, rng.integers(1, n + 1, b))
    lengths[0] = n
    ts = np.sort(rng.integers(0, 1 << 30, (b, n)), axis=1)
    pos_w = 0.02 * rng.standard_normal(2 * n - 1)
    i, j = np.arange(n)[:, None], np.arange(n)[None, :]
    colmask = (np.arange(n)[None, :] < lengths[:, None]).astype(np.float32)
    return {
        "x": (rng.standard_normal((b, n, d)) * colmask[..., None]).astype(np.float32),
        "colmask": colmask,
        "rel_pos": pos_w[j - i + n - 1].astype(np.float32),
        "ext": np.concatenate([ts, ts[:, n - 1:]], axis=1).astype(np.int32),
        "tsw": (0.1 * rng.standard_normal(128)).astype(np.float32),
        "uvqk": (rng.standard_normal((d, f)) / math.sqrt(d)).astype(np.float32),
        "o_kernel": (rng.standard_normal((h * dv, d)) / math.sqrt(h * dv)).astype(np.float32),
        "o_bias": (0.02 * rng.standard_normal(d)).astype(np.float32),
    }


def _share(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("rate,b,n", [(0.0, 4, 35), (0.2, 4, 35), (0.2, 1, 1)],
                         ids=["rate0", "rate0.2", "n1"])
def test_bf16_train_block_matches_pallas(rate, b, n):
    """The bf16 block's forward and the gradients of sum(out * w) against
    make_fused_train_block with bf16 x, uvqk and o_kernel."""
    o = _block_inputs(b, n)
    h, dqk, dv = 2, 16, 16
    seed = 424_242_421
    weight = np.cos(np.arange(o["x"].size).reshape(o["x"].shape) * 0.01).astype(np.float32)
    blk = make_fused_train_block(num_heads=h, dqk=dqk, dv=dv, inv_n=1.0 / 35, eps=1e-6,
                                 dropout_rate=rate, num_buckets=128, interpret=True)
    j = {k: jnp.asarray(v, jnp.bfloat16 if k in BF16_ARGS else None) for k, v in o.items()}

    def jax_loss(x, rel_pos, tsw, uvqk, o_kernel, o_bias):
        out = blk(x, j["colmask"], rel_pos, j["ext"], tsw, uvqk, o_kernel, o_bias,
                  jnp.int32(seed))
        return jnp.sum(out.astype(jnp.float32) * weight), out

    (_, want_out), want_grads = jax.value_and_grad(jax_loss, argnums=tuple(range(6)),
                                                   has_aux=True)(*(j[k] for k in GRAD_ARGS))
    assert want_out.dtype == jnp.bfloat16

    t = {k: torch.from_numpy(v) for k, v in o.items()}
    leaves = {k: t[k].to(torch.bfloat16 if k in BF16_ARGS else torch.float32)
              .clone().requires_grad_(True) for k in GRAD_ARGS}
    meta = BlockMeta(h, dqk, dv, 1.0 / 35, 1e-6, 128, rate)
    out = fused_train_block(leaves["x"], leaves["rel_pos"], leaves["tsw"], leaves["uvqk"],
                            leaves["o_kernel"], leaves["o_bias"], t["colmask"], t["ext"], seed,
                            meta)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(weight)).sum().backward()
    assert _share(out.detach().float(), want_out.astype(jnp.float32)) <= OUT_TOL
    for name, want in zip(GRAD_ARGS, want_grads):
        got = leaves[name].grad
        assert got.dtype == leaves[name].dtype, name
        assert _share(got.float(), want.astype(jnp.float32)) <= GRAD_TOL, name


def test_bf16_backward_recomputes_jax_attn():
    """The bf16 attention backward recomputes attn from the bf16 y, as the
    JAX backward does; the forward's attn (v rounded once) differs from it."""
    o = _block_inputs(4, 35, seed=2)
    h, dqk, dv = 2, 16, 16
    meta = BlockMeta(h, dqk, dv, 1.0 / 35, 1e-6, 128, 0.0)
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    bf = {k: t[k].to(torch.bfloat16) for k in BF16_ARGS}
    _, fwd_attn = hstu_block_train.fused_train_block_forward_reference(
        bf["x"], t["colmask"], bf["uvqk"], bf["o_kernel"], t["o_bias"], t["rel_pos"], t["ext"],
        t["tsw"], 0, meta)
    n0 = hstu_block_train.ln(bf["x"].float(), meta.eps)
    z = n0.to(torch.bfloat16).float() @ bf["uvqk"].float()
    y = (z * torch.sigmoid(z)).to(torch.bfloat16)
    d_o = torch.ones(4, 35, h * dv, dtype=torch.bfloat16)
    _, _, attn = hstu_block_train.attn_backward(y, d_o, None, t["colmask"], t["rel_pos"],
                                                t["ext"], t["tsw"], meta)

    # The JAX backward kernel's own recompute: its attn output (interpret mode).
    from rails_tpu.ops.pallas import hstu_block_train as jbt

    captured = {}
    real = jbt.pl.pallas_call

    def spy(kernel, **kw):
        call = real(kernel, **kw)
        if getattr(kernel, "func", None) is not jbt._attn_bwd_kernel:
            return call

        def run(*args):
            out = call(*args)
            captured["attn"] = out[1]
            return out
        return run

    j = {k: jnp.asarray(v, jnp.bfloat16 if k in BF16_ARGS else None) for k, v in o.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbt.pl, "pallas_call", spy)
        blk = make_fused_train_block(num_heads=h, dqk=dqk, dv=dv, inv_n=1.0 / 35, eps=1e-6,
                                     dropout_rate=0.0, num_buckets=128, interpret=True)
        jax.grad(lambda x: jnp.sum(blk(
            x, j["colmask"], j["rel_pos"], j["ext"], j["tsw"], j["uvqk"], j["o_kernel"],
            j["o_bias"], jnp.int32(0)).astype(jnp.float32)))(j["x"])
    want = np.asarray(captured["attn"], np.float32)
    scale = np.abs(want).max()
    assert np.abs(attn.numpy() - want).max() <= 1e-3 * scale
    assert not torch.equal(attn, fwd_attn)


@pytest.mark.parametrize("seed0", [0, -1_498_392_781, 2**31 - 7])
def test_bf16_o_input_hash_stream_equals_keep_from_idx(seed0):
    """The o_input keep mask of the bf16 block at ml-20m widths (h*dv = 256)
    is the JAX package's `_dropout_mask_batch` bit for bit."""
    b, n, width, rate = 3, 11, 256, 0.2
    want = np.asarray(_dropout_mask_batch(jnp.int32(i32(seed0)), b, n, width, rate))
    got = hash_dropout.hash_keep_mask(b, n, width, seed0, rate, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)


BF16_STEP = dict(NO_DROPOUT, train=dict(NO_DROPOUT["train"], main_module_bf16=True))


@pytest.fixture(scope="module")
def bf16_setup():
    from rails_tpu.data import datasets as jax_datasets

    cfg = _configure(get_experiment_config("synthetic-small"), BF16_STEP)
    port_cfg = _configure(port_config.get_experiment_config("synthetic-small"), BF16_STEP)
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.train_dataset.batches(
        batch_size=8, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    b, n = batch.features.ids.shape
    negatives = np.random.default_rng(5).choice(
        ds.all_item_ids, size=(b * (n - 1), cfg.train.num_negatives)).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp:
        _fix_negatives(mp, negatives)
        model, state, train_step, sampler = jax_loop.create_train_state(
            cfg, ds.max_item_id, ds.all_item_ids, batch)
    return dict(cfg=cfg, port_cfg=port_cfg, ds=ds, batch=batch, model=model, state=state,
                train_step=train_step, sampler=sampler, negatives=negatives,
                params=jax.tree_util.tree_map(np.asarray, state.params),
                opt_state=jax.tree_util.tree_map(np.asarray, state.opt_state))


def test_bf16_step_loss_aux_and_grads_match_jax(bf16_setup, monkeypatch):
    from rails_tpu.losses.sampled_softmax import get_weighted_loss as jax_weighted_loss
    from rails_tpu.losses.sampled_softmax import sampled_softmax_loss as jax_loss

    s = bf16_setup
    _fix_negatives(monkeypatch, s["negatives"])
    cfg, model = s["cfg"], s["model"]
    features = jax_loop.scatter_target(s["batch"].features, s["batch"].target_ids)

    @jax.jit
    def loss_and_grads(params):
        def loss_fn(p):
            main, aux = model.apply(p, features, s["sampler"], cfg.train.num_negatives,
                                    cfg.train.temperature, True, False, method=jax_loss,
                                    rngs={"dropout": jax.random.PRNGKey(0),
                                          "sampler": jax.random.PRNGKey(1)})
            return jax_weighted_loss(main, aux, dict(cfg.train.loss_weights)), (main, aux)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (total, (main, aux)), grads = loss_and_grads(s["params"])
    want_grads = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, grads),
                                            s["port_cfg"])
    port, state, train_step = _port_state(s)
    assert port.compute_dtype == torch.bfloat16
    _, metrics = train_step(state, _port_batch(s["batch"]), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(metrics["loss"].item(), float(main), rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(metrics["loss_incl_aux"].item(), float(total),
                               rtol=STEP_LOSS_RTOL)
    for key in aux:
        np.testing.assert_allclose(metrics[f"aux/{key}"].item(), float(aux[key]),
                                   rtol=STEP_LOSS_RTOL, atol=1e-4, err_msg=key)
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want_grads)
    groups: dict = {}
    for name, want in want_grads.items():
        assert got[name].dtype == torch.float32, name
        group = name.split(".")[0]
        scale = max(groups.get(group, (0.0, 0.0))[1], float(want.abs().max()))
        err = max(groups.get(group, (0.0, 0.0))[0], float((got[name] - want).abs().max()))
        groups[group] = (err, scale)
    for group, (err, scale) in groups.items():
        assert err <= STEP_GRAD_TOL * scale, (group, err, scale)


def test_bf16_three_steps_match_jax(bf16_setup, monkeypatch):
    s = bf16_setup
    _fix_negatives(monkeypatch, s["negatives"])
    state, rng = s["state"], jax.random.PRNGKey(0)
    want = []
    for _ in range(3):
        state, m = s["train_step"](state, s["batch"], rng)
        want.append(float(m["loss"]))
    _, port_state, train_step = _port_state(s)
    batch, gen = _port_batch(s["batch"]), torch.Generator().manual_seed(0)
    got = []
    for _ in range(3):
        port_state, m = train_step(port_state, batch, gen)
        got.append(m["loss"].item())
    assert port_state.optimizer.state.count == 3
    np.testing.assert_allclose(got, want, rtol=STEP_LOSS_RTOL)
    assert got[2] < got[0]
