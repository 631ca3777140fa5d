"""The training kernels' plain versions (K3, K4, K7) vs the JAX package.

The Pallas kernels run in interpret mode on the CPU; the port's wrappers get
CPU tensors, so they run their plain PyTorch versions. Inputs come from a
numpy seed and reach both sides as the same float32 values.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from rails_tpu.ops.pallas.hash_dropout import i32, keep_from_idx
from rails_tpu.ops.pallas.hstu_block_train import _dropout_mask_batch, make_fused_train_block
from rails_tpu.train.fused_adamw import fused_adamw
from rails_tpu_torch.ops import hash_dropout, hstu_block_train
from rails_tpu_torch.ops.hstu_block_train import BlockMeta, fused_train_block
from rails_tpu_torch.train import fused_adamw as port_adamw

# The block output is x + o_in @ Wo + bo with |x| up to ~4: both sides sum the
# same O(1) terms in other f32 orders, so the absolute error follows the
# terms (a few ulp of 4 is ~2e-6), not the sometimes small result.
BLOCK_FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_GRAD_TOL = dict(rtol=5e-3, atol=1e-4)    # tests/test_pallas_hstu.py:240-247
ADAMW_TOL = dict(rtol=1e-6, atol=1e-6)         # tests/test_fused_adamw.py


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_k3_plain_mask_is_bit_equal_to_keep_from_idx(rate):
    rng = np.random.default_rng(int(rate * 10))
    idx = np.concatenate([np.arange(4096), rng.integers(0, 1 << 24, 8192), [(1 << 24) - 1]])
    seeds = [0, 1, -1, -1498392781, 2**31 - 1, 2**31 - 2, -(2**31), 123456789]
    for seed in seeds:
        want = np.asarray(keep_from_idx(jnp.asarray(idx, jnp.int32), i32(seed), np.int32(0), rate))
        got = hash_dropout.keep_from_idx_reference(
            torch.from_numpy(idx.astype(np.int32)), torch.tensor(seed, dtype=torch.int64), rate)
        assert np.array_equal(got.numpy(), want), seed
    b, n, width = 3, 7, 40
    for seed0 in (0, -5, 2**31 - 3, 987654321):
        want = np.asarray(_dropout_mask_batch(jnp.int32(i32(seed0)), b, n, width, rate))
        got = hash_dropout.hash_keep_mask(b, n, width, seed0, rate, "cpu")
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want), seed0
    kept = (got > 0).float().mean().item()
    assert abs(kept - (1.0 - rate)) < 0.05


def _block_inputs(b=8, n=35, d=32, h=2, dqk=16, dv=16, seed=0):
    rng = np.random.default_rng(seed)
    f = 2 * h * dv + 2 * h * dqk
    lengths = np.array([n - 1, n - 1, n // 2, 1, 5, n - 3, 20, 11])[:b]
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


GRAD_ARGS = ("x", "rel_pos", "tsw", "uvqk", "o_kernel", "o_bias")


@pytest.mark.parametrize("rate,num_buckets", [(0.0, 128), (0.2, 128), (0.2, 32)],
                         ids=["rate0", "rate0.2", "rate0.2_buckets32"])
def test_fused_train_block_matches_pallas(rate, num_buckets):
    """Forward and gradients of sum(out * w) against make_fused_train_block in
    interpret mode, with the same explicit dropout seed on both sides."""
    o = _block_inputs()
    b, n, d = o["x"].shape
    h, dqk, dv = 2, 16, 16
    seed = -123456789
    weight = np.cos(np.arange(b * n * d).reshape(b, n, d) * 0.01).astype(np.float32)

    blk = make_fused_train_block(num_heads=h, dqk=dqk, dv=dv, inv_n=1.0 / n, eps=1e-6,
                                 dropout_rate=rate, num_buckets=num_buckets, interpret=True)
    j = {k: jnp.asarray(v) for k, v in o.items()}

    def jax_loss(x, rel_pos, tsw, uvqk, o_kernel, o_bias):
        out = blk(x, j["colmask"], rel_pos, j["ext"], tsw, uvqk, o_kernel, o_bias,
                  jnp.int32(seed))
        return jnp.sum(out * weight), out

    (_, want_out), want_grads = jax.value_and_grad(jax_loss, argnums=tuple(range(6)),
                                                   has_aux=True)(*(j[k] for k in GRAD_ARGS))

    t = {k: torch.from_numpy(v) for k, v in o.items()}
    leaves = {k: t[k].clone().requires_grad_(True) for k in GRAD_ARGS}
    meta = BlockMeta(h, dqk, dv, 1.0 / n, 1e-6, num_buckets, rate)
    before = (hstu_block_train.fused_train_block_forward.launches,
              hstu_block_train.attn_backward.launches, hash_dropout.hash_keep_mask.launches)
    out = fused_train_block(leaves["x"], leaves["rel_pos"], leaves["tsw"], leaves["uvqk"],
                            leaves["o_kernel"], leaves["o_bias"], t["colmask"], t["ext"], seed,
                            meta)
    (out * torch.from_numpy(weight)).sum().backward()
    assert (hstu_block_train.fused_train_block_forward.launches,
            hstu_block_train.attn_backward.launches,
            hash_dropout.hash_keep_mask.launches) == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **BLOCK_FWD_TOL)
    for name, want in zip(GRAD_ARGS, want_grads):
        np.testing.assert_allclose(leaves[name].grad.numpy(), np.asarray(want), err_msg=name,
                                   **BLOCK_GRAD_TOL)


def test_fused_train_block_matches_its_autograd_reference():
    """The custom backward (glue + plain attention backward) against autograd
    of the plain forward, on the same dropout mask."""
    o = _block_inputs(b=4, n=19, seed=3)
    meta = BlockMeta(2, 16, 16, 1.0 / 19, 1e-6, 32, 0.2)
    grads = []
    for fn in (fused_train_block, hstu_block_train.fused_train_block_autograd_reference):
        t = {k: torch.from_numpy(v) for k, v in o.items()}
        leaves = {k: t[k].clone().requires_grad_(True) for k in GRAD_ARGS}
        out = fn(leaves["x"], leaves["rel_pos"], leaves["tsw"], leaves["uvqk"],
                 leaves["o_kernel"], leaves["o_bias"], t["colmask"], t["ext"], 77, meta)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        grads.append({k: v.grad for k, v in leaves.items()})
    for name in GRAD_ARGS:
        torch.testing.assert_close(grads[0][name], grads[1][name], rtol=1e-4, atol=1e-6,
                                   msg=name)


def _adamw_tree(seed):
    rng = np.random.default_rng(seed)
    return {"emb": rng.standard_normal((300, 64)).astype(np.float32),
            "w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": rng.standard_normal(8).astype(np.float32)}


@pytest.mark.parametrize("warmup", [False, True], ids=["constant", "warmup"])
def test_adamw_matches_fused_adamw(warmup):
    """The port's AdamW against the JAX fused_adamw (the 300 x 64 leaf through
    the Pallas kernel) over 3 steps: parameters and moments."""
    params = _adamw_tree(1)
    grads = [{k: (0.05 * np.random.default_rng(100 + s).standard_normal(v.shape)).astype(
        np.float32) for k, v in params.items()} for s in range(3)]
    if warmup:
        jax_lr = optax.linear_schedule(1e-4, 1e-3, transition_steps=3)
        port_lr = port_adamw.linear_schedule(1e-4, 1e-3, 3)
    else:
        jax_lr = port_lr = 1e-3
    kw = dict(b1=0.9, b2=0.98, eps=1e-8, weight_decay=1e-3, min_fused_elements=300 * 64)
    opt = fused_adamw(jax_lr, interpret=True, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    popt = port_adamw.FusedAdamW(tp, port_lr, **kw)
    assert popt.fused(300 * 64) and not popt.fused(16 * 8)
    for g in grads:
        updates, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, updates)
        popt.step({k: torch.from_numpy(v) for k, v in g.items()})
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), err_msg=k, **ADAMW_TOL)
            np.testing.assert_allclose(popt.state.mu[k].numpy(), np.asarray(st.mu[k]),
                                       **ADAMW_TOL)
            np.testing.assert_allclose(popt.state.nu[k].numpy(), np.asarray(st.nu[k]),
                                       **ADAMW_TOL)
    assert popt.state.count == int(st.count) == 3
    assert port_adamw.adamw_update_leaves.launches == 0
