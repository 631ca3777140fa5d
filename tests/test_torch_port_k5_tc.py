"""K5's tensor-core route on the CPU: its tile decomposition and its width rule.

`csrc/mol_loss_tc.cuh` computes the fused MoL loss's backward as GEMMs over
tiles of 8 queries x 16 negatives, on the MLP axis kappa = mx * 8 + n, with
JAX's bf16 rounding points. `tile_backward` below is that decomposition in
plain PyTorch (the same tiles, products and rounding points, f32 sums in
PyTorch's order). It is held to the port's plain backward
(`fused_mol_loss_backward_reference`) and to `make_fused_mol_loss` in Pallas
interpret mode, and seeded faults in it (two W2 rows swapped, one mask bit
flipped) must leave those tolerances. The CUDA kernel itself runs only on a
card (`tests/test_torch_port_gpu.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rails_tpu.ops.pallas.mol_loss_train import make_fused_mol_loss
from rails_tpu.ops.pallas.mol_scoring import MoLKernelWeights
from rails_tpu_torch.ops import mol_loss_train as mlt
from rails_tpu_torch.ops.hash_dropout import PI_SALT, QI_SALT

TEMP, EPS, SEED = 0.05, 1e-6, 4321
QT, RT = 8, 16            # the kernel's tile: queries (one per warp) x negatives (mma rows)
NAMES = ("q_comp", "qp", "item_comp", "ip", "w1", "b1", "w2", "b2")
# Tile sums against the plain version's, max|err| over max|plain| of the
# forward and of each gradient: f32 sums in other orders, bf16 the same
# rounding points with other sum orders (as the kernel is held on the card).
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 3e-2)}


def logit_of(p_x: int) -> torch.Tensor:
    """(L,) the n-major logit l = n * P_X + mx at each kappa = mx * 8 + n."""
    k = torch.arange(8 * p_x)
    return (k % 8) * p_x + k // 8


def tile_backward(q, qp, item, ip, w1, b1, w2, b2, seed, d_out, *, p_x, qi_rate, pi_rate,
                  fault=None):
    """The forward and the 8 gradients as the tensor-core route computes them,
    tile by tile: (out, grads) in the operands' dtypes. `fault`: None,
    "w2_rows_swapped" or "pi_mask_bit_flipped" (the kept logit of largest
    softmax weight dropped)."""
    bf16 = item.dtype == torch.bfloat16

    def rnd(x):
        return x.to(torch.bfloat16).float() if bf16 else x

    m_all, r_all, d_p = q.shape[0], item.shape[0], q.shape[2]
    l = 8 * p_x
    lk = logit_of(p_x)
    inv_t = 1.0 / TEMP
    masks = {}
    for name, salt, rate in (("qi", QI_SALT, qi_rate), ("pi", PI_SALT, pi_rate)):
        mk = (mlt.loss_mask(seed, salt, m_all, r_all, 8, p_x, rate, "cpu") if rate > 0
              else torch.ones(m_all, r_all, l))
        masks[name] = mk[..., lk].contiguous()
    w2f = w2.float()
    if fault == "w2_rows_swapped":
        w2f = w2f[[1, 0] + list(range(2, w2f.shape[0]))]
    w1k, w2k = rnd(w1.float())[lk], rnd(w2f)[:, lk]          # (kappa, H), (H, kappa)
    b1f, b2k = b1.float()[0], b2.float()[0, lk]
    qpk, ipk = qp.float()[:, lk], ip.float()[:, lk]
    if fault == "pi_mask_bit_flipped":
        f = mlt._forward_parts(q, qp, item, ip, w1, b1, w2, b2, seed, p_q=8, p_x=p_x,
                               temperature=TEMP, qi_rate=qi_rate, pi_rate=pi_rate, eps=EPS)
        pk = f["p"][..., lk]
        at = torch.argmax(torch.where(masks["pi"] > 0, pk, -1.0))
        masks["pi"].view(-1)[at] = 0.0
    out = torch.zeros(m_all, r_all)
    dq, dqp = torch.zeros(m_all, 8, d_p), torch.zeros(m_all, l)
    ditem, dip = torch.zeros(r_all, p_x, d_p), torch.zeros(r_all, l)
    dw1, dw2 = torch.zeros(l, w1.shape[1]), torch.zeros(w1.shape[1], l)
    db1, db2 = torch.zeros(w1.shape[1]), torch.zeros(l)
    for q0 in range(0, m_all, QT):
        qt = q[q0:q0 + QT].float()                               # (mq, 8, d_P)
        mq = qt.shape[0]
        for r0 in range(0, r_all, RT):
            it = item[r0:r0 + RT].float()                        # (rr, P_X, d_P)
            rr = it.shape[0]
            mqi = masks["qi"][q0:q0 + mq, r0:r0 + rr].reshape(-1, l)
            mpi = masks["pi"][q0:q0 + mq, r0:r0 + rr].reshape(-1, l)
            # 1. Row pass, rows = pairs (m, r), columns kappa.
            t = torch.einsum("mnd,rxd->mrxn", qt, it).reshape(-1, l) * inv_t
            t_in = rnd(t * mqi)
            z = t_in @ w1k + b1f
            h = rnd(F.silu(z))
            gi = (qpk[q0:q0 + mq, None] * ipk[None, r0:r0 + rr]).reshape(-1, l) + (h @ w2k + b2k)
            p = torch.softmax(F.silu(gi), dim=-1)
            q_w = p * mpi
            s = torch.clamp(q_w.sum(-1), min=EPS) if pi_rate > 0 else torch.ones(len(p))
            st = (q_w * t).sum(-1)
            out[q0:q0 + mq, r0:r0 + rr] = (st / s).reshape(mq, rr)
            dout = d_out[q0:q0 + mq, r0:r0 + rr].reshape(-1)
            a = dout / s
            corr = torch.where((s > EPS) & (pi_rate > 0), dout * (st / s) / s, torch.zeros(()))
            dp = (a[:, None] * t - corr[:, None]) * mpi
            dot = (dp * p).sum(-1, keepdim=True)
            sg = torch.sigmoid(gi)
            d_gi = p * (dp - dot) * (sg * (1.0 + gi * (1.0 - sg)))
            dtd = a[:, None] * p * mpi
            d_qi = rnd(d_gi)
            # 2. f32 reductions of d_gi.
            g3 = d_gi.reshape(mq, rr, l)
            dqp[q0:q0 + mq] += (g3 * ipk[None, r0:r0 + rr]).sum(1)
            dip[r0:r0 + rr] += (g3 * qpk[q0:q0 + mq, None]).sum(0)
            db2 += d_gi.sum(0)
            # 3. Chunk pass: dH, d_z, and the weight sums over the tile's pairs.
            sz = torch.sigmoid(z)
            d_z = (d_qi @ w2k.T) * (sz * (1.0 + z * (1.0 - sz)))
            d_zr = rnd(d_z)
            dw1 += t_in.T @ d_zr
            dw2 += h.T @ d_qi
            db1 += d_z.sum(0)
            # 4. Row pass: d_t into rows (m, n), columns (mx, r).
            d_t = rnd((dtd + (d_zr @ w1k.T) * mqi) * inv_t)
            dt = d_t.reshape(mq, rr, p_x, 8).permute(0, 3, 2, 1).reshape(mq * 8, p_x * rr)
            # 5. dq and d_item as block GEMMs.
            irows = it.permute(1, 0, 2).reshape(p_x * rr, d_p)
            dq[q0:q0 + mq] += (dt @ irows).reshape(mq, 8, d_p)
            ditem[r0:r0 + rr] += (dt.T @ qt.reshape(mq * 8, d_p)).reshape(p_x, rr, d_p).permute(
                1, 0, 2)
    back = torch.argsort(lk)                                     # kappa of each n-major l
    grads = (dq, dqp[:, back], ditem, dip[:, back], dw1[back], db1[None], dw2[:, back],
             db2[back][None])
    return out, tuple(g.to(x.dtype) for g, x in zip(grads, (q, qp, item, ip, w1, b1, w2, b2)))


def _inputs(m, r, p_x, d_p, h, dtype, seed):
    rng = np.random.default_rng(seed)
    l = 8 * p_x

    def normal(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    q, it = normal(m, 8, d_p), normal(r, p_x, d_p)
    q, it = q / q.norm(dim=-1, keepdim=True), it / it.norm(dim=-1, keepdim=True)
    ops = [q, normal(m, l), it, normal(r, l)]
    return ([x.to(dtype) for x in ops] + [normal(l, h, scale=l ** -0.5), normal(1, h, scale=0.1),
                                          normal(h, l, scale=h ** -0.5), normal(1, l, scale=0.1)],
            normal(m, r))


def _shares(got, want):
    def share(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()
    return [share(a, b) for a, b in zip(got, want)]


def _reference(args, cot, p_x, qi_rate, pi_rate):
    kw = dict(p_q=8, p_x=p_x, temperature=TEMP, qi_rate=qi_rate, pi_rate=pi_rate, eps=EPS)
    return (mlt.fused_mol_loss_forward_reference(*args, SEED, **kw),
            mlt.fused_mol_loss_backward_reference(*args, SEED, cot, **kw))


CASES = [(p_x, dtype, rates) for p_x in (4, 8) for dtype in (torch.float32, torch.bfloat16)
         for rates in ((0.0, 0.0), (0.2, 0.1))]


@pytest.mark.parametrize("p_x,dtype,rates", CASES,
                         ids=[f"8x{c[0]}-{str(c[1])[6:]}-pi{c[2][0]}-qi{c[2][1]}" for c in CASES])
def test_tile_decomposition_matches_the_plain_backward(p_x, dtype, rates):
    """Ragged tiles (M = 19: groups of 8, 8, 3; R = 37: tiles of 16, 16, 5)
    at both dropout settings: the forward and every gradient within TOL of
    the plain versions, gradients in the operands' dtypes."""
    pi_rate, qi_rate = rates
    args, cot = _inputs(19, 37, p_x, 16, 32, dtype, seed=p_x)
    out, grads = tile_backward(*args, SEED, cot, p_x=p_x, qi_rate=qi_rate, pi_rate=pi_rate)
    want_out, want_grads = _reference(args, cot, p_x, qi_rate, pi_rate)
    fwd_tol, grad_tol = TOL[dtype]
    assert _shares([out], [want_out])[0] <= fwd_tol
    shares = _shares(grads, want_grads)
    for name, a, b, x, sh in zip(NAMES, grads, want_grads, args, shares):
        assert a.dtype == b.dtype == x.dtype and a.shape == b.shape, name
        assert sh <= grad_tol, (name, sh)


@pytest.mark.parametrize("p_x", [4, 8])
@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.2, 0.1)], ids=["rate0", "dropout"])
def test_tile_decomposition_matches_pallas(p_x, rates):
    """The f32 tile decomposition against `make_fused_mol_loss` in interpret
    mode (`block_q=8`, the same hash masks): the forward to 1e-4 and every
    gradient to 1e-3 of its largest value."""
    pi_rate, qi_rate = rates
    args, cot = _inputs(11, 21, p_x, 16, 32, torch.float32, seed=10 + p_x)
    out, grads = tile_backward(*args, SEED, cot, p_x=p_x, qi_rate=qi_rate, pi_rate=pi_rate)
    fused = make_fused_mol_loss(p_q=8, p_x=p_x, temperature=TEMP, softmax_dropout_rate=pi_rate,
                                qi_dropout_rate=qi_rate, eps=EPS, block_q=8, interpret=True)
    jcot = jnp.asarray(cot.numpy())

    def loss(q, qp, it, ip, w1, b1, w2, b2):
        o = fused(q, qp, it, ip, MoLKernelWeights(w1, b1, w2, b2), jnp.int32(SEED))
        return jnp.sum(o * jcot), o

    (_, jout), jgrads = jax.value_and_grad(loss, argnums=tuple(range(8)), has_aux=True)(
        *(jnp.asarray(a.numpy()) for a in args))
    want = [torch.from_numpy(np.array(g)) for g in jgrads]
    assert _shares([out], [torch.from_numpy(np.array(jout))])[0] <= 1e-4
    for name, sh in zip(NAMES, _shares(grads, want)):
        assert sh <= 1e-3, (name, sh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fault", ["w2_rows_swapped", "pi_mask_bit_flipped"])
def test_tile_decomposition_faults_leave_the_tolerance(fault, dtype):
    """A seeded fault in the tile decomposition (W2's rows 0 and 1 swapped, or
    the pi mask's kept logit of largest softmax weight dropped) puts the
    forward or a gradient outside TOL of the plain versions."""
    args, cot = _inputs(19, 37, 8, 16, 32, dtype, seed=3)
    out, grads = tile_backward(*args, SEED, cot, p_x=8, qi_rate=0.1, pi_rate=0.2, fault=fault)
    want_out, want_grads = _reference(args, cot, 8, 0.1, 0.2)
    fwd_tol, grad_tol = TOL[dtype]
    shares = _shares([out] + list(grads), [want_out] + list(want_grads))
    assert shares[0] > fwd_tol or max(shares[1:]) > grad_tol, shares


ROUTE_CASES = [
    # (dtype, P_Q, P_X, d_P, H, takes the tensor cores)
    (torch.float32, 8, 4, 128, 128, True),      # ml-20m-hstu-mol-fast
    (torch.float32, 8, 4, 64, 128, True),       # ml-1m-hstu-mol-fast
    (torch.bfloat16, 8, 8, 32, 128, True),      # amzn-books-hstu-mol-fast
    (torch.bfloat16, 8, 4, 128, 128, True),     # ML-20M's geometry with bf16 operands
    (torch.bfloat16, 8, 8, 128, 16, True),      # the largest bf16 d_P, the smallest H
    (torch.float32, 8, 4, 8, 16, True),         # the smallest f32 d_P (staged to 16)
    (torch.float32, 8, 4, 120, 64, True),       # f32 d_P a multiple of 8
    (torch.bfloat16, 8, 4, 120, 128, False),    # bf16 d_P not a multiple of 16
    (torch.float32, 8, 4, 12, 128, False),      # f32 d_P not a multiple of 8
    (torch.float32, 8, 8, 32, 128, False),      # f32 at P_X = 8: over 232,448 B of shared memory
    (torch.float32, 8, 4, 136, 128, False),     # d_P above 128
    (torch.float32, 8, 4, 128, 144, False),     # H above 128: more chunks than warps
    (torch.float32, 8, 4, 128, 24, False),      # H not a multiple of 16 (the GPU tests' 24)
    (torch.bfloat16, 8, 8, 32, 0, False),
    (torch.float32, 4, 2, 16, 24, False),       # synthetic-small's 4x2x16
    (torch.bfloat16, 4, 2, 16, 32, False),      # P_Q = 4: half an n8 tile
    (torch.float32, 8, 2, 64, 128, False),      # P_X = 2: L = 16 is not a supported group
    (torch.float16, 8, 4, 128, 128, False),     # no f16 instance
]


@pytest.mark.parametrize("dtype,p_q,p_x,d_p,hd,want", ROUTE_CASES)
def test_tc_route_rule(dtype, p_q, p_x, d_p, hd, want):
    assert mlt.tc_route(dtype, p_q, p_x, d_p, hd) is want
