"""K4's tensor-core route in the port: the stage plain versions of the bf16
train block (csrc/hstu_block_tc.cuh's TRAIN attention between K1's
projection and output GEMM; csrc/hstu_train_tc.cuh's three backward stages).

The stage plain versions compose bit for bit to the block's plain forward
(`fused_train_block_forward_reference`) and attention backward
(`attn_backward_reference`), per variant and length, through the wrappers'
CPU paths too; their keep masks are the K3 streams; the composition inside
the block's glue matches rails_tpu's `make_fused_train_block` in interpret
mode (value and gradients through `jax.grad`) at the bf16 tolerances of
`test_torch_port_bf16_train.py`; and the route rule is pinned.
"""

import math

import numpy as np
import pytest
import torch

from rails_tpu_torch.core.config import get_experiment_config, list_experiment_configs
from rails_tpu_torch.models.hstu import train_block_meta
from rails_tpu_torch.ops import hstu_block_train as hbt
from rails_tpu_torch.ops.hash_dropout import attn_keep_mask_reference, hash_keep_mask_reference
from rails_tpu_torch.ops.hstu_block import (
    out_gemm,
    out_gemm_reference,
    project,
    project_reference,
)
from tests.test_torch_port_bf16_train import GRAD_TOL as BF16_GRAD_TOL
from tests.test_torch_port_bf16_train import OUT_TOL as BF16_OUT_TOL
from tests.test_torch_port_train_variants import _inputs, _jax_block, _port_block, _share, _weight

# name -> (activation, softmax, concat_ua, bias, o_input rate, attention rate)
VARIANTS = {
    "default": ("silu", False, False, True, 0.2, 0.0),
    "concat_ua": ("silu", False, True, True, 0.2, 0.0),
    "no_bias": ("silu", False, False, False, 0.2, 0.0),
    "attn_dropout": ("silu", False, False, True, 0.2, 0.2),
    "no_dropout": ("silu", False, False, True, 0.0, 0.0),
    "softmax": ("silu", True, False, True, 0.2, 0.0),
    "concat_ua+softmax+attn_dropout": ("silu", True, True, True, 0.2, 0.2),
}
POINTWISE = [k for k, v in VARIANTS.items() if not v[1]]
LENGTHS = (1, 35, 64)
B, D, H, DQK, DV = 3, 32, 2, 8, 8
SEED = 1_234_567


def _meta(name: str, n: int) -> hbt.BlockMeta:
    act, softmax, concat_ua, _, rate, attn_rate = VARIANTS[name]
    return hbt.BlockMeta(H, DQK, DV, 1.0 / n, 1e-6, 128, rate, act, softmax, concat_ua, attn_rate)


def _block_inputs(name: str, n: int, dtype=torch.bfloat16, seed: int = 0):
    """(x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw) in the matmul
    dtype, ragged lengths, the bias tables None without the bias."""
    meta = _meta(name, n)
    rng = np.random.default_rng(seed)
    f = 2 * H * DV + 2 * H * DQK
    lengths = np.array([n, 1, max(1, n // 2)])
    colmask = (np.arange(n)[None, :] < lengths[:, None]).astype(np.float32)
    ts = np.sort(rng.integers(0, 1 << 30, (B, n)), axis=1)
    pos_w = 0.3 * rng.standard_normal(2 * n - 1)
    i, j = np.arange(n)[:, None], np.arange(n)[None, :]
    t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dt)  # noqa: E731
    args = [
        t(rng.standard_normal((B, n, D)) * colmask[..., None], dtype),
        t(colmask),
        t(rng.standard_normal((D, f)) / math.sqrt(D), dtype),
        t(rng.standard_normal((meta.o_width, D)) / math.sqrt(H * DV), dtype),
        t(0.02 * rng.standard_normal(D)),
        t(pos_w[j - i + n - 1]),
        t(np.concatenate([ts, ts[:, n - 1:]], axis=1).astype(np.int32), torch.int32),
        t(0.3 * rng.standard_normal(128)),
    ]
    if not VARIANTS[name][3]:
        args[5] = args[6] = args[7] = None
    return args, meta


def _fwd_by_stages(x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, seed, meta):
    """K1's projection, the train attention stage and K1's output GEMM,
    composed from their plain versions."""
    u, v, q, k = project_reference(x, uvqk, num_heads=meta.num_heads, dqk=meta.dqk, dv=meta.dv,
                                   inv_n=meta.inv_n, eps=meta.eps, activation=meta.activation,
                                   softmax=meta.softmax)
    oin, attn = hbt.train_attention_oinput_reference(u, v, q, k, colmask, rel_pos, ext, tsw, seed,
                                                     meta)
    return out_gemm_reference(oin, o_kernel, o_bias, x), attn


def _bwd_by_stages(y, d_o_in, attn, colmask, rel_pos, ext, tsw, meta, seed=0):
    """The three backward stages composed from their plain versions (the
    pointwise bf16 backward); other instances as the plain attention
    backward."""
    if meta.softmax or y.dtype != torch.bfloat16:
        return hbt.attn_backward_reference(y, d_o_in, attn, colmask, rel_pos, ext, tsw, meta, seed)
    d_y, d_attn, attn = hbt.attn_bwd_rows_reference(y, d_o_in, colmask, rel_pos, ext, tsw, meta,
                                                    seed)
    d_y, dbias = hbt.attn_bwd_dq_reference(y, d_attn, colmask, rel_pos, ext, tsw, meta, seed, d_y)
    return hbt.attn_bwd_dkv_reference(y, d_attn, colmask, rel_pos, ext, tsw, meta, seed,
                                      d_y), dbias, attn


def _bwd_inputs(name: str, n: int, seed: int = 0):
    """The attention backward's (y, d_o_in) as the block's glue hands them
    over in bf16, and the block's other operands."""
    args, meta = _block_inputs(name, n, seed=seed)
    x, colmask, uvqk, o_kernel = args[:4]
    rng = np.random.default_rng(seed + 7)
    z = hbt.ln(x.float(), meta.eps).to(torch.bfloat16).float() @ uvqk.float()
    y = (z * torch.sigmoid(z)).to(torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal((B, n, D)).astype(np.float32))
    d_o = dy.to(torch.bfloat16).float() @ o_kernel.float().T
    if meta.rate > 0.0:
        d_o = d_o * hash_keep_mask_reference(B, n, meta.o_width, SEED, meta.rate, "cpu")
    return y, d_o.to(torch.bfloat16), colmask, args[5:], meta


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_stages_compose_to_the_plain_forward_bit_for_bit(name, n):
    """K1's projection, the train attention stage and K1's output GEMM give
    `fused_train_block_forward_reference`'s output and attn bit for bit, as
    plain versions and through the stage wrappers' CPU paths (the padded vqk
    layout)."""
    args, meta = _block_inputs(name, n)
    want_out, want_attn = hbt.fused_train_block_forward_reference(*args, SEED, meta)
    out, attn = _fwd_by_stages(*args, SEED, meta)
    assert torch.equal(out, want_out) and torch.equal(attn, want_attn)
    x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw = args
    u, vqk = project(x, uvqk, num_heads=H, dqk=DQK, dv=DV, inv_n=meta.inv_n, eps=meta.eps,
                     activation=meta.activation, softmax=meta.softmax)
    oin, attn = hbt.train_attention_oinput(u, vqk, colmask, rel_pos, ext, tsw, SEED, meta)
    assert oin.dtype == torch.bfloat16 and oin.shape == (B, n, meta.o_width)
    assert torch.equal(out_gemm(oin, o_kernel, o_bias, x), want_out)
    assert torch.equal(attn, want_attn)
    assert hbt.train_attention_oinput.launches == 0


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", POINTWISE)
def test_backward_stages_compose_to_the_plain_backward_bit_for_bit(name, n):
    """rows -> dq -> dkv give `attn_backward_reference`'s d_y, dbias and
    recomputed attn bit for bit (bf16 y), as plain versions and through the
    stage wrappers' CPU paths; each stage writes only its own columns of
    d_y."""
    y, d_o, colmask, (rel_pos, ext, tsw), meta = _bwd_inputs(name, n)
    bargs = (colmask, rel_pos, ext, tsw, meta, SEED)
    want_dy, want_db, want_attn = hbt.attn_backward_reference(y, d_o, None, *bargs[:-2], meta,
                                                              SEED)
    got_dy, got_db, got_attn = _bwd_by_stages(y, d_o, None, *bargs[:-2], meta, SEED)
    assert torch.equal(got_dy, want_dy) and torch.equal(got_attn, want_attn)
    assert (got_db is None) == (want_db is None) == (rel_pos is None)
    assert got_db is None or torch.equal(got_db, want_db)
    hdv, hq = H * DV, H * DQK
    d_y, d_attn, attn = hbt.attn_bwd_rows(y, d_o, *bargs)
    assert d_attn.dtype == torch.bfloat16 and torch.equal(attn, want_attn)
    assert torch.equal(d_y[..., :hdv], want_dy[..., :hdv]) and not d_y[..., hdv:].any()
    d_y, dbias = hbt.attn_bwd_dq(y, d_attn, *bargs, d_y=d_y)
    assert dbias is None or torch.equal(dbias, want_db)
    assert torch.equal(d_y[..., 2 * hdv:2 * hdv + hq], want_dy[..., 2 * hdv:2 * hdv + hq])
    d_y = hbt.attn_bwd_dkv(y, d_attn, *bargs, d_y=d_y)
    assert torch.equal(d_y, want_dy)
    assert hbt.attn_bwd_rows.launches == hbt.attn_bwd_dq.launches == hbt.attn_bwd_dkv.launches == 0


@pytest.mark.parametrize("name", ["attn_dropout", "concat_ua+softmax+attn_dropout"])
def test_stage_keep_masks_are_the_k3_streams(name):
    """The masks the stages apply, read off their outputs: with v one-hot
    over the keys (dv >= n) the train attention stage's attn row i of head h
    holds the rounded weights a_h[i, :], which are 0 exactly where the
    attention keep mask (`attn_keep_mask_reference`; head 0 under softmax)
    drops a nonzero weight; with o_input dropout alone o_input is 0 where its
    keep mask (`hash_keep_mask_reference`) drops a nonzero value; the
    backward's first stage recomputes the same weights."""
    n, h = 6, 2
    dv = dqk = 8
    _, softmax, concat_ua, _, rate, attn_rate = VARIANTS[name]
    off = hbt.BlockMeta(h, dqk, dv, 1.0 / n, 1e-6, 128, 0.0, "silu", softmax, concat_ua, 0.0)
    meta, o_only = off._replace(attn_rate=attn_rate), off._replace(rate=rate)
    g = torch.Generator().manual_seed(5)
    u = torch.randn(B, n, h * dv, generator=g)
    q, k = (torch.randn(B, n, h * dqk, generator=g).bfloat16() for _ in range(2))
    v = torch.zeros(B, n, h, dv)
    v[:, torch.arange(n), :, torch.arange(n)] = 1.0
    v = v.reshape(B, n, h * dv).bfloat16()
    colmask = torch.ones(B, n)
    run = lambda m: hbt.train_attention_oinput_reference(  # noqa: E731
        u, v, q, k, colmask, None, None, None, SEED, m)
    (_, attn_d), (oin_d, _), (oin_0, attn_0) = run(meta), run(o_only), run(off)
    heads = 1 if softmax else h
    keep = attn_keep_mask_reference(B, n, heads, SEED, attn_rate, "cpu")
    a_d = attn_d.reshape(B, n, h, dv)[..., :n].permute(0, 2, 1, 3)   # (B, h, i, j)
    a_0 = attn_0.reshape(B, n, h, dv)[..., :n].permute(0, 2, 1, 3)
    live = a_0 != 0
    assert live.float().mean() > 0.3
    assert torch.equal((a_d == 0) & live, (keep.expand_as(a_0) == 0) & live)
    o_keep = hash_keep_mask_reference(B, n, off.o_width, SEED, rate, "cpu")
    o_live = oin_0 != 0
    assert torch.equal((oin_d == 0) & o_live, (o_keep == 0) & o_live)
    if not softmax:
        y = torch.cat([u, (v.float() / meta.inv_n).bfloat16().float(), q.float(), k.float()],
                      dim=-1).bfloat16()
        d_o = torch.ones(B, n, meta.o_width).bfloat16()
        _, _, attn_b = hbt.attn_bwd_rows_reference(y, d_o, colmask, None, None, None, meta, SEED)
        a_b = attn_b.reshape(B, n, h, dv)[..., :n].permute(0, 2, 1, 3)
        assert torch.equal((a_b == 0) & live, (keep == 0) & live)


@pytest.mark.parametrize("name", ["concat_ua", "no_bias", "attn_dropout", "softmax",
                                  "concat_ua+softmax"])
def test_stage_composition_in_the_block_matches_pallas(name, monkeypatch):
    """The block's glue over the stage compositions (forward and, pointwise,
    backward) against make_fused_train_block in interpret mode at the
    variants of `test_torch_port_train_variants.py` (h=2, dqk=dv=16), bf16 x,
    uvqk and o_kernel: the forward within OUT_TOL and each gradient within
    GRAD_TOL of its largest value (`test_torch_port_bf16_train.py`)."""
    monkeypatch.setattr(hbt, "fused_train_block_forward", _fwd_by_stages)
    monkeypatch.setattr(hbt, "attn_backward", _bwd_by_stages)
    o, w = _inputs(name, seed=3), _weight()
    want_out, want = _jax_block(name, o, w, bf16=True)
    got_out, got = _port_block(name, o, w, bf16=True)
    assert _share(got_out, want_out) <= BF16_OUT_TOL
    for k in want:
        assert _share(got[k], want[k]) <= BF16_GRAD_TOL, k


def test_route_rule():
    """The tensor-core routes at every registry config's train block: bf16
    with the SiLU projection at K1's tensor-core widths; the backward also
    needs the pointwise attention. f32 never takes them."""
    for name in list_experiment_configs():
        cfg = get_experiment_config(name)
        c = cfg.hstu
        meta = train_block_meta(c, cfg.max_seq_len_padded)
        fits = (c.linear_activation == "silu" and c.embedding_dim <= 256 and c.dqk <= 32
                and c.dv <= 32 and (c.num_heads <= 3 or (c.num_heads % 2 == 0
                                                         and c.num_heads <= 8)))
        assert hbt.tc_fwd_route(torch.bfloat16, c.embedding_dim, meta) == fits, name
        assert hbt.tc_bwd_route(torch.bfloat16, meta) == (fits and not meta.softmax), name
        assert not hbt.tc_fwd_route(torch.float32, c.embedding_dim, meta)
        assert not hbt.tc_bwd_route(torch.float32, meta)
    base = train_block_meta(get_experiment_config("ml-20m-hstu-mol").hstu, 211)
    assert hbt.tc_fwd_route(torch.bfloat16, 256, base) and hbt.tc_bwd_route(torch.bfloat16, base)
    for change, fwd, bwd in ((dict(softmax=True), True, False),
                             (dict(activation="none"), False, False),
                             (dict(num_heads=4, dqk=64, dv=64), False, False),
                             (dict(num_heads=5), False, False),
                             (dict(num_heads=3, dqk=25, dv=25), True, True),
                             (dict(concat_ua=True, attn_rate=0.2), True, True)):
        meta = base._replace(**change)
        assert hbt.tc_fwd_route(torch.bfloat16, 256, meta) == fwd, change
        assert hbt.tc_bwd_route(torch.bfloat16, meta) == bwd, change
    assert not hbt.tc_fwd_route(torch.bfloat16, 320, base)
