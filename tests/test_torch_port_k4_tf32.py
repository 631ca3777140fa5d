"""K4's f32 route on the tensor cores, on the CPU: its tile decomposition,
its stages' plain versions and its route rule.

`csrc/hstu_train_tf32.cuh` runs every product of the f32 train block as
3xTF32 on mma.sync: each operand split into hi (its int32 view with the 13 low
mantissa bits cleared) and lo = x - hi, which the tensor core reads truncated
to TF32 as well, and the product summed as lo.hi + hi.lo + hi.hi. Below,
`tile_forward` and `tile_backward` are that decomposition in plain PyTorch:
the projection and the output GEMM as split products, the attention over the
same row tiles (64 rows up to n = 256, 32 past it: `rows_of`), heads in
order, 128-column blocks of four 32-column warp tiles whose partial sums are
added in warp order, the bias block with the mask as a -1e30 penalty, dbias
summed over the heads in head order. They are held to the port's plain
forward and attention backward and to `make_fused_train_block` in Pallas
interpret mode, and seeded faults in them (two k rows swapped, one mask bit
flipped, the lo terms dropped, that is 1xTF32) must leave the tolerance;
also at the widths the route took on for the rated and combined
preprocessors (`WIDE`: a D that is no multiple of 16, an n past 256). The
CUDA kernels themselves run only on a card (`tests/test_torch_port_gpu.py`).
"""

import math

import numpy as np
import pytest
import torch

from rails_tpu_torch.core.config import get_experiment_config, list_experiment_configs
from rails_tpu_torch.models.hstu import train_block_meta
from rails_tpu_torch.ops import hstu_block_train as hbt
from rails_tpu_torch.ops.hash_dropout import attn_keep_mask_reference, hash_keep_mask_reference
from tests.test_torch_port_train_kernels import BLOCK_FWD_TOL, BLOCK_GRAD_TOL
from tests.test_torch_port_train_variants import _jax_block, _port_block, _weight

TILE, COL_WARPS = 32, 4                # the kernels' column warp tiles
BLOCK = TILE * COL_WARPS               # columns staged at a time
MASK = -1e30                           # the bias of a masked pair
B, D, H, DQK, DV = 3, 32, 2, 16, 16
# (B, D, h, dqk, dv) and n past the old edges of the route: D = 40 pads to the
# projection's 32-deep chunks, n = 300 > 256 takes 32-row attention blocks.
WIDE, WIDE_N = (1, 40, 2, 8, 8), 300
SEED = 1_234_567
# name -> (bias, o_input rate, attention rate, concat_ua)
VARIANTS = {
    "default": (True, 0.2, 0.0, False),
    "no_bias": (False, 0.2, 0.0, False),
    "attn_dropout": (True, 0.2, 0.2, False),
    "concat_ua": (True, 0.2, 0.0, True),
    "no_dropout": (True, 0.0, 0.0, False),
}
LENGTHS = (1, 35, 150)   # one row tile; two; three row tiles and two column blocks
# The decomposition against the plain versions, max |err| over max |plain| per
# output: 3xTF32 keeps each product within ~2^-19 of f32, and the sums run in
# other f32 orders (measured below 3e-6). 1xTF32 misses it by ~100x.
TOL = 2e-5
FAULTS = ("k_rows_swapped", "mask_bit_flipped", "lo_dropped")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x truncated to TF32: its int32 view with the 13 low mantissa bits
    cleared."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def mm3(a: torch.Tensor, b: torch.Tensor, fault=None) -> torch.Tensor:
    """a @ b as 3xTF32: hi = tf32(x), lo = x - hi read as tf32(lo);
    lo.hi + hi.lo, then + hi.hi; 1xTF32 (hi.hi) with the lo terms dropped."""
    ah, bh = tf32(a), tf32(b)
    if fault == "lo_dropped":
        return ah @ bh
    return (tf32(a - ah) @ bh + ah @ tf32(b - bh)) + ah @ bh


def rows_of(n: int) -> int:
    """The attention kernels' row block at length n (`block_rows`,
    csrc/hstu_train_tf32.cuh): 64 up to n = 256, 32 past it."""
    return 64 if n <= 256 else 32


def sigma_slope(s: torch.Tensor):
    """sigma(s) and silu'(s) as `sigma_and_slope` computes them: 0 and -0 at
    the penalty."""
    masked = s < 0.5 * MASK
    sig = torch.where(masked, torch.zeros_like(s), 1.0 / (1.0 + torch.exp(-s)))
    deriv = torch.where(masked, torch.full_like(s, -0.0), sig * (1.0 + s * (1.0 - sig)))
    return sig, deriv


def _parts(y: torch.Tensor, meta: hbt.BlockMeta):
    """(u, v / max_seq_len, q, k), heads split: (B, n, h, d)."""
    b, n, _ = y.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    hdv, hq = h * dv, h * dqk
    return (y[..., :hdv], (y[..., hdv:2 * hdv] * meta.inv_n).reshape(b, n, h, dv),
            y[..., 2 * hdv:2 * hdv + hq].reshape(b, n, h, dqk), y[..., 2 * hdv + hq:].reshape(b, n, h, dqk))


def _bias_block(colmask, rel_pos, ext, tsw, meta, fault):
    """(B, n, n) of every (query, key): the bias of a causal, valid pair, else
    the penalty; with the fault one valid pair masked."""
    bias = hbt._bias(rel_pos, ext, tsw, meta.num_buckets) if rel_pos is not None else 0.0
    mask = hbt._mask(colmask)
    out = torch.where(mask > 0, bias + torch.zeros_like(mask), torch.full_like(mask, MASK))
    if fault == "mask_bit_flipped":
        n = colmask.shape[1]
        out[0, n - 1, 0] = MASK
    return out


def _keep(b, n, seed, meta):
    return (attn_keep_mask_reference(b, n, meta.num_heads, seed, meta.attn_rate, "cpu")
            if meta.attn_rate > 0.0 else None)


def _k_tile(k, bb, keys, hd, first, fault):
    kk = k[bb, keys, hd]
    if fault == "k_rows_swapped" and first and kk.shape[0] > 1:
        kk = kk[[1, 0] + list(range(2, kk.shape[0]))]
    return kk


def tile_attention(y, colmask, rel_pos, ext, tsw, seed, meta, fault=None):
    """attn (B, n, h*dv) as `tc_tf32_attn_kernel` tiles it."""
    b, n, _ = y.shape
    h, dv = meta.num_heads, meta.dv
    _, v, q, k = _parts(y, meta)
    bias, keep = _bias_block(colmask, rel_pos, ext, tsw, meta, fault), _keep(b, n, seed, meta)
    attn = torch.zeros(b, n, h * dv)
    rb = rows_of(n)
    for bb in range(b):
        for i0 in range(0, n, rb):
            rows, jmax = slice(i0, min(i0 + rb, n)), min(i0 + rb, n)
            for hd in range(h):
                part = [torch.zeros(rows.stop - i0, dv) for _ in range(COL_WARPS)]
                for kb in range(0, jmax, BLOCK):
                    for wc in range(COL_WARPS):
                        j0 = kb + wc * TILE
                        if j0 >= jmax:
                            continue
                        keys = slice(j0, min(j0 + TILE, jmax))
                        kk = _k_tile(k, bb, keys, hd, (bb, i0, hd, j0) == (0, 0, 0, 0), fault)
                        s = mm3(q[bb, rows, hd], kk.T, fault) + bias[bb, rows, keys]
                        a = s * sigma_slope(s)[0]
                        if keep is not None:
                            a = a * keep[bb, hd, rows, keys]
                        part[wc] = part[wc] + mm3(a, v[bb, keys, hd], fault)
                attn[bb, rows, hd * dv:(hd + 1) * dv] = ((part[0] + part[1]) + part[2]) + part[3]
    return attn


def tile_forward(x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, seed, meta, fault=None):
    """(out, attn) of the f32 route's three launches: y = SiLU(LN(x) @ uvqk)
    as a split product, the tiled attention, o_input times its keep mask @ Wo
    as a split product, + bo + x."""
    b, n, _ = x.shape
    z = mm3(hbt.ln(x, meta.eps), uvqk, fault)
    y = z / (1.0 + torch.exp(-z))
    attn = tile_attention(y, colmask, rel_pos, ext, tsw, seed, meta, fault)
    u, a_ln = y[..., :meta.num_heads * meta.dv], hbt.ln(attn, meta.eps)
    o_in = torch.cat([u, a_ln, u * a_ln], dim=-1) if meta.concat_ua else a_ln * u
    if meta.rate > 0.0:
        o_in = o_in * hash_keep_mask_reference(b, n, meta.o_width, seed, meta.rate, "cpu")
    return mm3(o_in, o_kernel, fault) + o_bias + x, attn


def tile_backward(y, d_o_in, attn, colmask, rel_pos, ext, tsw, meta, seed=0, fault=None):
    """(d_y, dbias or None, attn) of the f32 route's backward: the rows stage
    (no products), then d_q and dbias per block of query rows as
    `tc_tf32_dq_kernel` tiles them, d_k and d_v per block of key rows as
    `tc_tf32_dkv_kernel` does (its query blocks start at the block's first
    key)."""
    b, n, _ = y.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    hdv, hq = h * dv, h * dqk
    d_y, d_attn = hbt.tf32_bwd_rows_reference(y, d_o_in, attn, meta)
    _, v, q, k = _parts(y, meta)
    da = d_attn.reshape(b, n, h, dv)
    bias, keep = _bias_block(colmask, rel_pos, ext, tsw, meta, fault), _keep(b, n, seed, meta)
    dbias = torch.zeros(b, n, n)
    rb = rows_of(n)
    for bb in range(b):
        for i0 in range(0, n, rb):
            rows, jmax = slice(i0, min(i0 + rb, n)), min(i0 + rb, n)
            db = torch.zeros(rows.stop - i0, jmax)
            for hd in range(h):
                part = [torch.zeros(rows.stop - i0, dqk) for _ in range(COL_WARPS)]
                for kb in range(0, jmax, BLOCK):
                    for wc in range(COL_WARPS):
                        j0 = kb + wc * TILE
                        if j0 >= jmax:
                            continue
                        keys = slice(j0, min(j0 + TILE, jmax))
                        kk = _k_tile(k, bb, keys, hd, (bb, i0, hd, j0) == (0, 0, 0, 0), fault)
                        s = mm3(q[bb, rows, hd], kk.T, fault) + bias[bb, rows, keys]
                        d_a = mm3(da[bb, rows, hd], v[bb, keys, hd].T, fault)
                        if keep is not None:
                            d_a = d_a * keep[bb, hd, rows, keys]
                        ds = d_a * sigma_slope(s)[1]
                        db[:, keys] = db[:, keys] + ds
                        part[wc] = part[wc] + mm3(ds, kk, fault)
                d_y[bb, rows, 2 * hdv + hd * dqk:2 * hdv + (hd + 1) * dqk] = (
                    ((part[0] + part[1]) + part[2]) + part[3])
            dbias[bb, rows, :jmax] = db
        for j0 in range(0, n, rb):
            keys = slice(j0, min(j0 + rb, n))
            for hd in range(h):
                pk = [torch.zeros(keys.stop - j0, dqk) for _ in range(COL_WARPS)]
                pv = [torch.zeros(keys.stop - j0, dv) for _ in range(COL_WARPS)]
                for qb in range(j0, n, BLOCK):
                    for wc in range(COL_WARPS):
                        q0 = qb + wc * TILE
                        if q0 >= n:
                            continue
                        queries = slice(q0, min(q0 + TILE, n))
                        qq = q[bb, queries, hd]
                        s_t = mm3(k[bb, keys, hd], qq.T, fault) + bias[bb, queries, keys].T
                        d_a_t = mm3(v[bb, keys, hd], da[bb, queries, hd].T, fault)
                        sig, deriv = sigma_slope(s_t)
                        a_t = s_t * sig
                        if keep is not None:
                            kp = keep[bb, hd, queries, keys].T
                            a_t, d_a_t = a_t * kp, d_a_t * kp
                        pk[wc] = pk[wc] + mm3(d_a_t * deriv, qq, fault)
                        pv[wc] = pv[wc] + mm3(a_t, da[bb, queries, hd], fault)
                cols_k = slice(2 * hdv + hq + hd * dqk, 2 * hdv + hq + (hd + 1) * dqk)
                d_y[bb, keys, cols_k] = ((pk[0] + pk[1]) + pk[2]) + pk[3]
                d_y[bb, keys, hdv + hd * dv:hdv + (hd + 1) * dv] = (
                    (((pv[0] + pv[1]) + pv[2]) + pv[3]) * meta.inv_n)
    return d_y, dbias if rel_pos is not None else None, attn


def _meta(name: str, n: int, geom: tuple = (B, D, H, DQK, DV)) -> hbt.BlockMeta:
    _, rate, attn_rate, concat_ua = VARIANTS[name]
    _, _, h, dqk, dv = geom
    return hbt.BlockMeta(h, dqk, dv, 1.0 / max(n, 2), 1e-6, 128, rate, "silu", False, concat_ua,
                         attn_rate)


def _inputs(name: str, n: int, seed: int = 0, geom: tuple = (B, D, H, DQK, DV)):
    """(x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw) f32 at geometry
    (B, D, h, dqk, dv), ragged lengths (the first user's whole), the bias
    tables None without the bias; and the block's meta."""
    meta = _meta(name, n, geom)
    b, d, h, dqk, dv = geom
    rng = np.random.default_rng(seed)
    f = 2 * h * dv + 2 * h * dqk
    lengths = np.array([n, 1, max(1, n // 2)])[:b]
    colmask = (np.arange(n)[None, :] < lengths[:, None]).astype(np.float32)
    ts = np.sort(rng.integers(0, 1 << 30, (b, n)), axis=1)
    pos_w = 0.3 * rng.standard_normal(2 * n - 1)
    i, j = np.arange(n)[:, None], np.arange(n)[None, :]
    t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dt)  # noqa: E731
    args = [t(rng.standard_normal((b, n, d)) * colmask[..., None]), t(colmask),
            t(rng.standard_normal((d, f)) / math.sqrt(d)),
            t(rng.standard_normal((meta.o_width, d)) / math.sqrt(h * dv)),
            t(0.02 * rng.standard_normal(d)), t(pos_w[j - i + n - 1]),
            t(np.concatenate([ts, ts[:, n - 1:]], axis=1).astype(np.int32), torch.int32),
            t(0.3 * rng.standard_normal(128))]
    if not VARIANTS[name][0]:
        args[5] = args[6] = args[7] = None
    return args, meta


def _bwd_operands(args, meta, seed: int = 0):
    """y (the plain projection), d(o_input) with its keep mask, attn (the
    plain forward's)."""
    x, colmask, uvqk = args[:3]
    y = hbt.tf32_project_reference(x, uvqk, meta)
    b, n, _ = x.shape
    d_o = torch.from_numpy(np.random.default_rng(seed + 7).standard_normal(
        (b, n, meta.o_width)).astype(np.float32))
    if meta.rate > 0.0:
        d_o = d_o * hash_keep_mask_reference(b, n, meta.o_width, SEED, meta.rate, "cpu")
    attn = hbt.tf32_attention_reference(y, colmask, *args[5:], SEED, meta)
    return y, d_o, attn


def _share(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _shares(name: str, n: int, fault=None, geom: tuple = (B, D, H, DQK, DV)) -> dict:
    """max |err| / max |plain| of the decomposition's forward (out, attn)
    and backward (each d_y column group, dbias) against the plain versions."""
    args, meta = _inputs(name, n, geom=geom)
    want_out, want_attn = hbt.fused_train_block_forward_reference(*args, SEED, meta)
    out, attn = tile_forward(*args, SEED, meta, fault=fault)
    y, d_o, attn_p = _bwd_operands(args, meta)
    bargs = (args[1], *args[5:], meta, SEED)
    want_dy, want_db, _ = hbt.attn_backward_reference(y, d_o, attn_p, *bargs)
    got_dy, got_db, _ = tile_backward(y, d_o, attn_p, *bargs, fault=fault)
    hdv, hq = meta.num_heads * meta.dv, meta.num_heads * meta.dqk
    out = {"out": _share(out, want_out), "attn": _share(attn, want_attn)}
    for col, cols in (("d_u", slice(0, hdv)), ("d_v", slice(hdv, 2 * hdv)),
                      ("d_q", slice(2 * hdv, 2 * hdv + hq)), ("d_k", slice(2 * hdv + hq, None))):
        out[col] = _share(got_dy[..., cols], want_dy[..., cols])
    if want_db is not None:
        out["dbias"] = _share(got_db, want_db)
    return out


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", list(VARIANTS))
def test_tile_decomposition_matches_the_plain_versions(name, n):
    """Forward (out, attn) and attention backward (d_u, d_v, d_q, d_k, dbias)
    of the decomposition within TOL of the port's plain block."""
    shares = _shares(name, n)
    assert max(shares.values()) <= TOL, shares


@pytest.mark.parametrize("fault", FAULTS)
def test_tile_decomposition_faults_leave_the_tolerance(fault):
    """Each seeded fault (two k rows of the first tile swapped, one causal
    valid pair masked, 1xTF32) moves some output beyond TOL."""
    shares = _shares("attn_dropout", 150, fault)
    assert max(shares.values()) > TOL, shares


@pytest.mark.parametrize("name", ["default", "no_bias", "concat_ua"])
def test_tile_decomposition_at_the_new_widths(name):
    """At WIDE (D = 40, no multiple of 16, so the projection's last 32-deep
    chunk holds zero columns; n = 300 > 256, ten 32-row attention blocks,
    dkv's query blocks starting at each block's 32 keys), the forward and
    attention backward of the decomposition within TOL of the plain
    versions."""
    shares = _shares(name, WIDE_N, geom=WIDE)
    assert max(shares.values()) <= TOL, shares


def test_tile_decomposition_fault_leaves_the_tolerance_at_the_new_length():
    """Two k rows of the first tile swapped move some output beyond TOL at
    WIDE's n = 300 too."""
    shares = _shares("attn_dropout", WIDE_N, "k_rows_swapped", geom=WIDE)
    assert max(shares.values()) > TOL, shares


@pytest.mark.parametrize("name", ["concat_ua", "no_bias", "attn_dropout"])
def test_tile_decomposition_in_the_block_matches_pallas(name, monkeypatch):
    """The block's glue over the decomposition (forward and attention
    backward) against make_fused_train_block in interpret mode, f32, at the
    variants of `test_torch_port_train_variants.py` (h=2, dqk=dv=16, n=21):
    the forward and every gradient at JAX's fused-train tolerances."""
    monkeypatch.setattr(hbt, "fused_train_block_forward", tile_forward)
    monkeypatch.setattr(hbt, "attn_backward", tile_backward)
    o, w = _inputs_pallas(name), _weight()
    want_out, want = _jax_block(name, o, w, bf16=False)
    got_out, got = _port_block(name, o, w, bf16=False)
    np.testing.assert_allclose(got_out, want_out, **BLOCK_FWD_TOL)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **BLOCK_GRAD_TOL)


@pytest.mark.parametrize("name", ["attn_dropout"])
def test_tile_decomposition_in_the_block_matches_pallas_at_the_new_widths(name, monkeypatch):
    """As above at D = 40 and n = 300 (four users; the variants' h = 2, dqk =
    dv = 16): the decomposition's 32-row attention blocks in the block's
    glue against make_fused_train_block in interpret mode, the forward and
    every gradient within TOL of its largest value. (Elementwise, at JAX's
    fused-train tolerances, one of x's 48,000 gradients, where the
    LayerNorm backward cancels to a small value, is off by 2.4% relative and
    3.8e-4 absolute: 5.2e-7 of x's largest gradient.)"""
    import tests.test_torch_port_train_variants as tv

    monkeypatch.setattr(tv, "N", WIDE_N)
    monkeypatch.setattr(tv, "D", WIDE[1])
    monkeypatch.setattr(hbt, "fused_train_block_forward", tile_forward)
    monkeypatch.setattr(hbt, "attn_backward", tile_backward)
    o, w = _inputs_pallas(name), _weight()
    want_out, want = _jax_block(name, o, w, bf16=False)
    got_out, got = _port_block(name, o, w, bf16=False)
    shares = {k: _share(torch.tensor(got[k]), torch.tensor(want[k])) for k in want}
    shares["out"] = _share(torch.tensor(got_out), torch.tensor(want_out))
    assert max(shares.values()) <= TOL, shares


def _inputs_pallas(name: str) -> dict:
    from tests.test_torch_port_train_variants import _inputs as variant_inputs

    return variant_inputs(name, seed=4)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", list(VARIANTS))
def test_stage_plain_versions_compose_to_the_block_bit_for_bit(name, n):
    """The f32 route's stages on the CPU (their plain versions, through the
    wrappers) compose to the plain forward and attention backward bit for
    bit, and launch nothing."""
    args, meta = _inputs(name, n)
    x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw = args
    want_out, want_attn = hbt.fused_train_block_forward_reference(*args, SEED, meta)
    y = hbt.tf32_project(x, uvqk, meta)
    attn = hbt.tf32_attention(y, colmask, rel_pos, ext, tsw, SEED, meta)
    assert torch.equal(attn, want_attn)
    assert torch.equal(hbt.tf32_out_gemm(x, y, attn, o_kernel, o_bias, SEED, meta), want_out)
    _, d_o, _ = _bwd_operands(args, meta)
    want_dy, want_db, _ = hbt.attn_backward_reference(y, d_o, attn, colmask, rel_pos, ext, tsw,
                                                      meta, SEED)
    d_y, d_attn = hbt.tf32_bwd_rows(y, d_o, attn, meta)
    d_y, dbias = hbt.tf32_bwd_dq(y, d_attn, colmask, rel_pos, ext, tsw, meta, SEED, d_y)
    d_y = hbt.tf32_bwd_dkv(y, d_attn, colmask, rel_pos, ext, tsw, meta, SEED, d_y)
    assert torch.equal(d_y, want_dy)
    assert (dbias is None) == (want_db is None) and (dbias is None or torch.equal(dbias, want_db))
    stages = (hbt.tf32_project, hbt.tf32_attention, hbt.tf32_out_gemm, hbt.tf32_bwd_rows,
              hbt.tf32_bwd_dq, hbt.tf32_bwd_dkv)
    assert all(f.launches == 0 for f in stages)


def test_route_rule():
    """The f32 route at every registry config's train block and around its
    widths: f32, the SiLU projection, the pointwise attention, tc_route's
    widths (D <= 272, dqk and dv <= 32, h <= 3 or an even h <= 8) and n <= 512;
    bias, dropout and concat_ua do not matter. The rated (D = 264) and
    combined (n = 422) preprocessors' blocks take it. bf16 never takes it,
    and the bf16 routes never take f32."""
    for name in list_experiment_configs():
        cfg = get_experiment_config(name)
        c, n = cfg.hstu, cfg.max_seq_len_padded
        meta = train_block_meta(c, n)
        fits = (c.linear_activation == "silu" and not meta.softmax and c.embedding_dim <= 272
                and c.dqk <= 32 and c.dv <= 32
                and (c.num_heads <= 3 or (c.num_heads % 2 == 0 and c.num_heads <= 8)) and n <= 512)
        assert hbt.tf32_fwd_route(torch.float32, c.embedding_dim, n, meta) == fits, name
        assert hbt.tf32_bwd_route(torch.float32, n, meta) == fits, name
        assert not hbt.tf32_fwd_route(torch.bfloat16, c.embedding_dim, n, meta)
        assert not hbt.tc_fwd_route(torch.float32, c.embedding_dim, meta)
    base = train_block_meta(get_experiment_config("ml-20m-hstu-mol").hstu, 211)
    assert hbt.tf32_fwd_route(torch.float32, 256, 211, base)
    for change, d, n, want in ((dict(), 256, 256, True), (dict(), 256, 257, True),
                               (dict(), 256, 422, True), (dict(), 256, 512, True),
                               (dict(), 256, 513, False), (dict(), 264, 211, True),
                               (dict(), 272, 211, True), (dict(), 273, 211, False),
                               (dict(), 320, 211, False), (dict(softmax=True), 256, 211, False),
                               (dict(softmax=True), 256, 422, False),
                               (dict(activation="none"), 264, 211, False),
                               (dict(activation="none"), 256, 211, False),
                               (dict(num_heads=4, dqk=64, dv=64), 256, 211, False),
                               (dict(num_heads=5), 256, 211, False),
                               (dict(num_heads=3, dqk=25, dv=25), 50, 211, True),
                               (dict(num_heads=2, dqk=25, dv=25), 50, 211, True),
                               (dict(concat_ua=True, attn_rate=0.2), 256, 1, True),
                               (dict(rate=0.0), 256, 35, True)):
        meta = base._replace(**change)
        assert hbt.tf32_fwd_route(torch.float32, d, n, meta) == want, (change, d, n)
        # The backward reads no D: the default block past D = 272 takes it.
        want_bwd = want or (d > 272 and not change)
        assert hbt.tf32_bwd_route(torch.float32, n, meta) == want_bwd, (change, d, n)
