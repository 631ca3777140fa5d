"""K1's f32 serving route on the tensor cores, on the CPU: its tile
decomposition, its stages' plain versions and its route rule.

`csrc/hstu_serve_tf32.cuh` runs every product of the f32 serving block as
3xTF32 on mma.sync: each operand split into hi (its int32 view with the 13
low mantissa bits cleared) and lo = x - hi, which the tensor core reads
truncated to TF32 as well, and each 8-deep slice of a product summed into
the accumulator as lo.hi, then hi.lo, then hi.hi. Below, `tile_block` is that
decomposition in plain PyTorch: the projection and the output GEMM over
8-deep slices in order (o_input built from per-row statistics of attn); the
pointwise attention per (user, 64 query rows), heads in turn, over the
32-key chunks that hold a valid key, the bias block with the mask as a -1e30
penalty; the softmax attention's scores over every 32-key chunk of the whole
h*dqk contraction, normalised over all n columns, masked, then a v over the
causal chunks. It is held to the port's plain block and to rails_tpu's
`fused_hstu_block` in Pallas interpret mode, and seeded faults in it (two k
rows swapped, one mask bit flipped, the lo terms dropped, that is 1xTF32)
must leave the tolerance; also at the widths the route took on for the
rated and combined preprocessors (`WIDE`: a D that is no multiple of 16, an
n past 256). The CUDA kernels themselves run only on a card
(`tests/test_torch_port_gpu.py`).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rails_tpu.ops.pallas.hstu_block import fused_hstu_block as jax_fused_hstu_block
from rails_tpu_torch.core.config import get_experiment_config, list_experiment_configs
from rails_tpu_torch.ops import hstu_block as hb

ROWS, KEYS, STEP = 64, 32, 8           # the kernels' query rows, key chunk and k slice
MASK = -1e30                           # the bias of a masked pair
B, D, H, DQK, DV, NB = 3, 32, 2, 16, 16, 128
# (B, D, h, dqk, dv) and n past the old edges of the route: D = 40 pads to the
# projection's 32-deep chunks, n = 300 > 256 with narrow heads.
WIDE, WIDE_N = (1, 40, 2, 8, 8), 300
# name -> (bias mode, softmax, concat_ua); "penalty" is a precomputed bias
# with mask_in_bias's -30000 folded in, "raw" the same bias without it.
INSTANCES = {
    "base": ("internal", False, False),
    "concat_ua": ("internal", False, True),
    "mask_in_bias": ("penalty", False, False),
    "raw_bias": ("raw", False, False),
    "no_bias": ("none", False, False),
    "softmax": ("internal", True, False),
    "softmax_raw_bias": ("raw", True, False),
    "concat_ua+softmax": ("internal", True, True),
}
LENGTHS = (1, 35, 150)   # one row block and one key chunk; two chunks; three blocks, five
# The decomposition against the plain block and the Pallas kernel, max |err|
# over max |plain| per output: 3xTF32 keeps each product within ~2^-19 of
# f32 and the sums run in other f32 orders (measured below 2e-6); 1xTF32
# misses it by ~100x. The stage limit `chip_smoke.py` holds the kernels to.
TOL = 2e-5
FAULTS = ("k_rows_swapped", "mask_bit_flipped", "lo_dropped")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x truncated to TF32: its int32 view with the 13 low mantissa bits
    cleared."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def gemm3(a: torch.Tensor, b: torch.Tensor, fault=None) -> torch.Tensor:
    """a @ b as the kernels sum it: 8-deep slices of k in order, each added
    to the f32 accumulator as tf32(lo_a) hi_b, then hi_a tf32(lo_b), then
    hi_a hi_b; 1xTF32 (hi.hi alone) with the lo terms dropped."""
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], STEP):
        ak, bk = a[..., k0:k0 + STEP], b[k0:k0 + STEP]
        ah, bh = tf32(ak), tf32(bk)
        if fault != "lo_dropped":
            acc = acc + tf32(ak - ah) @ bh
            acc = acc + ah @ tf32(bk - bh)
        acc = acc + ah @ bh
    return acc


def _stats(t: torch.Tensor, eps: float):
    """Per-row mean and 1/sqrt(var + eps), population variance in two
    passes."""
    mu = t.sum(-1, keepdim=True) / t.shape[-1]
    var = ((t - mu) ** 2).sum(-1, keepdim=True) / t.shape[-1]
    return mu, torch.rsqrt(var + eps)


def _bias_block(args: dict, n: int, fault):
    """(B, n, n): the bias of a causal pair with a valid key (the in-kernel
    one, the tensor's or 0), else the penalty; with the fault one valid pair
    masked."""
    colmask = args["colmask"]
    if args.get("rel_pos") is not None:
        delta = args["ext"][:, 1:, None] - args["ext"][:, None, :n]
        bias = args["rel_pos"][None] + args["tsw"][hb.time_bucket(delta, NB).long()]
    elif args.get("bias") is not None:
        bias = args["bias"]
    else:
        bias = torch.zeros(colmask.shape[0], n, n)
    valid = torch.tril(torch.ones(n, n))[None] * colmask[:, None, :] > 0
    out = torch.where(valid, bias, torch.full_like(bias, MASK))
    if fault == "mask_bit_flipped":
        out[0, n - 1, 0] = MASK
    return out, bias, valid


def _chunks(colmask_row: torch.Tensor, keys: int) -> list:
    """The 32-key chunks below `keys` that hold a valid key."""
    return [c for c in range(-(-keys // KEYS)) if bool(colmask_row[c * KEYS:(c + 1) * KEYS].any())]


def _k_rows(k: torch.Tensor, first: bool, fault) -> torch.Tensor:
    if fault == "k_rows_swapped" and first and k.shape[0] > 1:
        return k[[1, 0] + list(range(2, k.shape[0]))]
    return k


def tile_pointwise(y, args, kw, fault=None):
    """attn as `serve_attn_kernel` tiles it: per (user, 64 rows), each head
    over the valid 32-key chunks up to the block's last row."""
    b, n, _ = y.shape
    h, dqk, dv = kw["num_heads"], kw["dqk"], kw["dv"]
    hdv, hq = h * dv, h * dqk
    bc, _, _ = _bias_block(args, n, fault)
    attn = torch.zeros(b, n, hdv)
    for bb in range(b):
        for i0 in range(0, n, ROWS):
            rows, jmax = slice(i0, min(i0 + ROWS, n)), min(i0 + ROWS, n)
            for hd in range(h):
                q = y[bb, rows, 2 * hdv + hd * dqk:2 * hdv + (hd + 1) * dqk]
                o = torch.zeros(rows.stop - i0, dv)
                for c in _chunks(args["colmask"][bb], jmax):
                    keys = slice(c * KEYS, min((c + 1) * KEYS, jmax))
                    k = y[bb, keys, 2 * hdv + hq + hd * dqk:2 * hdv + hq + (hd + 1) * dqk]
                    k = _k_rows(k, (bb, i0, hd, c) == (0, 0, 0, 0), fault)
                    s = gemm3(q, k.T, fault) + bc[bb, rows, keys]
                    a = s * (1.0 / (1.0 + torch.exp(-s)))
                    v = y[bb, keys, hdv + hd * dv:hdv + (hd + 1) * dv] * kw["inv_n"]
                    o = o + gemm3(a, v, fault)
                attn[bb, rows, hd * dv:(hd + 1) * dv] = o
    return attn


def tile_softmax(y, args, kw, fault=None):
    """attn as `serve_softmax_kernel` tiles it: per (user, 64 rows), the
    scores over every 32-key chunk of the h*dqk contraction, normalised over
    all n columns and masked, then a v over the valid causal chunks."""
    b, n, _ = y.shape
    hdv, hq = kw["num_heads"] * kw["dv"], kw["num_heads"] * kw["dqk"]
    bc, bias, valid = _bias_block(args, n, fault)
    attn = torch.zeros(b, n, hdv)
    for bb in range(b):
        for i0 in range(0, n, ROWS):
            rows, jmax = slice(i0, min(i0 + ROWS, n)), min(i0 + ROWS, n)
            q = y[bb, rows, 2 * hdv:2 * hdv + hq]
            s = torch.zeros(rows.stop - i0, n)
            for c in range(-(-n // KEYS)):
                keys = slice(c * KEYS, min((c + 1) * KEYS, n))
                k = _k_rows(y[bb, keys, 2 * hdv + hq:], (bb, i0, c) == (0, 0, 0), fault)
                s[:, keys] = ((gemm3(q, k.T, fault) + bias[bb, rows, keys])
                              * (1.0 / math.sqrt(kw["dqk"])))
            e = torch.exp(s - s.amax(-1, keepdim=True))
            mask = valid[bb, rows] & (bc[bb, rows] > 0.5 * MASK)
            a = e / e.sum(-1, keepdim=True) * mask
            o = torch.zeros(rows.stop - i0, hdv)
            for c in _chunks(args["colmask"][bb], jmax):
                keys = slice(c * KEYS, min((c + 1) * KEYS, jmax))
                o = o + gemm3(a[:, keys], y[bb, keys, hdv:2 * hdv], fault)
            attn[bb, rows] = o
    return attn


def tile_block(args: dict, kw: dict, fault=None):
    """(out, y, attn) of the f32 route's three launches."""
    x = args["x"]
    hdv = kw["num_heads"] * kw["dv"]
    mu, rs = _stats(x, kw["eps"])
    z = gemm3((x - mu) * rs, args["uvqk"], fault)
    y = z / (1.0 + torch.exp(-z))
    if kw["normalization"] == "softmax_rel_bias":
        attn = tile_softmax(y, args, kw, fault)
    else:
        attn = tile_pointwise(y, args, kw, fault)
    mu, rs = _stats(attn, kw["eps"])
    u, an = y[..., :hdv], (attn - mu) * rs
    o_in = torch.cat([u, an, u * an], -1) if args["o_kernel"].shape[0] == 3 * hdv else u * an
    return gemm3(o_in, args["o_kernel"], fault) + args["o_bias"] + x, y, attn


def _inputs(name: str, n: int, seed: int = 0, geom: tuple = (B, D, H, DQK, DV)):
    """K1's f32 operands for an instance at geometry (B, D, h, dqk, dv),
    ragged lengths (the first user's whole), from numpy; and the block's
    keyword arguments."""
    b, d, h, dqk, dv = geom
    mode, softmax, concat_ua = INSTANCES[name]
    rng = np.random.default_rng(seed)
    f = 2 * h * dv + 2 * h * dqk
    lengths = np.array([n, 1, max(1, n // 2)])[:b]
    colmask = (np.arange(n)[None, :] < lengths[:, None]).astype(np.float32)
    ts = np.sort(rng.integers(0, 1 << 30, (b, n)), axis=1).astype(np.int32)
    ext = np.concatenate([ts, ts[:, n - 1:]], axis=1)
    pos_w = (0.3 * rng.standard_normal(2 * n - 1)).astype(np.float32)
    i, j = np.arange(n)[:, None], np.arange(n)[None, :]
    rel_pos = pos_w[j - i + n - 1]
    tsw = (0.3 * rng.standard_normal(128)).astype(np.float32)
    ops = dict(
        x=rng.standard_normal((b, n, d)).astype(np.float32), colmask=colmask,
        uvqk=(rng.standard_normal((d, f)) / math.sqrt(d)).astype(np.float32),
        o_kernel=(rng.standard_normal(((3 if concat_ua else 1) * h * dv, d))
                  / math.sqrt(h * dv)).astype(np.float32),
        o_bias=(0.02 * rng.standard_normal(d)).astype(np.float32))
    if mode == "internal":
        ops.update(rel_pos=rel_pos, ext=ext, tsw=tsw)
    elif mode in ("penalty", "raw"):
        delta = ext[:, 1:, None] - ext[:, None, :n]
        bk = np.clip((np.log(np.maximum(np.abs(delta), 1).astype(np.float32))
                      / np.float32(0.301)).astype(np.int32), 0, 127)
        bias = rel_pos[None] + tsw[bk]
        if mode == "penalty":
            bias = bias + ((j <= i)[None] * colmask[:, None, :] - 1.0) * 30000.0
        ops["bias"] = bias.astype(np.float32)
    args = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ops.items()}
    if mode == "penalty":
        args["mask_in_bias"] = True
    kw = dict(num_heads=h, dqk=dqk, dv=dv, inv_n=1.0 / max(n, 2), eps=1e-6, num_buckets=NB,
              normalization="softmax_rel_bias" if softmax else "rel_bias")
    return args, kw


def _share(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _plain(args: dict, kw: dict):
    """(out, y, attn) of the port's plain block, through the plain stages."""
    y = hb.tf32_project_reference(args["x"], args["uvqk"], eps=kw["eps"])
    attn = hb.tf32_attention_reference(
        y, args["colmask"], args.get("rel_pos"), args.get("ext"), args.get("tsw"),
        num_heads=kw["num_heads"], dqk=kw["dqk"], dv=kw["dv"], inv_n=kw["inv_n"],
        num_buckets=NB, bias=args.get("bias"),
        mask_in_bias=args.get("mask_in_bias", False),
        softmax=kw["normalization"] == "softmax_rel_bias")
    return hb.fused_hstu_block_reference(**args, **kw), y, attn


def _shares(name: str, n: int, fault=None, geom: tuple = (B, D, H, DQK, DV)) -> dict:
    args, kw = _inputs(name, n, geom=geom)
    got, want = tile_block(args, kw, fault), _plain(args, kw)
    return {k: _share(g, w) for k, g, w in zip(("out", "y", "attn"), got, want)}


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", list(INSTANCES))
def test_tile_decomposition_matches_the_plain_block(name, n):
    """The decomposition's output, y and attn within TOL of the port's plain
    block and stages."""
    shares = _shares(name, n)
    assert max(shares.values()) <= TOL, shares


def _pallas_share(args: dict, kw: dict) -> float:
    """The decomposition's output against rails_tpu's `fused_hstu_block` in
    interpret mode, f32."""
    got = tile_block(args, kw)[0]
    np_args = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in args.items()}
    bias = np_args.get("bias")
    want = jax_fused_hstu_block(
        jnp.asarray(np_args["x"]), None if bias is None else jnp.asarray(bias),
        jnp.asarray(np_args["colmask"]), jnp.asarray(np_args["uvqk"]),
        jnp.asarray(np_args["o_kernel"]), jnp.asarray(np_args["o_bias"]),
        mask_in_bias=np_args.get("mask_in_bias", False),
        time_bias=(tuple(jnp.asarray(np_args[k]) for k in ("rel_pos", "ext", "tsw"))
                   if "rel_pos" in np_args else None),
        interpret=True, activation="silu", **kw)
    want = torch.from_numpy(np.array(want, dtype=np.float32))
    return _share(got, want)


@pytest.mark.parametrize("name", list(INSTANCES))
def test_tile_decomposition_matches_pallas(name):
    """The decomposition's output within TOL of rails_tpu's
    `fused_hstu_block` in interpret mode, f32, at n = 35 (two key chunks,
    ragged lengths)."""
    assert _pallas_share(*_inputs(name, 35)) <= TOL


@pytest.mark.parametrize("name", ["base", "softmax", "no_bias"])
def test_tile_decomposition_at_the_new_widths(name):
    """At WIDE (D = 40, no multiple of 16, so the projection's last 32-deep
    chunk holds zero columns; n = 300 > 256, ten 32-key chunks a 64-row block
    at most), the decomposition's output, y and attn within TOL of the plain
    block and stages, and its output within TOL of `fused_hstu_block` in
    interpret mode."""
    shares = _shares(name, WIDE_N, geom=WIDE)
    assert max(shares.values()) <= TOL, shares
    assert _pallas_share(*_inputs(name, WIDE_N, geom=WIDE)) <= TOL


def test_tile_decomposition_fault_leaves_the_tolerance_at_the_new_length():
    """Two k rows of the first chunk swapped move some output beyond TOL at
    WIDE's n = 300 too."""
    shares = _shares("base", WIDE_N, "k_rows_swapped", geom=WIDE)
    assert max(shares.values()) > TOL, shares


@pytest.mark.parametrize("name", ["base", "softmax"])
@pytest.mark.parametrize("fault", FAULTS)
def test_tile_decomposition_faults_leave_the_tolerance(fault, name):
    """Each seeded fault (two k rows of the first chunk swapped, one causal
    valid pair masked, 1xTF32) moves some output beyond TOL, pointwise and
    softmax."""
    shares = _shares(name, 150, fault)
    assert max(shares.values()) > TOL, shares


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", list(INSTANCES))
def test_stage_plain_versions_compose_to_the_block_bit_for_bit(name, n):
    """The f32 route's stages on the CPU (their plain versions, through the
    wrappers) compose to `fused_hstu_block_reference` bit for bit, and
    launch nothing."""
    args, kw = _inputs(name, n)
    counters = (hb.tf32_project, hb.tf32_attention, hb.tf32_out_gemm)
    before = [f.launches for f in counters] + [hb.tf32_attention.softmax_launches]
    y = hb.tf32_project(args["x"], args["uvqk"], num_heads=H, dqk=DQK, dv=DV, eps=kw["eps"])
    attn = hb.tf32_attention(
        y, args["colmask"], args.get("rel_pos"), args.get("ext"), args.get("tsw"), num_heads=H,
        dqk=DQK, dv=DV, inv_n=kw["inv_n"], num_buckets=NB, bias=args.get("bias"),
        mask_in_bias=args.get("mask_in_bias", False),
        softmax=kw["normalization"] == "softmax_rel_bias")
    out = hb.tf32_out_gemm(args["x"], y, attn, args["o_kernel"], args["o_bias"], num_heads=H,
                           dqk=DQK, dv=DV, eps=kw["eps"])
    assert torch.equal(out, hb.fused_hstu_block_reference(**args, **kw))
    assert torch.equal(out, hb.fused_hstu_block(**args, **kw))
    assert [f.launches for f in counters] + [hb.tf32_attention.softmax_launches] == before


def test_route_rule():
    """`tf32_block` at every registry config's serving block and around its
    widths: f32, the SiLU projection, `tc_widths` (D <= 272, dqk and dv <=
    32, h <= 3 or an even h <= 8) and 1 <= n <= 512; bias and concat_ua do
    not matter, and softmax only where its scores fit a block (n <= 352 at
    h*dqk = 256). The rated (D = 264) and combined (n = 422) preprocessors'
    blocks take it. linear_activation="none", D = 273, n = 513 and dqk = 64
    stay on the CUDA cores, and bf16 never takes the route."""
    for name in list_experiment_configs():
        c = get_experiment_config(name).hstu
        n = get_experiment_config(name).max_seq_len_padded
        fits = (c.linear_activation == "silu" and c.embedding_dim <= 272 and c.dqk <= 32
                and c.dv <= 32 and (c.num_heads <= 3 or (c.num_heads % 2 == 0 and c.num_heads <= 8))
                and n <= 512)
        got = hb.tf32_block(torch.float32, c.embedding_dim, n, c.num_heads, c.dqk, c.dv,
                            c.linear_activation)
        assert got == fits, name
        assert not hb.tf32_block(torch.bfloat16, c.embedding_dim, n, c.num_heads, c.dqk, c.dv,
                                 c.linear_activation)
    ml20m = get_experiment_config("ml-20m-hstu-mol")
    assert ml20m.hstu.linear_activation == "silu" and ml20m.max_seq_len_padded == 211
    for d, n, h, dqk, dv, act, want in ((256, 211, 8, 32, 32, "silu", True),
                                        (256, 256, 8, 32, 32, "silu", True),
                                        (256, 1, 8, 32, 32, "silu", True),
                                        (256, 257, 8, 32, 32, "silu", True),
                                        (256, 422, 8, 32, 32, "silu", True),
                                        (256, 512, 8, 32, 32, "silu", True),
                                        (256, 513, 8, 32, 32, "silu", False),
                                        (264, 211, 8, 32, 32, "silu", True),
                                        (272, 211, 8, 32, 32, "silu", True),
                                        (273, 211, 8, 32, 32, "silu", False),
                                        (264, 211, 8, 32, 32, "none", False),
                                        (256, 422, 8, 32, 32, "none", False),
                                        (256, 211, 8, 32, 32, "none", False),
                                        (256, 211, 4, 64, 64, "silu", False),
                                        (256, 211, 5, 32, 32, "silu", False),
                                        (320, 211, 8, 32, 32, "silu", False),
                                        (50, 211, 2, 25, 25, "silu", True),
                                        (64, 61, 8, 8, 8, "silu", True)):
        assert hb.tf32_block(torch.float32, d, n, h, dqk, dv, act) == want, (d, n, h, dqk, act)
    # Softmax: the (64, n) scores fit up to n = 352 at h*dqk = 256, to 512 at
    # narrow heads; 256 and below at every width of the route.
    for d, n, h, dqk, want in ((256, 256, 8, 32, True), (256, 352, 8, 32, True),
                               (256, 353, 8, 32, False), (256, 422, 8, 32, False),
                               (64, 512, 2, 16, True), (64, 513, 2, 16, False)):
        assert hb.tf32_block(torch.float32, d, n, h, dqk, dqk, "silu", softmax=True) == want, n
    for d, n in ((256, 513), (273, 211)):
        with pytest.raises(ValueError, match="no 3xTF32 instance"):
            hb.require_tf32(torch.float32, d, n, 8, 32, 32, "tf32_project")
