"""K1's three stages (`rails_tpu_torch.ops.hstu_block`) on the CPU.

The tensor-core K1 splits the block into a projection (u in f32; v, q, k
stored in bf16, v scaled by 1/max_seq_len before its rounding), an attention
that writes o_input, and the output GEMM. Their plain versions composed give
`fused_hstu_block_reference` bit for bit: storing q, k and v in the matmul
dtype changes no bit. The composition matches the Pallas kernel in interpret
mode; the width rule that picks the tensor-core kernels is pinned. Inputs come
from numpy seeds.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.ops.pallas import hstu_block as jax_hstu
from rails_tpu_torch.ops import hstu_block
from tests.test_torch_port_gpu import K1_VARIANTS
from tests.test_torch_port_kernels import K1_TOL, _k1_operands

MAX_SEQ_LEN = 211


def _variant_operands(variant, dtype, b: int, n: int, seed: int, d: int = 32, h: int = 2,
                      dqk: int = 16, dv: int = 16):
    """One block's torch operands and keywords for a K1_VARIANTS entry, from a
    numpy seed: ragged lengths (one user of length 1), the in-kernel bias
    tables, or the same bias precomputed in the matmul dtype (with the
    -30000 penalty for `penalty`), or none; a (3*h*dv, D) Wo for concat_ua."""
    mode, activation, normalization, concat_ua = variant
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 1 << 30, size=(b, n)), axis=1)
    lengths = np.maximum(1, rng.integers(0, n + 1, size=b))
    lengths[0] = 1
    ops, kw = _k1_operands(ts, lengths, MAX_SEQ_LEN, seed, d, h, dqk, dv)
    if concat_ua:
        ops["o_kernel"] = (rng.standard_normal((3 * h * dv, d)) / np.sqrt(h * dv)).astype(
            np.float32)
    args = {k: torch.from_numpy(v) for k, v in ops.items()}
    for k in ("x", "uvqk", "o_kernel"):
        args[k] = args[k].to(dtype)
    rel_pos, ext, tsw = (args.pop(k) for k in ("rel_pos", "ext", "tsw"))
    if mode == "internal":
        args.update(rel_pos=rel_pos, ext=ext, tsw=tsw)
    elif mode in ("penalty", "raw"):
        delta = ext[:, 1:, None] - ext[:, None, :n]
        bias = rel_pos[None] + tsw[hstu_block.time_bucket(delta, 128).long()]
        if mode == "penalty":
            causal = torch.tril(torch.ones(n, n))
            bias = bias + (causal[None] * args["colmask"][:, None, :] - 1.0) * 30000.0
        args.update(bias=bias.to(dtype), mask_in_bias=mode == "penalty")
    kw.update(activation=activation, normalization=normalization)
    return args, kw


def _composed(args: dict, kw: dict) -> torch.Tensor:
    """The three plain stages in a row."""
    h, dqk, dv = kw["num_heads"], kw["dqk"], kw["dv"]
    softmax = kw["normalization"] == "softmax_rel_bias"
    u, v, q, k = hstu_block.project_reference(
        args["x"], args["uvqk"], num_heads=h, dqk=dqk, dv=dv, inv_n=kw["inv_n"], eps=kw["eps"],
        activation=kw["activation"], softmax=softmax)
    o_input = hstu_block.attention_oinput_reference(
        u, v, q, k, args["colmask"], args.get("rel_pos"), args.get("ext"), args.get("tsw"),
        num_heads=h, dqk=dqk, dv=dv, eps=kw["eps"], num_buckets=kw["num_buckets"],
        bias=args.get("bias"), mask_in_bias=args.get("mask_in_bias", False), softmax=softmax,
        concat_ua=args["o_kernel"].shape[0] == 3 * h * dv)
    return hstu_block.out_gemm_reference(o_input, args["o_kernel"], args["o_bias"], args["x"])


@pytest.mark.parametrize("n", [35, 64, 211])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", K1_VARIANTS, ids=lambda v: "-".join(str(x) for x in v))
def test_stages_compose_to_the_block_bit_for_bit(variant, dtype, n):
    """n < max_seq_len for 35 and 64 (1/max_seq_len kept, rel-pos read at
    the trained centre)."""
    args, kw = _variant_operands(variant, dtype, b=3 if n < 211 else 2, n=n, seed=n)
    want = hstu_block.fused_hstu_block_reference(**args, **kw)
    got = _composed(args, kw)
    assert got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_projection_stores_the_rounded_operands():
    """v, q, k come out in the matmul dtype, v = round(y / max_seq_len)
    pointwise and round(y) under softmax; u stays f32."""
    args, kw = _variant_operands(K1_VARIANTS[0], torch.bfloat16, b=2, n=35, seed=3)
    h, dqk, dv = kw["num_heads"], kw["dqk"], kw["dv"]
    common = dict(num_heads=h, dqk=dqk, dv=dv, inv_n=kw["inv_n"], eps=kw["eps"])
    u, v, q, k = hstu_block.project_reference(args["x"], args["uvqk"], **common)
    u_s, v_s, q_s, k_s = hstu_block.project_reference(args["x"], args["uvqk"], softmax=True,
                                                      **common)
    assert u.dtype == torch.float32 and {t.dtype for t in (v, q, k)} == {torch.bfloat16}
    assert torch.equal(u, u_s) and torch.equal(q, q_s) and torch.equal(k, k_s)
    y = hstu_block.ln(args["x"].float(), kw["eps"]).bfloat16().float() @ args["uvqk"].float()
    y = y * torch.sigmoid(y)
    torch.testing.assert_close(v, (y[..., h * dv : 2 * h * dv] * kw["inv_n"]).bfloat16(),
                               rtol=0, atol=0)
    torch.testing.assert_close(v_s, y[..., h * dv : 2 * h * dv].bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("n", [35, 19], ids=["n_max", "n_truncated"])
def test_composition_matches_pallas(n):
    """As `test_torch_port_kernels.py::test_k1_plain_matches_pallas` runs the
    Pallas kernel (interpret mode, in-kernel time bias), at that file's
    K1_TOL."""
    rng = np.random.default_rng(n)
    b, max_seq_len = 3, 35
    ts = np.sort(rng.integers(0, 1 << 30, size=(b, n)), axis=1)
    lengths = np.array([n - 1, n // 2, 1])
    ops, kw = _k1_operands(ts, lengths, max_seq_len, seed=n)
    j = {k: jnp.asarray(v) for k, v in ops.items()}
    want = jax_hstu.fused_hstu_block(
        j["x"], None, j["colmask"], j["uvqk"], j["o_kernel"], j["o_bias"],
        interpret=True, time_bias=(j["rel_pos"], j["ext"], j["tsw"]), **kw)
    args = {k: torch.from_numpy(v) for k, v in ops.items()}
    got = _composed(args, dict(kw, activation="silu", normalization="rel_bias"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **K1_TOL)


# (dtype, D, h, dqk, dv) -> tensor cores? The configurations' widths (ML-20M,
# Amazon Books, ML-1M, synthetic-small, K4's wide-head variant) and each
# edge of the rule.
WIDTH_RULE = [
    ((torch.bfloat16, 256, 8, 32, 32), True),     # ml-20m-hstu-mol
    ((torch.bfloat16, 64, 8, 8, 8), True),        # amzn-books-hstu-mol
    ((torch.bfloat16, 50, 2, 25, 25), True),      # ml-1m
    ((torch.bfloat16, 32, 2, 16, 16), True),      # synthetic-small
    ((torch.bfloat16, 64, 3, 16, 16), True),      # odd h: one head warp of 3
    ((torch.bfloat16, 64, 1, 16, 16), True),
    ((torch.float32, 256, 8, 32, 32), False),     # f32 stays on the CUDA cores
    ((torch.bfloat16, 256, 4, 64, 64), False),    # head dims above 32
    ((torch.bfloat16, 264, 8, 32, 32), True),     # the rated preprocessor's 256 + 8
    ((torch.bfloat16, 272, 8, 32, 32), True),     # the widest A tile
    ((torch.bfloat16, 273, 8, 32, 32), False),    # D past the projection's A tile
    ((torch.bfloat16, 512, 8, 32, 32), False),
    ((torch.bfloat16, 256, 8, 32, 33), False),
    ((torch.bfloat16, 256, 5, 16, 16), False),    # odd h above 3
    ((torch.bfloat16, 256, 10, 16, 16), False),   # more than 4 heads a head warp
]


@pytest.mark.parametrize("widths,on_tc", WIDTH_RULE, ids=lambda w: str(w))
def test_width_rule(widths, on_tc):
    assert hstu_block.tc_route(*widths) is on_tc
    if on_tc:
        hstu_block.require_tc(*widths, "test")
    else:
        with pytest.raises(ValueError, match="no tensor-core instance"):
            hstu_block.require_tc(*widths, "test")


@pytest.mark.parametrize("activation", ["silu", "none"])
@pytest.mark.parametrize("widths,on_tc", WIDTH_RULE[:3] + WIDTH_RULE[6:8], ids=lambda w: str(w))
def test_block_route(widths, on_tc, activation):
    """`fused_hstu_block` takes the tensor cores at the width rule's widths
    with the SiLU projection only; linear_activation="none" stays on the
    CUDA-core kernels."""
    assert hstu_block.tc_block(*widths, activation) is (on_tc and activation == "silu")


def test_vqk_layout():
    """The padded [v | q | k] row at the configurations' widths; padding is
    zeros and `split_vqk` undoes `pack_vqk`."""
    assert hstu_block.vqk_layout(8, 32, 32) == (32, 32, 768)
    assert hstu_block.vqk_layout(8, 8, 8) == (16, 8, 320)
    assert hstu_block.vqk_layout(2, 25, 25) == (32, 32, 192)
    rng = np.random.default_rng(0)
    v, q, k = (torch.from_numpy(rng.standard_normal((2, 5, 2 * w)).astype(np.float32))
               for w in (25, 25, 25))
    vqk = hstu_block.pack_vqk(v, q, k, num_heads=2, dqk=25, dv=25)
    assert vqk.shape == (2, 5, 192)
    for got, want in zip(hstu_block.split_vqk(vqk, num_heads=2, dqk=25, dv=25), (v, q, k)):
        assert torch.equal(got, want)
    pad = vqk.reshape(2, 5, 6, 32)[..., 25:]
    assert not pad.any()


@pytest.mark.parametrize("variant", K1_VARIANTS, ids=lambda v: "-".join(str(x) for x in v))
def test_stage_wrappers_run_their_plain_versions_on_the_cpu(variant):
    """CPU tensors: `project`, `attention_oinput`, `out_gemm` give the
    composition bit for bit and launch nothing."""
    args, kw = _variant_operands(variant, torch.bfloat16, b=2, n=35, seed=5, d=64, h=8, dqk=8,
                                 dv=8)
    h, dqk, dv = kw["num_heads"], kw["dqk"], kw["dv"]
    softmax = kw["normalization"] == "softmax_rel_bias"
    counters = (hstu_block.project, hstu_block.attention_oinput, hstu_block.out_gemm)
    before = [f.launches for f in counters]
    u, vqk = hstu_block.project(args["x"], args["uvqk"], num_heads=h, dqk=dqk, dv=dv,
                                inv_n=kw["inv_n"], activation=kw["activation"], softmax=softmax)
    o_input = hstu_block.attention_oinput(
        u, vqk, args["colmask"], args.get("rel_pos"), args.get("ext"), args.get("tsw"),
        num_heads=h, dqk=dqk, dv=dv, bias=args.get("bias"),
        mask_in_bias=args.get("mask_in_bias", False), softmax=softmax,
        concat_ua=args["o_kernel"].shape[0] == 3 * h * dv)
    got = hstu_block.out_gemm(o_input, args["o_kernel"], args["o_bias"], args["x"])
    torch.testing.assert_close(got, _composed(args, kw), rtol=0, atol=0)
    torch.testing.assert_close(got, hstu_block.fused_hstu_block(**args, **kw), rtol=0, atol=0)
    assert [f.launches for f in counters] == before
