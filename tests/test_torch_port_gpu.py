"""rails_tpu_torch CUDA kernels vs their plain versions at edge shapes.

Marked `gpu`; every test skips without a CUDA device. On a card:
`python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py -q`
(`--noconftest` where jax is not installed: tests/conftest.py imports it).
`chip_smoke.py`
covers the serving and training shapes; these cover small, ragged and odd
shapes and both slices at the synthetic-small geometry.
"""

import numpy as np
import pytest
import torch

from rails_tpu_torch.core.config import get_experiment_config
from rails_tpu_torch.data.datasets import SequenceDataset, generate_synthetic_sequences
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.ops import (
    encode_probe,
    hash_dropout,
    hstu_block,
    hstu_block_train,
    mol_loss_train,
    mol_probe,
    mol_scoring,
    scatter_add,
)
from rails_tpu_torch.train import fused_adamw
from rails_tpu_torch.train.loop import create_train_state
from rails_tpu_torch.similarity.layers import l2_normalize
from rails_tpu_torch.train.evaluation import get_eval_state, make_eval_step_fn

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=1e-3, atol=1e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _k1_args(b, n, d, h, dqk, dv, max_seq_len, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    f = 2 * h * dv + 2 * h * dqk
    lengths = torch.randint(1, max(n, 2), (b,), generator=g)
    ts = torch.cumsum(torch.randint(1, 10**6, (b, n), generator=g), dim=1).to(torch.int32)
    pos_w = 0.02 * torch.randn(2 * max_seq_len - 1, generator=g)
    i, j = torch.arange(n)[:, None], torch.arange(n)[None, :]
    args = dict(
        x=torch.randn(b, n, d, generator=g).to(dtype),
        colmask=(torch.arange(n)[None, :] < lengths[:, None]).float(),
        uvqk=(torch.randn(d, f, generator=g) / d**0.5).to(dtype),
        o_kernel=(torch.randn(h * dv, d, generator=g) / (h * dv) ** 0.5).to(dtype),
        o_bias=0.02 * torch.randn(d, generator=g),
        rel_pos=pos_w[j - i + max_seq_len - 1].contiguous(),
        ext=torch.cat([ts, ts[:, -1:]], dim=1),
        tsw=0.1 * torch.randn(128, generator=g),
    )
    kw = dict(num_heads=h, dqk=dqk, dv=dv, inv_n=1.0 / max_seq_len, eps=1e-6)
    return {k: v.to(device) for k, v in args.items()}, kw


# K1's shapes (b, n, D, h, dqk, dv, max_seq_len): small, ragged and ML-20M,
# and the Amazon Books (D=64, h=8, dqk=dv=8, N=61) and ML-1M (D=50, h=2,
# dqk=dv=25, N=211) widths, which pad the heads of the tensor-core kernels.
K1_SHAPES = [(5, 35, 32, 2, 16, 16, 35), (3, 97, 64, 4, 16, 16, 211), (2, 211, 256, 8, 32, 32, 211),
             (3, 61, 64, 8, 8, 8, 61), (2, 211, 50, 2, 25, 25, 211)]
K1_SHAPE_IDS = ["tiny", "ragged", "ml20m", "books", "ml1m"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", K1_SHAPES, ids=K1_SHAPE_IDS)
def test_k1_kernel_matches_plain(cuda, shape, dtype):
    args, kw = _k1_args(*shape, dtype, cuda)
    before = hstu_block.fused_hstu_block.launches
    got = hstu_block.fused_hstu_block(**args, **kw)
    assert hstu_block.fused_hstu_block.launches == before + 1
    want = hstu_block.fused_hstu_block_reference(**args, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# K1's variants: (bias mode, activation, normalization, concat_ua).
K1_VARIANTS = [
    ("internal", "none", "rel_bias", True),
    ("internal", "silu", "softmax_rel_bias", False),
    ("internal", "silu", "softmax_rel_bias", True),
    ("penalty", "silu", "rel_bias", False),
    ("penalty", "none", "rel_bias", True),
    ("raw", "silu", "softmax_rel_bias", False),
    ("raw", "silu", "rel_bias", True),
    ("none", "silu", "rel_bias", False),
    ("none", "none", "softmax_rel_bias", True),
]


def _k1_variant_args(shape, variant, dtype, device):
    """K1's operands for a variant: the in-kernel bias tables, or the same
    bias precomputed in x's dtype (with the -30000 penalty for `penalty`),
    or none; a (3*h*dv, D) output projection for concat_ua."""
    mode, activation, normalization, concat_ua = variant
    b, n, d, h, dqk, dv, max_seq_len = shape
    args, kw = _k1_args(*shape, dtype, torch.device("cpu"))
    if concat_ua:
        g = torch.Generator().manual_seed(5)
        args["o_kernel"] = (torch.randn(3 * h * dv, d, generator=g) / (h * dv) ** 0.5).to(dtype)
    rel_pos, ext, tsw = (args.pop(k) for k in ("rel_pos", "ext", "tsw"))
    if mode == "internal":
        args.update(rel_pos=rel_pos, ext=ext, tsw=tsw)
    elif mode in ("penalty", "raw"):
        delta = ext[:, 1:, None] - ext[:, None, :n]
        bias = rel_pos[None] + tsw[hstu_block.time_bucket(delta, 128).long()]
        if mode == "penalty":
            causal = torch.tril(torch.ones(n, n))
            bias = bias + (causal[None] * args["colmask"][:, None, :] - 1.0) * 30000.0
        args.update(bias=bias.to(dtype).contiguous(), mask_in_bias=mode == "penalty")
    kw.update(activation=activation, normalization=normalization)
    return {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in args.items()}, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", K1_VARIANTS, ids=lambda v: "-".join(str(x) for x in v))
@pytest.mark.parametrize("shape", K1_SHAPES, ids=K1_SHAPE_IDS)
def test_k1_variants_match_plain(cuda, shape, variant, dtype):
    args, kw = _k1_variant_args(shape, variant, dtype, cuda)
    before = hstu_block.fused_hstu_block.launches
    got = hstu_block.fused_hstu_block(**args, **kw)
    assert hstu_block.fused_hstu_block.launches == before + 1
    want = hstu_block.fused_hstu_block_reference(**args, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("variant", K1_VARIANTS, ids=lambda v: "-".join(str(x) for x in v))
@pytest.mark.parametrize("shape", K1_SHAPES, ids=K1_SHAPE_IDS)
def test_k1_stage_kernels_match_plain(cuda, shape, variant):
    """Each tensor-core stage against its plain version on the same inputs:
    the projection's u within f32 sums of another order and v, q, k within
    one bf16 rounding; the attention and the output GEMM fed the plain
    stage's outputs."""
    args, kw = _k1_variant_args(shape, variant, torch.bfloat16, cuda)
    h, dqk, dv = kw["num_heads"], kw["dqk"], kw["dv"]
    softmax = kw.pop("normalization") == "softmax_rel_bias"
    activation = kw.pop("activation")
    inv_n = kw.pop("inv_n")
    concat_ua = args["o_kernel"].shape[0] == 3 * h * dv
    proj_kw = dict(num_heads=h, dqk=dqk, dv=dv, inv_n=inv_n, activation=activation,
                   softmax=softmax)
    counts = [f.launches for f in (hstu_block.project, hstu_block.attention_oinput,
                                   hstu_block.out_gemm)]
    u, vqk = hstu_block.project(args["x"], args["uvqk"], **proj_kw)
    u_p, v_p, q_p, k_p = hstu_block.project_reference(args["x"], args["uvqk"], **proj_kw)
    # Both round LN(x) to bf16 from statistics summed in other orders: an
    # element one bf16 ulp apart (2^-6 at |LN(x)| in [2, 4)) moves y by that
    # times a uvqk entry (~1/16); v, q, k then round to bf16 once more.
    proj_tol = dict(rtol=1e-2, atol=2e-3)
    torch.testing.assert_close(u, u_p, **proj_tol)
    layout = dict(num_heads=h, dqk=dqk, dv=dv)
    for got, want in zip(hstu_block.split_vqk(vqk, **layout), (v_p, q_p, k_p)):
        torch.testing.assert_close(got.float(), want.float(), **proj_tol)
    vqk_p = hstu_block.pack_vqk(v_p, q_p, k_p, **layout).contiguous()
    assert vqk.shape == vqk_p.shape
    # The padding is zeros.
    assert torch.equal(hstu_block.pack_vqk(*hstu_block.split_vqk(vqk, **layout), **layout), vqk)
    bias_kw = {k: args.get(k) for k in ("rel_pos", "ext", "tsw")}
    att_kw = dict(layout, bias=args.get("bias"), mask_in_bias=args.get("mask_in_bias", False),
                  softmax=softmax, concat_ua=concat_ua)
    oin = hstu_block.attention_oinput(u_p.contiguous(), vqk_p, args["colmask"], **bias_kw,
                                      **att_kw)
    oin_p = hstu_block.attention_oinput_reference(u_p, v_p, q_p, k_p, args["colmask"], **bias_kw,
                                                  **att_kw)
    torch.testing.assert_close(oin.float(), oin_p.float(), **TOL[torch.bfloat16])
    out = hstu_block.out_gemm(oin_p, args["o_kernel"], args["o_bias"], args["x"])
    out_p = hstu_block.out_gemm_reference(oin_p, args["o_kernel"], args["o_bias"], args["x"])
    torch.testing.assert_close(out.float(), out_p.float(), rtol=1e-2, atol=1e-2)
    assert [f.launches for f in (hstu_block.project, hstu_block.attention_oinput,
                                 hstu_block.out_gemm)] == [c + 1 for c in counts]


def test_k1_tensor_core_route_and_counters(cuda):
    """bf16 at the widths of `tc_route` with SiLU runs the three stage
    kernels (one launch of each counter); f32, wider heads and the linear
    activation run the CUDA-core block (`tc_block`); the stage wrappers raise
    outside the width rule; softmax scores past a block's shared memory
    raise."""
    counters = (hstu_block.project, hstu_block.attention_oinput, hstu_block.out_gemm)
    small, wide = (2, 40, 64, 4, 16, 16, 40), (2, 40, 64, 4, 64, 64, 40)
    for shape, dtype, activation, stages in ((small, torch.bfloat16, "silu", 1),
                                             (small, torch.float32, "silu", 0),
                                             (wide, torch.bfloat16, "silu", 0),
                                             (small, torch.bfloat16, "none", 0)):
        args, kw = _k1_args(*shape, dtype, cuda)
        before = [f.launches for f in counters]
        hstu_block.fused_hstu_block(**args, **kw, activation=activation)
        assert [f.launches for f in counters] == [c + stages for c in before]
    args, kw = _k1_args(2, 40, 64, 4, 16, 16, 40, torch.float32, cuda)
    with pytest.raises(ValueError, match="no tensor-core instance"):
        hstu_block.project(args["x"], args["uvqk"], num_heads=4, dqk=16, dv=16, inv_n=0.1)
    long_args, long_kw = _k1_args(1, 1024, 64, 4, 16, 16, 1024, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        hstu_block.fused_hstu_block(**long_args, **long_kw, normalization="softmax_rel_bias")


# The CUDA-core route's tile edges (csrc/hstu_block.cuh: 128 x 128 GEMM tiles,
# 64-row attention tiles over 64-key chunks and 64 value columns a pass):
# (b, n, D, h, dqk, dv, max_seq_len) and K1's variant (bias mode, activation,
# normalization, concat_ua). B*n = 111 ends inside the first GEMM row tile;
# n = 1, 33, 213 and 513 cut the row groups, key steps and tiles; dqk = dv =
# 64 is the wide-head case; dv = 96 and n = 1,024 (whole heads past a block's
# shared memory) take the chunked attention, 96 in two value passes; h = 5
# and D = 273 make ragged GEMM columns and k (D past the tensor-core routes'
# 272).
CC_NONE = ("internal", "none", "rel_bias", False)
K1_CC_EDGES = {
    "bn111": ((3, 37, 64, 4, 16, 16, 37), CC_NONE),
    "n1": ((4, 1, 64, 2, 16, 16, 8), CC_NONE),
    "n33": ((3, 33, 64, 2, 16, 16, 33), CC_NONE),
    "n213": ((2, 213, 256, 8, 32, 32, 213), CC_NONE),
    "n513": ((1, 513, 64, 2, 32, 32, 513), CC_NONE),
    "wide64": ((2, 211, 256, 4, 64, 64, 211), CC_NONE),
    "wide96": ((2, 70, 64, 1, 96, 96, 70), CC_NONE),
    "h5": ((2, 97, 80, 5, 16, 16, 97), CC_NONE),
    "d273": ((2, 61, 273, 8, 32, 32, 61), CC_NONE),
    "d273_silu": ((2, 61, 273, 8, 32, 32, 61), ("internal", "silu", "rel_bias", False)),
    "concat_ua": ((3, 97, 64, 4, 16, 16, 211), ("internal", "none", "rel_bias", True)),
    "tensor_bias": ((3, 97, 64, 4, 16, 16, 211), ("raw", "none", "rel_bias", False)),
    "penalty_bias": ((2, 213, 64, 4, 32, 32, 213), ("penalty", "none", "rel_bias", True)),
    "no_bias": ((2, 65, 64, 4, 32, 32, 65), ("none", "none", "rel_bias", False)),
    "n1024_chunked": ((1, 1_024, 64, 2, 32, 32, 1_024), CC_NONE),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("edge", list(K1_CC_EDGES))
def test_k1_cuda_core_route_edges_match_plain(cuda, edge, dtype):
    """K1 on the CUDA-core kernels at the edges of their tiles, against its
    plain version at the K1 tests' tolerance; no stage of a tensor-core
    route launches."""
    shape, variant = K1_CC_EDGES[edge]
    args, kw = _k1_variant_args(shape, variant, dtype, cuda)
    stages = (hstu_block.project, hstu_block.tf32_project, hstu_block.tf32_attention)
    before = [hstu_block.fused_hstu_block.launches] + [f.launches for f in stages]
    got = hstu_block.fused_hstu_block(**args, **kw)
    assert [hstu_block.fused_hstu_block.launches] + [f.launches for f in stages] == (
        [before[0] + 1] + before[1:])
    want = hstu_block.fused_hstu_block_reference(**args, **kw)
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# K4's CUDA-core instances at the tile edges: (variant of K4_VARIANTS, (b, n,
# D, h, dqk, dv)), max_seq_len max(211, n); "wide" variants take h = 4, dqk
# = dv = 64 whatever the shape says. The bf16 attention backward recomputes
# attn through the CUDA-core attention over the bf16 y. The attention
# backward's 64-row and 64-column tiles end inside a tile at n = 1, 65, 200
# and 211; n = 357 and 358 are the last length at which the first design
# (51f0934) staged narrow heads whole and the first at which it took its wide
# instance.
K4_CC_EDGES = {
    "act_none_n211_d273": ("act_none", (2, 211, 273, 8, 32, 32)),
    "act_none_n65_h5": ("act_none", (3, 65, 80, 5, 16, 16)),
    "wide_attn_dropout_n200": ("wide+attn_dropout+no_bias", (2, 200, 64, 4, 64, 64)),
    "wide_n1": ("wide", (2, 1, 64, 4, 64, 64)),
    "act_none_n1": ("act_none", (3, 1, 64, 4, 32, 32)),
    "act_none_n357": ("act_none", (1, 357, 64, 2, 32, 32)),
    "act_none_n358": ("act_none", (1, 358, 64, 2, 32, 32)),
}
# Instances only f32 takes off the tensor cores: the default SiLU block past
# the 3xTF32 route's n = 512 (bf16 runs it on K1's tensor-core kernels).
K4_CC_F32_EDGES = {"default_n513": ("default", (1, 513, 256, 8, 32, 32))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("edge", list(K4_CC_EDGES))
def test_k4_cuda_core_route_edges_match_plain(cuda, edge, dtype, monkeypatch):
    """K4's forward and attention backward on the CUDA-core kernels at the
    tiles' edges, against the plain versions at the K4 variant tests'
    tolerances; neither direction counts a tensor-core launch."""
    _check_k4_cuda_core_edge(*K4_CC_EDGES[edge], dtype, cuda, monkeypatch)


@pytest.mark.parametrize("edge", list(K4_CC_F32_EDGES))
def test_k4_f32_cuda_core_edges_match_plain(cuda, edge, monkeypatch):
    """As test_k4_cuda_core_route_edges_match_plain, in f32 only."""
    _check_k4_cuda_core_edge(*K4_CC_F32_EDGES[edge], torch.float32, cuda, monkeypatch)


def _check_k4_cuda_core_edge(variant, shape, dtype, cuda, monkeypatch):
    monkeypatch.setitem(K4_SHAPES, "edge", shape)
    args, meta = _k4_variant_block(variant, "edge", dtype, cuda)
    fwd, bwd = hstu_block_train.fused_train_block_forward, hstu_block_train.attn_backward
    before = (fwd.tc_launches, bwd.tc_launches)
    fargs = (args["x"], args["colmask"], args["uvqk"], args["o_kernel"], args["o_bias"],
             args["rel_pos"], args["ext"], args["tsw"], 11, meta)
    out_k, attn_k = fwd(*fargs)
    out_p, attn_p = hstu_block_train.fused_train_block_forward_reference(*fargs)
    bf16 = dtype == torch.bfloat16
    tol = 2e-2 if bf16 else 1e-3
    for got, want in ((out_k, out_p), (attn_k, attn_p)):
        assert bool(torch.isfinite(got.float()).all())
        if bf16:
            assert _share(got, want) <= 1e-2
        else:
            torch.testing.assert_close(got.float(), want.float(), rtol=1e-3, atol=1e-4)
    b, n = args["colmask"].shape
    g = torch.Generator(device=cuda).manual_seed(n)
    y = torch.randn(b, n, args["uvqk"].shape[1], generator=g, device=cuda).to(dtype)
    d_o = torch.randn(b, n, meta.o_width, generator=g, device=cuda).to(dtype)
    bargs = (y, d_o, None if bf16 else attn_k, args["colmask"], args["rel_pos"], args["ext"],
             args["tsw"], meta, 11)
    for got, want in zip(bwd(*bargs), hstu_block_train.attn_backward_reference(*bargs)):
        if want is not None:
            assert _share(got, want) <= tol
    assert (fwd.tc_launches, bwd.tc_launches) == before


def _parent_attn_bwd_bytes(n, dqk, dv):
    """`rails_hstu_train_bwd_smem_bytes` of the first design of
    `hstu_attn_bwd_kernel`, frozen as commit 51f0934 had it
    (csrc/hstu_block_train.cu:104-121): 512 threads, four head arrays staged
    transposed with stride n | 1 (two past 32 head dims, or where four would
    not fit a block), two row buffers of n a warp, colmask, the time-bucket
    weights and the n + 1 timestamps."""
    def staged(wide):
        floats = (1 if wide else 2) * (dqk + dv) * (n | 1) + 16 * 2 * n + n + 128
        return floats * 4 + (n + 1) * 4
    return staged(dqk > 32 or dv > 32 or staged(False) > hstu_block.MAX_SMEM_BYTES)


def test_k4_attn_backward_admits_what_the_first_design_admitted(cuda):
    """Every (n, dqk, dv) with n in 1..1,024 and head dims in {8, 16, 32, 64,
    96, 128} whose shared memory the first design's rule kept within a block
    is within a block under the library's rule, which `attn_backward` asks
    before a launch; the two extremes, dqk = dv = 8 at n = 1,024 and the
    longest n at dqk = dv = 128, run against the plain version."""
    from rails_tpu_torch.ops import _build

    lib = _build.load_library()
    widths = (8, 16, 32, 64, 96, 128)
    longest = 0
    for dqk in widths:
        for dv in widths:
            for n in range(1, 1_025):
                if _parent_attn_bwd_bytes(n, dqk, dv) > hstu_block.MAX_SMEM_BYTES:
                    continue
                assert lib.rails_hstu_train_bwd_smem_bytes(n, dqk, dv) <= (
                    hstu_block.MAX_SMEM_BYTES), (n, dqk, dv)
                if dqk == dv == 128:
                    longest = n
    assert longest > 100
    for n, width in ((1_024, 8), (longest, 128)):
        meta = hstu_block_train.BlockMeta(1, width, width, 1.0 / n, 1e-6, 128, 0.2,
                                          activation="none")
        args, _ = _k1_args(1, n, 64, 1, width, width, n, torch.float32, cuda, seed=n)
        g = torch.Generator(device=cuda).manual_seed(n)
        y = torch.randn(1, n, 4 * width, generator=g, device=cuda)
        d_o = torch.randn(1, n, width, generator=g, device=cuda)
        _, attn = hstu_block_train.fused_train_block_forward_reference(
            args["x"], args["colmask"], args["uvqk"], args["o_kernel"], args["o_bias"],
            args["rel_pos"], args["ext"], args["tsw"], 11, meta)
        bargs = (y, d_o, attn, args["colmask"], args["rel_pos"], args["ext"], args["tsw"], meta, 11)
        for got, want in zip(hstu_block_train.attn_backward(*bargs),
                             hstu_block_train.attn_backward_reference(*bargs)):
            assert _share(got, want) <= 1e-3, (n, width)


def test_cuda_core_attention_refuses_past_its_shared_memory(cuda):
    """The library's `rails_hstu_attn_smem_bytes`, which the wrappers ask
    before a launch, equals its mirror in
    tests/test_torch_port_k1_cuda_core.py over widths and lengths; a head
    whose q and key chunk pass a block's shared memory raises ValueError in
    K1, K4 and P1 before any launch."""
    from test_torch_port_k1_cuda_core import attn_smem_bytes

    from rails_tpu_torch.ops import _build

    lib = _build.load_library()
    for n in (1, 2, 7, 33, 63, 64, 65, 211, 513, 4_096):
        for dqk, dv in ((1, 1), (8, 8), (16, 16), (25, 25), (32, 32), (61, 3), (64, 64),
                        (96, 96), (300, 20), (1_358, 35)):
            assert lib.rails_hstu_attn_smem_bytes(n, dqk, dv) == attn_smem_bytes(
                n, dqk, dv), (n, dqk, dv)
    shape = (1, 64, 64, 1, 1_000, 8, 64)
    assert lib.rails_hstu_attn_smem_bytes(64, 1_000, 8) > hstu_block.MAX_SMEM_BYTES
    args, kw = _k1_variant_args(shape, CC_NONE, torch.float32, cuda)
    launches = hstu_block.fused_hstu_block.launches
    with pytest.raises(ValueError, match="shared memory"):
        hstu_block.fused_hstu_block(**args, **kw)
    assert hstu_block.fused_hstu_block.launches == launches
    meta = hstu_block_train.BlockMeta(1, 1_000, 8, kw["inv_n"], kw["eps"], 128, 0.2,
                                      activation="none")
    with pytest.raises(ValueError, match="shared memory"):
        hstu_block_train.fused_train_block_forward(
            args["x"], args["colmask"], args["uvqk"], args["o_kernel"], args["o_bias"],
            args["rel_pos"], args["ext"], args["tsw"], 11, meta)
    g = torch.Generator().manual_seed(5)
    o3 = (torch.randn(3 * 8, 64, generator=g) / 8 ** 0.5).to(cuda)
    with pytest.raises(ValueError, match="shared memory"):
        encode_probe.encode_probe_block("full", args["x"], args["colmask"], args["uvqk"], o3,
                                        args["o_bias"], args["rel_pos"], args["ext"],
                                        args["tsw"], num_heads=1, dqk=1_000, dv=8,
                                        inv_n=kw["inv_n"])


# K1's f32 route (3xTF32, csrc/hstu_serve_tf32.cuh): each stage against its
# plain version within this share of its largest value (the CPU test's and
# chip_smoke.py's K1_TF32_STAGE_TOL; 1xTF32 misses it ~100x).
K1_TF32_STAGE_TOL = 2e-5
K1_TF32_VARIANTS = [v for v in K1_VARIANTS if v[1] == "silu"]
# K1's shapes and the route's edges: one query row, n = 256, n = 512 (every
# key of a row block in its bias block or scores; the softmax scores fit at
# these narrow heads) and D = 272 (the widest LayerNorm'd x rows).
K1_TF32_SHAPES = K1_SHAPES + [(3, 1, 32, 2, 16, 16, 8), (2, 256, 64, 2, 16, 16, 256),
                              (1, 512, 64, 2, 16, 16, 512), (2, 40, 272, 2, 16, 16, 40)]
K1_TF32_SHAPE_IDS = K1_SHAPE_IDS + ["n1", "n256", "n512", "d272"]


def _k1_tf32_stages(args, kw, plain: bool):
    """(y, attn, out) of the f32 route's three stages, each on the plain
    versions of the stages before it."""
    h, dqk, dv = kw["num_heads"], kw["dqk"], kw["dv"]
    lay = dict(num_heads=h, dqk=dqk, dv=dv)
    tables = {k: args.get(k) for k in ("rel_pos", "ext", "tsw")}
    akw = dict(lay, inv_n=kw["inv_n"], bias=args.get("bias"),
               mask_in_bias=args.get("mask_in_bias", False),
               softmax=kw["normalization"] == "softmax_rel_bias")
    y_p = hstu_block.tf32_project_reference(args["x"], args["uvqk"])
    attn_p = hstu_block.tf32_attention_reference(y_p, args["colmask"], **tables, **akw)
    if plain:
        return y_p, attn_p, hstu_block.tf32_out_gemm_reference(
            args["x"], y_p, attn_p, args["o_kernel"], args["o_bias"], num_heads=h, dv=dv)
    return (hstu_block.tf32_project(args["x"], args["uvqk"], **lay),
            hstu_block.tf32_attention(y_p, args["colmask"], **tables, **akw),
            hstu_block.tf32_out_gemm(args["x"], y_p, attn_p, args["o_kernel"], args["o_bias"],
                                     **lay))


@pytest.mark.parametrize("variant", K1_TF32_VARIANTS, ids=lambda v: "-".join(str(x) for x in v))
@pytest.mark.parametrize("shape", K1_TF32_SHAPES, ids=K1_TF32_SHAPE_IDS)
def test_k1_f32_route_stages_match_plain(cuda, shape, variant):
    """Each stage of K1's f32 route on its plain inputs within
    K1_TF32_STAGE_TOL of its plain version; the block on the route, one
    launch of each stage (the softmax kernel's counter for softmax)."""
    args, kw = _k1_variant_args(shape, variant, torch.float32, cuda)
    b, n, d, h, dqk, dv, _ = shape
    assert hstu_block.tf32_block(torch.float32, d, n, h, dqk, dv, "silu")
    counters = (hstu_block.tf32_project, hstu_block.tf32_attention, hstu_block.tf32_out_gemm)
    before = [f.launches for f in counters] + [hstu_block.tf32_attention.softmax_launches]
    for name, got, want in zip(("y", "attn", "out"), _k1_tf32_stages(args, kw, False),
                               _k1_tf32_stages(args, kw, True)):
        share = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
        assert share <= K1_TF32_STAGE_TOL, (name, share)
    got = hstu_block.fused_hstu_block(**args, **kw)
    want = hstu_block.fused_hstu_block_reference(**args, **kw)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    softmax = int(kw["normalization"] == "softmax_rel_bias")
    assert ([f.launches for f in counters] + [hstu_block.tf32_attention.softmax_launches]
            == [c + 2 for c in before[:3]] + [before[3] + 2 * softmax])


@pytest.mark.parametrize("normalization", ["rel_bias", "softmax_rel_bias"])
@pytest.mark.parametrize("shape", K1_TF32_SHAPES, ids=K1_TF32_SHAPE_IDS)
def test_k1_f32_route_repeats_bit_for_bit(cuda, shape, normalization):
    """Two calls of each f32-route stage give the same bits: no atomics, one
    writer per output element."""
    args, kw = _k1_variant_args(shape, ("internal", "silu", normalization, True), torch.float32,
                                cuda)
    runs = [_k1_tf32_stages(args, kw, False) for _ in range(2)]
    assert all(torch.equal(a, c) for a, c in zip(*runs))


def test_k1_f32_route_rule_and_refusals(cuda):
    """f32 at the route's widths runs the three 3xTF32 stages (one launch
    each); linear_activation="none", dqk = dv = 64, n = 513, D = 273 and the
    softmax attention at n = 353, h*dqk = 256 (its scores do not fit) run
    the CUDA-core block (no stage launch). The entry points refuse every
    instance outside the route: cudaErrorInvalidValue (1), nothing launched;
    the stage wrappers raise there."""
    from rails_tpu_torch.ops import _build

    counters = (hstu_block.tf32_project, hstu_block.tf32_attention, hstu_block.tf32_out_gemm)
    for shape, activation, stages in (((2, 40, 64, 4, 16, 16, 40), "silu", 1),
                                      ((2, 40, 64, 4, 16, 16, 40), "none", 0),
                                      ((2, 40, 64, 4, 64, 64, 40), "silu", 0),
                                      ((1, 513, 64, 4, 16, 16, 513), "silu", 0),
                                      ((2, 40, 273, 4, 16, 16, 40), "silu", 0)):
        args, kw = _k1_args(*shape, torch.float32, cuda)
        before = [f.launches for f in counters]
        got = hstu_block.fused_hstu_block(**args, **kw, activation=activation)
        want = hstu_block.fused_hstu_block_reference(**args, **kw, activation=activation)
        torch.testing.assert_close(got, want, **TOL[torch.float32])
        assert [f.launches for f in counters] == [c + stages for c in before], (shape, activation)
    args, kw = _k1_args(1, 353, 256, 8, 32, 32, 353, torch.float32, cuda)
    kw["normalization"] = "softmax_rel_bias"
    assert not hstu_block.tf32_block(torch.float32, 256, 353, 8, 32, 32, "silu", softmax=True)
    assert hstu_block.tf32_block(torch.float32, 256, 352, 8, 32, 32, "silu", softmax=True)
    before = [f.launches for f in counters]
    got = hstu_block.fused_hstu_block(**args, **kw)
    torch.testing.assert_close(got, hstu_block.fused_hstu_block_reference(**args, **kw),
                               **TOL[torch.float32])
    assert [f.launches for f in counters] == before
    lib = _build.load_library()
    # The route rule's softmax bytes are the kernel's own layout.
    for n, h, dqk in ((211, 8, 32), (352, 8, 32), (353, 8, 32), (512, 2, 16)):
        assert (hstu_block.tf32_softmax_smem_bytes(n, h, dqk, dqk)
                == lib.rails_hstu_serve_tf32_smem_bytes(1, n, h, dqk, dqk)), n
    buf = torch.zeros(1 << 20, device=cuda)
    p = buf.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    for h, dqk, n in ((2, 64, 8), (5, 16, 8), (2, 16, 513)):
        assert lib.rails_hstu_serve_tf32_project(p, p, p, 1, n, 64, h, dqk, dqk, 1e-6, stream) == 1
        for softmax in (0, 1):
            assert lib.rails_hstu_serve_tf32_attention(p, p, None, None, None, None, p, 1, n, h,
                                                       dqk, dqk, 0.1, 0.25, 127, 2, softmax,
                                                       stream) == 1
        assert lib.rails_hstu_serve_tf32_out(p, p, p, p, p, p, 1, n, 64, h, dqk, dqk, 1e-6, 0,
                                             stream) == 1
    assert lib.rails_hstu_serve_tf32_project(p, p, p, 1, 8, 273, 2, 16, 16, 1e-6, stream) == 1
    assert lib.rails_hstu_serve_tf32_out(p, p, p, p, p, p, 1, 8, 273, 2, 16, 16, 1e-6, 0,
                                         stream) == 1
    torch.cuda.synchronize()
    for shape in ((1, 513, 64, 4, 16, 16, 513), (1, 8, 273, 4, 16, 16, 8)):
        args, kw = _k1_args(*shape, torch.float32, cuda)
        with pytest.raises(ValueError, match="no 3xTF32 instance"):
            hstu_block.tf32_project(args["x"], args["uvqk"], num_heads=4, dqk=16, dv=16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", encode_probe.MODES)
@pytest.mark.parametrize("shape", [(3, 97, 64, 4, 16, 16, 97), (2, 192, 256, 8, 32, 32, 192),
                                   (1, 33, 273, 5, 16, 16, 33), (4, 1, 64, 2, 32, 32, 8),
                                   (1, 213, 64, 2, 64, 64, 213)],
                         ids=["ragged", "ml20m", "n33_d273_h5", "n1", "wide_n213"])
def test_encode_probe_matches_plain(cuda, shape, mode, dtype):
    args, kw = _k1_args(*shape, dtype, cuda)
    b, n, d, h, dqk, dv, _ = shape
    g = torch.Generator().manual_seed(5)
    args["o_kernel"] = (torch.randn(3 * h * dv, d, generator=g) / (h * dv) ** 0.5).to(dtype).to(cuda)
    before = encode_probe.encode_probe_block.launches
    got = encode_probe.encode_probe_block(mode, **args, **kw)
    assert encode_probe.encode_probe_block.launches == before + 1
    want = encode_probe.encode_probe_block_reference(mode, **args, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("mode", mol_probe.MODES)
@pytest.mark.parametrize("shape", [(32, 512), (5, 96), (40, 2048)], ids=["probe", "odd", "two_blocks"])
def test_mol_probe_matches_plain(cuda, shape, mode):
    b, x = shape
    g = torch.Generator().manual_seed(6)
    l, hd = 32, 128
    a = dict(q=0.1 * torch.randn(8, b, 128, generator=g), qp=0.1 * torch.randn(b, l, generator=g),
             item=(0.1 * torch.randn(4, 128, x, generator=g)).bfloat16(),
             ip=(0.1 * torch.randn(l, x, generator=g)).bfloat16(),
             w1=0.1 * torch.randn(l, hd, generator=g), b1=0.1 * torch.randn(hd, generator=g),
             w2=0.1 * torch.randn(hd, l, generator=g), b2=0.1 * torch.randn(l, generator=g))
    ops = mol_probe.probe_operands(**{k: v.to(cuda) for k, v in a.items()})
    before = (mol_probe.mol_probe_scores.launches, mol_probe.mol_probe_scores.tc_launches)
    got = mol_probe.mol_probe_scores(mode, *ops)
    # The probe's 8x4x128, H=128 runs K2's tensor-core kernel (`tc_route`).
    assert (mol_probe.mol_probe_scores.launches,
            mol_probe.mol_probe_scores.tc_launches) == (before[0] + 1, before[1] + 1)
    want = mol_probe.mol_probe_scores_reference(mode, *ops)
    # Per score, the bound of one bf16 rounding flip of an MLP input: both
    # sides round the MLP's inputs at the same points, in other f32 orders.
    bound = mol_probe.mol_probe_error_bound(mode, *ops)
    assert ((got - want).abs() <= bound).all(), ((got - want).abs() / bound).max().item()


def _k2_args(b, x, p_q, p_x, d_p, hd, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    l = p_q * p_x
    tables = mol_scoring.prepare_fused_tables(
        l2_normalize(torch.randn(x, p_x, d_p, generator=g)).to(dtype),
        torch.randn(x, l, generator=g).to(dtype),
    )
    w = mol_scoring.MoLKernelWeights(
        torch.randn(l, hd, generator=g) / l**0.5, 0.1 * torch.randn(hd, generator=g),
        torch.randn(hd, l, generator=g) / hd**0.5, 0.1 * torch.randn(l, generator=g),
    )
    args = (
        l2_normalize(torch.randn(b, p_q, d_p, generator=g)).to(dtype).to(device),
        torch.randn(b, l, generator=g).to(device),
        tables.item_comp_t.to(device), tables.item_partial_t.to(device),
        mol_scoring.MoLKernelWeights(*(t.to(device) for t in w)), 0.05,
    )
    return args, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape", [(7, 100, 4, 2, 16, 32), (33, 300, 8, 4, 128, 128), (40, 513, 8, 4, 64, 96),
              (33, 256, 8, 8, 32, 128), (40, 700, 8, 8, 32, 128)],
    ids=["synthetic_small", "ml20m", "odd", "books_one_tile", "books_odd"],
)
def test_k2_kernel_matches_plain(cuda, shape, dtype):
    args, x = _k2_args(*shape, dtype, cuda)
    before = mol_scoring.fused_mol_scores_t.launches
    got = mol_scoring.fused_mol_scores_t(*args)[:, :x]
    assert mol_scoring.fused_mol_scores_t.launches == before + 1
    want = mol_scoring.fused_mol_scores_t_reference(*args)[:, :x]
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    else:
        assert (got.argmax(dim=1) == want.argmax(dim=1)).float().mean().item() >= 0.99
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


BOUND_SHAPES = [(7, 100, 4, 2, 16), (33, 256, 8, 4, 128), (40, 1000, 8, 4, 64), (1, 513, 4, 2, 32),
                (33, 256, 8, 8, 32), (40, 1000, 8, 8, 32)]
BOUND_IDS = ["synthetic_small", "one_tile_ml20m", "odd", "one_query", "one_tile_books", "books"]


def _bounds_hold(ub, gmax, k2, rel=2.0**-20):
    """K8 + rel * |K8| >= K2 on every pair (K8's logits are K2's: only the
    mixture's f32 rounding is left), and K9's max over l equal to K8's
    per-tile max bit for bit."""
    assert bool((ub + rel * ub.abs() >= k2).all())
    b, x = ub.shape
    assert torch.equal(gmax.amax(dim=1), ub.reshape(b, x // 256, 256).amax(dim=2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", BOUND_SHAPES, ids=BOUND_IDS)
def test_k8_k9_match_plain(cuda, shape, dtype):
    """K8 and K9 against their plain versions at B not a multiple of 32 and a
    corpus of one tile, each on the route `bounds_tc_route` names
    (`.tc_launches`); K8 bounds K2's scores (K8's logits are K2's) and K9's
    max over l is K8's per-tile max."""
    b, x, p_q, p_x, d_p = shape
    args, _ = _k2_args(b, x, p_q, p_x, d_p, 32, dtype, cuda)
    q, items = args[0], args[2]
    tc = int(mol_scoring.bounds_tc_route(dtype, p_q, p_x, d_p))
    for fn, ref in ((mol_scoring.fused_mol_ub_t, mol_scoring.fused_mol_ub_t_reference),
                    (mol_scoring.fused_mol_group_block_max,
                     mol_scoring.fused_mol_group_block_max_reference)):
        before = _counts(fn)
        got = fn(q, items, 0.05)
        assert _counts(fn) == (before[0] + 1, before[1] + tc)
        torch.testing.assert_close(got, ref(q, items, 0.05), rtol=1e-4, atol=1e-3)
    scores = mol_scoring.fused_mol_scores_t(*args)
    ub = mol_scoring.fused_mol_ub_t(q, items, 0.05)
    _bounds_hold(ub, mol_scoring.fused_mol_group_block_max(q, items, 0.05), scores)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("geom", [(8, 4, 128), (8, 8, 32)], ids=["ml20m", "books"])
def test_k8_bounds_k2_bit_for_bit_over_seeds(cuda, geom, kind):
    """Seeds 1-8, B=37 over three tiles, H=128: K2 and K8 both on the tensor
    cores, so K8 is the max of K2's logits and bounds K2's scores within
    the mixture's f32 rounding (2^-20); K9's max over l is K8's per tile."""
    assert mol_scoring.tc_route(torch.bfloat16, *geom, 128)
    for seed in range(1, 9):
        if kind == "int8":
            q, qp, ft, w, t, _ = _int8_args(37, 700, *geom, 128, cuda, seed=seed)
            args = (q, qp, ft.item_comp_t, ft.item_partial_t, w, t, ft.comp_scale,
                    ft.partial_scale)
            cs = ft.comp_scale
        else:
            args, _ = _k2_args(37, 700, *geom, 128, torch.bfloat16, cuda, seed=seed)
            cs = None
        q, items, t = args[0], args[2], args[5]
        _bounds_hold(mol_scoring.fused_mol_ub_t(q, items, t, cs),
                     mol_scoring.fused_mol_group_block_max(q, items, t, cs),
                     mol_scoring.fused_mol_scores_t(*args))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_k8_bounds_k2_off_its_tensor_cores_within_the_certificate_margin(cuda, kind):
    """H = 24 keeps K2 on the CUDA cores (not whole n8 steps of its MLP)
    while K8 takes the tensor cores: K8's logits are then not K2's, and K8
    bounds K2's scores within the certificate's margin (`_CERT_REL_MARGIN`)."""
    from rails_tpu_torch.index.top_k import _CERT_REL_MARGIN

    geom, hd = (8, 4, 128), 24
    dtype = torch.int8 if kind == "int8" else torch.bfloat16
    assert mol_scoring.bounds_tc_route(dtype, *geom)
    assert not mol_scoring.tc_route(dtype, *geom, hd)
    if kind == "int8":
        q, qp, ft, w, t, _ = _int8_args(37, 700, *geom, hd, cuda, seed=3)
        args = (q, qp, ft.item_comp_t, ft.item_partial_t, w, t, ft.comp_scale, ft.partial_scale)
        cs = ft.comp_scale
    else:
        args, _ = _k2_args(37, 700, *geom, hd, dtype, cuda, seed=3)
        cs = None
    k2_before = _counts(mol_scoring.fused_mol_scores_t)
    k2 = mol_scoring.fused_mol_scores_t(*args)
    assert _counts(mol_scoring.fused_mol_scores_t) == (k2_before[0] + 1, k2_before[1])
    ub_before = _counts(mol_scoring.fused_mol_ub_t)
    ub = mol_scoring.fused_mol_ub_t(args[0], args[2], args[5], cs)
    assert _counts(mol_scoring.fused_mol_ub_t) == (ub_before[0] + 1, ub_before[1] + 1)
    rel = _CERT_REL_MARGIN[dtype]
    assert bool((ub + rel * torch.maximum(ub.abs(), k2.abs()) >= k2).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(7, 600, 4, 2, 16, 32), (40, 1000, 8, 4, 128, 128),
                                   (40, 1000, 8, 8, 32, 128)],
                         ids=["synthetic_small", "ml20m", "books"])
def test_k10_equals_k2_columns(cuda, shape, dtype):
    """Duplicate and last-tile ids: K10's columns are K2's bit for bit; an
    out-of-range id gives NaN columns; the plain version agrees."""
    args, x = _k2_args(*shape, dtype, cuda)
    q, qp, items, ip, w, t = args
    nb = items.shape[2] // 256
    tiles = torch.tensor([nb - 1, 0, nb - 1, 1, 0], dtype=torch.int32, device=cuda)
    before = mol_scoring.fused_mol_scores_tiles.launches
    got = mol_scoring.fused_mol_scores_tiles(q, qp, tiles, items, ip, w, t)
    assert mol_scoring.fused_mol_scores_tiles.launches == before + 1
    cols = (tiles.long()[:, None] * 256 + torch.arange(256, device=cuda)).reshape(-1)
    assert torch.equal(got, mol_scoring.fused_mol_scores_t(*args)[:, cols])
    want = mol_scoring.fused_mol_scores_tiles_reference(q, qp, tiles, items, ip, w, t)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    else:
        assert (got.argmax(dim=1) == want.argmax(dim=1)).float().mean().item() >= 0.99
    bad = mol_scoring.fused_mol_scores_tiles(
        q, qp, torch.tensor([1, nb, -1], dtype=torch.int32, device=cuda), items, ip, w, t)
    assert not bool(bad[:, :256].isnan().any()) and bool(bad[:, 256:].isnan().all())


def test_bound_and_tile_kernels_refuse_what_they_have_no_instance_for(cuda):
    args, _ = _k2_args(4, 300, 8, 4, 32, 32, torch.float32, cuda)
    q, qp, items, ip, w, t = args
    tiles = torch.zeros(1, dtype=torch.int32, device=cuda)
    half, q_half = items.half(), q.half()
    for call in (lambda: mol_scoring.fused_mol_ub_t(q_half, half, t),
                 lambda: mol_scoring.fused_mol_group_block_max(q_half, half, t),
                 lambda: mol_scoring.fused_mol_scores_tiles(q_half, qp, tiles, half, ip.half(), w,
                                                            t)):
        with pytest.raises(NotImplementedError, match="no kernel instance"):
            call()
    q2 = q[:, :2].contiguous()       # (P_Q, P_X) = (2, 4): no instance
    for call in (lambda: mol_scoring.fused_mol_ub_t(q2, items, t),
                 lambda: mol_scoring.fused_mol_group_block_max(q2, items, t)):
        with pytest.raises(NotImplementedError, match="no kernel instance"):
            call()


def _int8_args(b, x, p_q, p_x, d_p, hd, device, seed=0):
    """K2's bf16 operands with the tables quantized to int8."""
    (q, qp, items, ip, w, t), x = _k2_args(b, x, p_q, p_x, d_p, hd, torch.bfloat16, device, seed)
    ft = mol_scoring.quantize_fused_tables(mol_scoring.FusedCorpusTables(items, ip, x))
    return q, qp, ft, w, t, x


INT8_SHAPES = [(7, 256, 4, 2, 16, 32), (33, 768, 8, 4, 128, 128), (40, 700, 8, 4, 64, 96),
               (33, 256, 8, 8, 32, 128), (40, 700, 8, 8, 32, 128)]


def _launched(fn, call, tc=1):
    before = (fn.launches, fn.int8_launches, fn.tc_launches)
    out = call()
    assert (fn.launches, fn.int8_launches, fn.tc_launches) == (before[0] + 1, before[1] + 1,
                                                               before[2] + tc)
    return out


@pytest.mark.parametrize("shape", INT8_SHAPES, ids=["one_tile", "three_tiles_ml20m", "odd",
                                                    "one_tile_books", "books_odd"])
def test_int8_kernels_match_plain(cuda, shape):
    """K2, K10, K8 and K9 on int8 tables against their plain versions, at B
    not a multiple of 32 and corpora of one and three tiles, each on its
    route (`tc_route`, `bounds_tc_route`: the tensor cores but at 4x2x16):
    K2 and K10 by K2's bf16 contract, K8 and K9 to 1e-5 of their largest
    value; K10's columns are K2's bit for bit; K8 bounds K2 within 2^-20 and
    K9's max over l is K8's per-tile max bit for bit."""
    q, qp, ft, w, t, x = _int8_args(*shape, cuda)
    b, p_q, p_x, d_p, hd = shape[0], *shape[2:]
    tc, tc_bounds = (int(mol_scoring.tc_route(torch.int8, p_q, p_x, d_p, hd)),
                     int(mol_scoring.bounds_tc_route(torch.int8, p_q, p_x, d_p)))
    a8 = (q, qp, ft.item_comp_t, ft.item_partial_t, w, t, ft.comp_scale, ft.partial_scale)
    k2 = _launched(mol_scoring.fused_mol_scores_t, lambda: mol_scoring.fused_mol_scores_t(*a8),
                   tc)
    want = mol_scoring.fused_mol_scores_t_reference(*a8)
    assert (k2[:, :x].argmax(dim=1) == want[:, :x].argmax(dim=1)).float().mean().item() >= 0.99
    torch.testing.assert_close(k2, want, rtol=2e-2, atol=2e-2)
    nb = ft.item_comp_t.shape[2] // 256
    tiles = torch.tensor([nb - 1, 0, nb - 1], dtype=torch.int32, device=cuda)
    k10 = _launched(mol_scoring.fused_mol_scores_tiles, lambda: mol_scoring.fused_mol_scores_tiles(
        q, qp, tiles, *a8[2:]), tc)
    cols = (tiles.long()[:, None] * 256 + torch.arange(256, device=cuda)).reshape(-1)
    assert torch.equal(k10, k2[:, cols])
    torch.testing.assert_close(
        k10, mol_scoring.fused_mol_scores_tiles_reference(q, qp, tiles, *a8[2:]),
        rtol=2e-2, atol=2e-2)
    for fn, ref in ((mol_scoring.fused_mol_ub_t, mol_scoring.fused_mol_ub_t_reference),
                    (mol_scoring.fused_mol_group_block_max,
                     mol_scoring.fused_mol_group_block_max_reference)):
        got = _launched(fn, lambda: fn(q, ft.item_comp_t, t, ft.comp_scale), tc_bounds)
        plain = ref(q, ft.item_comp_t, t, ft.comp_scale)
        assert ((got - plain).abs().max() / plain.abs().max()).item() <= 1e-5
    _bounds_hold(mol_scoring.fused_mol_ub_t(q, ft.item_comp_t, t, ft.comp_scale),
                 mol_scoring.fused_mol_group_block_max(q, ft.item_comp_t, t, ft.comp_scale), k2)


@pytest.mark.parametrize("geom", [(8, 4, 128), (8, 8, 32)], ids=["ml20m", "books"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
def test_k2_blockmax_matches_plain(cuda, dtype, geom):
    """emit_blockmax at B=33 over three tiles, `valid` with interior zeros and
    shorter than the padded corpus: the scores are K2's with those columns at
    -1e30, bit for bit; the maxima are theirs exactly; the plain version agrees."""
    if dtype == torch.int8:
        q, qp, ft, w, t, x = _int8_args(33, 700, *geom, 128, cuda)
        args = (q, qp, ft.item_comp_t, ft.item_partial_t, w, t, ft.comp_scale, ft.partial_scale)
    else:
        args, x = _k2_args(33, 700, *geom, 128, dtype, cuda)
    valid = torch.ones(x, device=cuda)
    valid[[0, 3, 255, 256, 600]] = 0.0
    k2 = mol_scoring.fused_mol_scores_t(*args)
    before = mol_scoring.fused_mol_scores_t.blockmax_launches
    scores, tile_max = mol_scoring.fused_mol_scores_t(*args, emit_blockmax=True, valid=valid)
    assert mol_scoring.fused_mol_scores_t.blockmax_launches == before + 1
    keep = torch.zeros(k2.shape[1], device=cuda)
    keep[:x] = valid
    assert torch.equal(scores, torch.where(keep != 0, k2, -1e30))
    assert tile_max.shape == (33, 3)
    assert torch.equal(tile_max, scores.reshape(33, 3, 256).amax(dim=2))
    ref_scores, ref_max = mol_scoring.fused_mol_scores_t_reference(*args, emit_blockmax=True,
                                                                  valid=valid)
    tol = dict(rtol=1e-4, atol=1e-3) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(scores, ref_scores, **tol)
    torch.testing.assert_close(tile_max, ref_max, **tol)


TC_GEOMS = [(8, 4, 128), (8, 4, 64), (8, 8, 32)]
TC_IDS = ["ml20m", "ml1m", "books"]


def _counts(fn):
    return fn.launches, fn.tc_launches


@pytest.mark.parametrize("geom", TC_GEOMS, ids=TC_IDS)
@pytest.mark.parametrize("shape", [(33, 256), (45, 700), (5, 768)],
                         ids=["one_tile", "three_tiles", "three_tiles_five_queries"])
def test_k2_tensor_core_route_matches_plain(cuda, geom, shape):
    """K2's tensor-core kernel at each geometry `tc_route` takes, B not a
    multiple of its 32-query block, corpora of one and three tiles: K2 by its
    bf16 contract against the plain version; K10 over duplicate, last and
    out-of-range tile ids bit-equal to K2's columns (NaN for the bad ids);
    emit_blockmax with mid-corpus valid == 0 columns bit-equal to K2 masked,
    its maxima exact. Every launch counts on `.tc_launches`."""
    b, x = shape
    assert mol_scoring.tc_route(torch.bfloat16, *geom, 128)
    args, x = _k2_args(b, x, *geom, 128, torch.bfloat16, cuda, seed=4)
    q, qp, items, ip, w, t = args
    k2_fn, k10_fn = mol_scoring.fused_mol_scores_t, mol_scoring.fused_mol_scores_tiles
    before = _counts(k2_fn)
    k2 = k2_fn(*args)
    assert _counts(k2_fn) == (before[0] + 1, before[1] + 1)
    want = mol_scoring.fused_mol_scores_t_reference(*args)
    assert (k2[:, :x].argmax(dim=1) == want[:, :x].argmax(dim=1)).float().mean().item() >= 0.99
    torch.testing.assert_close(k2[:, :x], want[:, :x], rtol=2e-2, atol=2e-2)

    nb = items.shape[2] // 256
    tiles = torch.tensor([nb - 1, 0, nb, nb - 1, -1, 0], dtype=torch.int32, device=cuda)
    before = _counts(k10_fn)
    k10 = k10_fn(q, qp, tiles, items, ip, w, t)
    assert _counts(k10_fn) == (before[0] + 1, before[1] + 1)
    good = torch.tensor([0, 1, 3, 5], device=cuda)
    cols = (tiles.long()[good, None] * 256 + torch.arange(256, device=cuda)).reshape(-1)
    got = k10.reshape(b, -1, 256)
    assert torch.equal(got[:, good].reshape(b, -1), k2[:, cols])
    assert bool(got[:, [2, 4]].isnan().all())

    valid = torch.ones(x, device=cuda)
    valid[[1, x // 3, x // 2 + 1, x - 3]] = 0.0
    before = _counts(k2_fn)
    scores, tile_max = k2_fn(*args, emit_blockmax=True, valid=valid)
    assert _counts(k2_fn) == (before[0] + 1, before[1] + 1)
    keep = torch.zeros(k2.shape[1], device=cuda)
    keep[:x] = valid
    assert torch.equal(scores, torch.where(keep != 0, k2, -1e30))
    assert torch.equal(tile_max, scores.reshape(b, nb, 256).amax(dim=2))


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_k2_f32_and_int8_tables_stay_on_the_cuda_cores(cuda, kind):
    """f32 tables at ML-20M's geometry and int8 tables at synthetic-small's
    4x2x16 launch the CUDA-core kernel: `.launches` advances, `.tc_launches`
    does not (int8 tables at the registry's other widths take the tensor
    cores: test_int8_kernels_match_plain)."""
    if kind == "int8":
        geom = (4, 2, 16, 32)
        q, qp, ft, w, t, _ = _int8_args(33, 300, *geom, cuda)
        args = (q, qp, ft.item_comp_t, ft.item_partial_t, w, t, ft.comp_scale, ft.partial_scale)
    else:
        geom = (8, 4, 128, 128)
        args, _ = _k2_args(33, 300, *geom, torch.float32, cuda)
    assert not mol_scoring.tc_route(args[2].dtype, *geom)
    tiles = torch.zeros(2, dtype=torch.int32, device=cuda)
    for fn, call in ((mol_scoring.fused_mol_scores_t, lambda: mol_scoring.fused_mol_scores_t(
                         *args)),
                     (mol_scoring.fused_mol_scores_tiles,
                      lambda: mol_scoring.fused_mol_scores_tiles(args[0], args[1], tiles,
                                                                 *args[2:]))):
        before = _counts(fn)
        call()
        assert _counts(fn) == (before[0] + 1, before[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8],
                         ids=["bf16", "f32", "int8"])
def test_k2_library_refuses_a_route_against_the_width_rule(cuda, dtype):
    """The library takes the tensor-core route exactly where `tc_route` does:
    bf16 and int8 tables at its widths sent to the CUDA-core kernel, f32 ones
    sent to the tensor cores, and the probe's bf16 operands sent to the
    CUDA-core kernel are refused (cudaErrorInvalidValue) and write nothing."""
    from rails_tpu_torch.ops import _build

    scales = (None, None)
    if dtype == torch.int8:
        q, qp, ft, w, t, _ = _int8_args(33, 256, 8, 4, 128, 128, cuda)
        items, ip = ft.item_comp_t, ft.item_partial_t
        scales = (ft.comp_scale.data_ptr(), ft.partial_scale.data_ptr())
    else:
        args, _ = _k2_args(33, 256, 8, 4, 128, 128, dtype, cuda)
        q, qp, items, ip, w, t = args
    wrong = 1 - int(mol_scoring.tc_route(dtype, 8, 4, 128, 128))
    lib = _build.load_library()
    w1t, w2 = w.w1.float().T.contiguous(), w.w2.float().contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.full((33, items.shape[2]), 7.0, device=cuda)
    weights = (w1t.data_ptr(), w.b1.data_ptr(), w2.data_ptr(), w.b2.data_ptr())
    code = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[dtype]
    err = lib.rails_mol_scores(
        wrong, code, 8, 4, q.data_ptr(), qp.data_ptr(), items.data_ptr(), ip.data_ptr(),
        *scales, *weights, None, out.data_ptr(), None, 33, items.shape[2], 128, 128, 1.0 / t,
        stream)
    torch.cuda.synchronize()
    assert err == 1 and bool((out == 7.0).all())
    ub = torch.full((33, items.shape[2]), 7.0, device=cuda)
    wrong_bounds = 1 - int(mol_scoring.bounds_tc_route(dtype, 8, 4, 128))
    for entry in (lib.rails_mol_ub, lib.rails_mol_group_block_max):
        err = entry(wrong_bounds, code, 8, 4, q.data_ptr(), items.data_ptr(), scales[0],
                    ub.data_ptr(), 33, items.shape[2], 128, 1.0 / t, stream)
        torch.cuda.synchronize()
        assert err == 1 and bool((ub == 7.0).all())
    if dtype == torch.bfloat16:
        err = lib.rails_mol_probe(wrong, 0, q.data_ptr(), qp.data_ptr(), items.data_ptr(),
                                  ip.data_ptr(), *weights, out.data_ptr(), 33, items.shape[2],
                                  128, 128, 20.0, stream)
        torch.cuda.synchronize()
        assert err == 1 and bool((out == 7.0).all())


def test_int8_wrappers_need_scales_and_bf16_queries(cuda):
    q, qp, ft, w, t, _ = _int8_args(4, 300, 8, 4, 32, 32, cuda)
    tiles = torch.zeros(1, dtype=torch.int32, device=cuda)
    for call in (lambda: mol_scoring.fused_mol_scores_t(q, qp, ft.item_comp_t, ft.item_partial_t,
                                                        w, t, ft.comp_scale),
                 lambda: mol_scoring.fused_mol_scores_tiles(q, qp, tiles, ft.item_comp_t,
                                                            ft.item_partial_t, w, t),
                 lambda: mol_scoring.fused_mol_ub_t(q, ft.item_comp_t, t),
                 lambda: mol_scoring.fused_mol_group_block_max(q, ft.item_comp_t, t)):
        with pytest.raises(ValueError, match="int8 tables need comp_scale"):
            call()
    with pytest.raises(ValueError, match="take torch.bfloat16 queries"):
        mol_scoring.fused_mol_ub_t(q.float(), ft.item_comp_t, t, ft.comp_scale)


def test_wrappers_reject_bad_cuda_inputs(cuda):
    args, kw = _k1_args(2, 16, 32, 2, 16, 16, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="uvqk"):
        hstu_block.fused_hstu_block(**{**args, "uvqk": args["uvqk"].T.contiguous().T}, **kw)
    k2, _ = _k2_args(4, 64, 8, 4, 32, 32, torch.float32, cuda)
    with pytest.raises(NotImplementedError, match="no kernel instance"):
        mol_scoring.fused_mol_scores_t(k2[0][:, :6].contiguous(), *k2[1:])


@pytest.mark.parametrize("method", ["MoLBruteForceTopK", "MoLBruteForceTopKFused",
                                    "MoLCertTopK100", "MoLTileTopK1", "MoLTileTopK2B1",
                                    "MoLCombTopK8_50", "MIPSBruteForceTopK"])
def test_slice_on_cuda_matches_cpu(cuda, method):
    """One tiny model, f32: the eval step on the card (kernels) and on the
    CPU (plain versions) return the same ranks and top-k ids."""
    cfg = get_experiment_config("synthetic-small")
    num_items = 300
    seqs = generate_synthetic_sequences(num_users=64, num_items=num_items, max_len=34, seed=1)
    ds = SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1)
    all_ids = np.arange(1, num_items + 1, dtype=np.int32)
    out = {}
    for device in ("cpu", cuda):
        model = SequentialRecommender(cfg, num_items, device=device,
                                      generator=torch.Generator().manual_seed(0))
        es = get_eval_state(model, all_ids, method, table_dtype=torch.float32, device=device)
        step = make_eval_step_fn(model, method, k=40, num_objects=es.num_objects,
                                 truncate_k_prime_to=60)
        batch = next(ds.batches(32, cfg.train.gr_output_length + 1, shuffle=False, device=device))
        out[str(device)] = [t.cpu() for t in step(es.topk_state, batch.features, batch.target_ids,
                                                   es.item_embeddings)]
    (r_cpu, i_cpu, s_cpu), (r_gpu, i_gpu, s_gpu) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(s_gpu, s_cpu, rtol=1e-4, atol=1e-4)
    assert (r_gpu == r_cpu).float().mean().item() >= 0.99
    assert (i_gpu == i_cpu).float().mean().item() >= 0.99


@pytest.mark.parametrize("shape", [(1, 1, 256), (3, 33, 40), (128, 211, 256)],
                         ids=["one_row", "odd", "ml20m"])
@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_k3_kernel_is_bit_equal_to_plain(cuda, shape, rate):
    for seed0 in (0, -1_498_392_781, 2**31 - 1, -(2**31)):
        before = hash_dropout.hash_keep_mask.launches
        got = hash_dropout.hash_keep_mask(*shape, seed0, rate, cuda)
        assert hash_dropout.hash_keep_mask.launches == before + 1
        assert torch.equal(got, hash_dropout.hash_keep_mask_reference(*shape, seed0, rate, cuda))


GRAD_NAMES = ("x", "rel_pos", "tsw", "uvqk", "o_kernel", "o_bias")


@pytest.mark.parametrize("rate,num_buckets", [(0.0, 128), (0.2, 32)], ids=["rate0", "rate0.2_b32"])
@pytest.mark.parametrize("b,n", [(1, 1), (2, 33), (1, 211), (3, 97)],
                         ids=["n1", "n33", "n211", "b3_n97"])
def test_k4_matches_plain_autograd(cuda, b, n, rate, num_buckets):
    """Forward and every gradient of the kernel block against autograd of the
    plain forward, at the ml-20m block widths."""
    args, kw = _k1_args(b, n, 256, 8, 32, 32, 211, torch.float32, cuda, seed=n)
    args["x"] = args["x"] * args["colmask"][..., None]
    meta = hstu_block_train.BlockMeta(8, 32, 32, kw["inv_n"], kw["eps"], num_buckets, rate)
    w = torch.cos(torch.arange(args["x"].numel(), device=cuda, dtype=torch.float32)).reshape(
        args["x"].shape)
    res = []
    for fn in (hstu_block_train.fused_train_block,
               hstu_block_train.fused_train_block_autograd_reference):
        leaves = [args[k].clone().requires_grad_(True) for k in GRAD_NAMES]
        out = fn(*leaves, args["colmask"], args["ext"], -77, meta)
        (out * w).sum().backward()
        res.append((out.detach(), [t.grad for t in leaves]))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=1e-3, atol=1e-4)
    for name, got, want in zip(GRAD_NAMES, res[0][1], res[1][1]):
        scale = want.abs().max().clamp_min(1e-30)
        assert ((got - want).abs().max() / scale).item() <= 1e-3, name


@pytest.mark.parametrize("b,n", [(1, 1), (1, 211), (128, 211), (3, 97)],
                         ids=["n1", "n211", "b128_n211", "b3_n97"])
def test_k4_bf16_matches_plain(cuda, b, n, monkeypatch):
    """The bf16 block through its kernels against the same block with the
    plain forward and attention backward (which round where the kernels
    round): the forward within 1e-2 and each gradient within 2e-2 of its
    largest value; the bf16 counters count the launches."""
    args, kw = _k1_args(b, n, 256, 8, 32, 32, 211, torch.bfloat16, cuda, seed=n)
    args["x"] = args["x"] * args["colmask"][..., None].to(torch.bfloat16)
    meta = hstu_block_train.BlockMeta(8, 32, 32, kw["inv_n"], kw["eps"], 128, 0.2)
    w = torch.cos(torch.arange(args["x"].numel(), device=cuda, dtype=torch.float32)).reshape(
        args["x"].shape)
    fwd, bwd = hstu_block_train.fused_train_block_forward, hstu_block_train.attn_backward
    res = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(hstu_block_train, "fused_train_block_forward",
                                hstu_block_train.fused_train_block_forward_reference)
            monkeypatch.setattr(hstu_block_train, "attn_backward",
                                hstu_block_train.attn_backward_reference)
        before = (fwd.bf16_launches, bwd.bf16_launches)
        leaves = [args[k].clone().requires_grad_(True) for k in GRAD_NAMES]
        out = hstu_block_train.fused_train_block(*leaves, args["colmask"], args["ext"], 11, meta)
        (out.float() * w).sum().backward()
        assert out.dtype == torch.bfloat16
        assert (fwd.bf16_launches, bwd.bf16_launches) == tuple(
            v + (0 if plain else 1) for v in before)
        res.append((out.detach().float(), [t.grad for t in leaves]))
    (out_k, g_k), (out_p, g_p) = res
    assert ((out_k - out_p).abs().max() / out_p.abs().max()).item() <= 1e-2
    for name, got, want in zip(GRAD_NAMES, g_k, g_p):
        assert got.dtype == want.dtype, name
        scale = want.float().abs().max().clamp_min(1e-30)
        assert ((got.float() - want.float()).abs().max() / scale).item() <= 2e-2, name


# K4's variant instances: BlockMeta fields beyond the default and whether the
# block has the relative-attention bias. "wide" is h=4, dqk=dv=64.
K4_VARIANTS = {
    "concat_ua": (dict(concat_ua=True), True),
    "act_none": (dict(activation="none"), True),
    "softmax": (dict(softmax=True), True),
    "no_bias": ({}, False),
    "attn_dropout": (dict(attn_rate=0.2), True),
    "softmax+no_bias": (dict(softmax=True), False),
    "concat_ua+softmax+attn_dropout": (dict(concat_ua=True, softmax=True, attn_rate=0.2), True),
    "wide": ({}, True),
    "wide+attn_dropout+no_bias": (dict(attn_rate=0.2), False),
}
# (b, n, D, h, dqk, dv) at each edge; "padded" has one user with no valid
# position; the small shapes run softmax at h*dv = 32 < 256.
K4_SHAPES = {"n1": (1, 1, 64, 2, 16, 16), "n33_padded": (3, 33, 64, 2, 16, 16),
             "n211": (2, 211, 256, 8, 32, 32)}


def _k4_variant_block(variant, shape, dtype, device):
    fields, has_bias = K4_VARIANTS.get(variant, ({}, True))   # "default": the SiLU block
    b, n, d, h, dqk, dv = K4_SHAPES[shape]
    if variant.startswith("wide"):
        h, dqk, dv = 4, 64, 64
    args, kw = _k1_args(b, n, d, h, dqk, dv, max(211, n), dtype, device, seed=n + 7)
    if shape == "n33_padded":
        args["colmask"][1] = 0.0
    args["x"] = args["x"] * args["colmask"][..., None].to(dtype)
    meta = hstu_block_train.BlockMeta(h, dqk, dv, kw["inv_n"], kw["eps"], 128, 0.2, **fields)
    if meta.concat_ua:
        g = torch.Generator().manual_seed(5)
        args["o_kernel"] = (torch.randn(3 * h * dv, d, generator=g) / (h * dv) ** 0.5).to(
            dtype).to(device)
    if not has_bias:
        args.update(rel_pos=None, ext=None, tsw=None)
    return args, meta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(K4_SHAPES))
@pytest.mark.parametrize("variant", list(K4_VARIANTS))
def test_k4_variants_match_plain(cuda, variant, shape, dtype, monkeypatch):
    """Each K4 variant instance, forward and attention backward, against its
    plain version (f32: autograd of the plain forward; bf16: the block's glue
    over the plain forward and attention backward), at the tolerances of the
    default instance's tests; the variant counters count the launches."""
    args, meta = _k4_variant_block(variant, shape, dtype, cuda)
    has_bias = args["rel_pos"] is not None
    bf16 = dtype == torch.bfloat16
    fwd, bwd = hstu_block_train.fused_train_block_forward, hstu_block_train.attn_backward
    name = hstu_block_train.variant_name(meta, has_bias)
    assert name != "default"
    names = GRAD_NAMES if has_bias else ("x", "uvqk", "o_kernel", "o_bias")
    w = torch.cos(torch.arange(args["x"].numel(), device=cuda, dtype=torch.float32)).reshape(
        args["x"].shape)
    res = []
    for plain in (False, True):
        fn = hstu_block_train.fused_train_block
        if plain and bf16:
            monkeypatch.setattr(hstu_block_train, "fused_train_block_forward",
                                hstu_block_train.fused_train_block_forward_reference)
            monkeypatch.setattr(hstu_block_train, "attn_backward",
                                hstu_block_train.attn_backward_reference)
        elif plain:
            fn = hstu_block_train.fused_train_block_autograd_reference
        before = (fwd.variant_launches.get(name, 0), bwd.variant_launches.get(name, 0))
        leaves = {k: args[k].clone().requires_grad_(True) for k in names}
        out = fn(leaves["x"], leaves.get("rel_pos"), leaves.get("tsw"), leaves["uvqk"],
                 leaves["o_kernel"], leaves["o_bias"], args["colmask"], args["ext"], 11, meta)
        (out.float() * w).sum().backward()
        assert (fwd.variant_launches.get(name, 0), bwd.variant_launches.get(name, 0)) == tuple(
            v + (0 if plain else 1) for v in before)
        res.append((out.detach().float(), {k: leaves[k].grad.float() for k in names}))
    (out_k, g_k), (out_p, g_p) = res
    assert bool(torch.isfinite(out_k).all())
    if bf16:
        assert ((out_k - out_p).abs().max() / out_p.abs().max()).item() <= 1e-2
    else:
        torch.testing.assert_close(out_k, out_p, rtol=1e-3, atol=1e-4)
    for k in names:
        scale = g_p[k].abs().max().clamp_min(1e-30)
        assert ((g_k[k] - g_p[k]).abs().max() / scale).item() <= (2e-2 if bf16 else 1e-3), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(K4_SHAPES))
@pytest.mark.parametrize("variant", list(K4_VARIANTS))
def test_k4_variant_attn_backward_matches_plain(cuda, variant, shape, dtype):
    """The attention backward alone, d_y and dbias (None without the bias),
    against its plain version on the same y and d(o_input)."""
    args, meta = _k4_variant_block(variant, shape, dtype, cuda)
    b, n = args["colmask"].shape
    f = args["uvqk"].shape[1]
    g = torch.Generator(device=cuda).manual_seed(n)
    y = torch.randn(b, n, f, generator=g, device=cuda).to(dtype)
    d_o = torch.randn(b, n, meta.o_width, generator=g, device=cuda).to(dtype)
    attn = None
    if dtype == torch.float32:
        attn = hstu_block_train.fused_train_block_forward(
            args["x"], args["colmask"], args["uvqk"], args["o_kernel"], args["o_bias"],
            args["rel_pos"], args["ext"], args["tsw"], 11, meta)[1]
    bargs = (y, d_o, attn, args["colmask"], args["rel_pos"], args["ext"], args["tsw"], meta, 11)
    d_y_k, dbias_k, attn_k = hstu_block_train.attn_backward(*bargs)
    d_y_p, dbias_p, attn_p = hstu_block_train.attn_backward_reference(*bargs)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-3
    pairs = [(d_y_k, d_y_p), (attn_k, attn_p)]
    if args["rel_pos"] is None:
        assert dbias_k is None and dbias_p is None
    else:
        pairs.append((dbias_k, dbias_p))
    for got, want in pairs:
        assert bool(torch.isfinite(got).all())
        assert ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item() <= tol


# The tensor-core route's variants (pointwise backward: the first five).
K4_TC_VARIANTS = ("concat_ua", "no_bias", "attn_dropout", "softmax",
                  "concat_ua+softmax+attn_dropout")


def _k4_tc_stage_inputs(variant, shape, device):
    """The variant block's bf16 operands, K1's projection of them on the
    card (u, vqk) and a seeded bf16 (y, d_o) for the backward stages."""
    args, meta = _k4_variant_block(variant, shape, torch.bfloat16, device)
    b, n = args["colmask"].shape
    u, vqk = hstu_block.project(args["x"], args["uvqk"], num_heads=meta.num_heads, dqk=meta.dqk,
                                dv=meta.dv, inv_n=meta.inv_n, eps=meta.eps,
                                activation=meta.activation, softmax=meta.softmax)
    g = torch.Generator(device=device).manual_seed(n + 3)
    y = torch.randn(b, n, args["uvqk"].shape[1], generator=g, device=device).bfloat16()
    d_o = torch.randn(b, n, meta.o_width, generator=g, device=device).bfloat16()
    return args, meta, u, vqk, y, d_o


def _share(got, want) -> float:
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("shape", list(K4_SHAPES))
@pytest.mark.parametrize("variant", K4_TC_VARIANTS)
def test_k4_tensor_core_stages_match_plain(cuda, variant, shape):
    """Each tensor-core kernel of K4's bf16 route against its plain stage
    version on the same inputs, within 2e-2 of the largest value (both round
    to bf16 at the same points, in other f32 orders): the TRAIN attention
    (o_input, attn), then, pointwise, the backward's rows (d_u, d_attn,
    attn), dq (d_q, dbias) and dkv (d_v, d_k) stages, each fed the plain
    version's d_attn. Two calls of each give the same bits."""
    hbt = hstu_block_train
    args, meta, u, vqk, y, d_o = _k4_tc_stage_inputs(variant, shape, cuda)
    tables = (args["rel_pos"], args["ext"], args["tsw"])
    v, q, k = hstu_block.split_vqk(vqk, num_heads=meta.num_heads, dqk=meta.dqk, dv=meta.dv)
    before = hbt.train_attention_oinput.launches
    got = hbt.train_attention_oinput(u, vqk, args["colmask"], *tables, 11, meta)
    assert hbt.train_attention_oinput.launches == before + 1
    want = hbt.train_attention_oinput_reference(u, v, q, k, args["colmask"], *tables, 11, meta)
    for g_, w_ in zip(got, want):
        assert _share(g_, w_) <= 2e-2
    again = hbt.train_attention_oinput(u, vqk, args["colmask"], *tables, 11, meta)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if meta.softmax:
        return
    hdv, hq = meta.num_heads * meta.dv, meta.num_heads * meta.dqk
    bargs = (args["colmask"], *tables, meta, 11)
    want_dy, want_dattn, want_attn = hbt.attn_bwd_rows_reference(y, d_o, *bargs)
    want_dy, want_db = hbt.attn_bwd_dq_reference(y, want_dattn, *bargs, d_y=want_dy)
    want_dy = hbt.attn_bwd_dkv_reference(y, want_dattn, *bargs, d_y=want_dy)
    runs = []
    for _ in range(2):
        d_y, d_attn, attn = hbt.attn_bwd_rows(y, d_o, *bargs)
        d_y, dbias = hbt.attn_bwd_dq(y, want_dattn, *bargs, d_y=d_y)
        d_y = hbt.attn_bwd_dkv(y, want_dattn, *bargs, d_y=d_y)
        runs.append((d_y, d_attn, attn, dbias))
    d_y, d_attn, attn, dbias = runs[0]
    for cols in (slice(0, hdv), slice(hdv, 2 * hdv), slice(2 * hdv, 2 * hdv + hq),
                 slice(2 * hdv + hq, None)):
        assert _share(d_y[..., cols], want_dy[..., cols]) <= 2e-2, cols
    assert _share(d_attn, want_dattn) <= 2e-2 and _share(attn, want_attn) <= 2e-2
    assert (dbias is None) == (want_db is None)
    assert dbias is None or _share(dbias, want_db) <= 2e-2
    for a, b in zip(runs[0], runs[1]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_k4_tensor_core_route_and_counters(cuda):
    """bf16 at the tensor-core widths takes the bf16 route in both directions
    (`.tc_launches`, one launch of each stage kernel), f32 there the 3xTF32
    route (one launch of each f32 stage); the linear activation takes
    neither; the softmax backward stays off both, and f32 softmax entirely."""
    hbt = hstu_block_train
    fwd, bwd = hbt.fused_train_block_forward, hbt.attn_backward
    stages = (hbt.train_attention_oinput, hbt.attn_bwd_rows, hbt.attn_bwd_dq, hbt.attn_bwd_dkv)
    f32_stages = (hbt.tf32_project, hbt.tf32_attention, hbt.tf32_out_gemm, hbt.tf32_bwd_rows,
                  hbt.tf32_bwd_dq, hbt.tf32_bwd_dkv)
    for variant, dtype, tc_f, tc_b in (("no_bias", torch.bfloat16, 1, 1),
                                       ("softmax", torch.bfloat16, 1, 0),
                                       ("act_none", torch.bfloat16, 0, 0),
                                       ("no_bias", torch.float32, 1, 1),
                                       ("act_none", torch.float32, 0, 0),
                                       ("softmax", torch.float32, 0, 0)):
        args, meta = _k4_variant_block(variant, "n33_padded", dtype, cuda)
        counters = lambda: ([fwd.tc_launches, bwd.tc_launches]  # noqa: E731
                            + [f.launches for f in stages + f32_stages])
        before = counters()
        x = args["x"].clone().requires_grad_(True)
        out = hbt.fused_train_block(x, args["rel_pos"], args["tsw"], args["uvqk"],
                                    args["o_kernel"], args["o_bias"], args["colmask"],
                                    args["ext"], 11, meta)
        out.float().sum().backward()
        bf = dtype == torch.bfloat16
        want = ([tc_f, tc_b] + [tc_f * bf] + [tc_b * bf] * 3 + [tc_f * (not bf)] * 3
                + [tc_b * (not bf)] * 3)
        assert [a - b for a, b in zip(counters(), before)] == want, (variant, dtype)


# K4's f32 route (3xTF32): ML-20M's block and ML-1M's odd widths (D, h, dqk,
# dv), n = 211.
K4_TF32_SHAPES = {"ml20m": (256, 8, 32, 32), "ml1m": (50, 2, 25, 25)}


@pytest.mark.parametrize("seed", range(1, 9))
@pytest.mark.parametrize("shape", list(K4_TF32_SHAPES))
def test_k4_f32_route_matches_plain_over_seeds(cuda, shape, seed):
    """The f32 block on its 3xTF32 route against autograd of the plain
    forward over seeds 1-8: the forward within K4's (1e-3, 1e-4) and every
    gradient within 1e-3 of its largest value; both directions on the route
    (`.tc_launches`)."""
    d, h, dqk, dv = K4_TF32_SHAPES[shape]
    args, kw = _k1_args(4, 211, d, h, dqk, dv, 211, torch.float32, cuda, seed=seed)
    args["x"] = args["x"] * args["colmask"][..., None]
    meta = hstu_block_train.BlockMeta(h, dqk, dv, kw["inv_n"], kw["eps"], 128, 0.2)
    assert hstu_block_train.tf32_fwd_route(torch.float32, d, 211, meta)
    fwd, bwd = hstu_block_train.fused_train_block_forward, hstu_block_train.attn_backward
    w = torch.cos(torch.arange(args["x"].numel(), device=cuda, dtype=torch.float32)).reshape(
        args["x"].shape)
    res = []
    for fn in (hstu_block_train.fused_train_block,
               hstu_block_train.fused_train_block_autograd_reference):
        before = (fwd.tc_launches, bwd.tc_launches)
        leaves = [args[k].clone().requires_grad_(True) for k in GRAD_NAMES]
        out = fn(*leaves, args["colmask"], args["ext"], seed, meta)
        (out * w).sum().backward()
        res.append((out.detach(), [t.grad for t in leaves], (fwd.tc_launches - before[0],
                                                             bwd.tc_launches - before[1])))
    assert res[0][2] == (1, 1) and res[1][2] == (0, 0)
    torch.testing.assert_close(res[0][0], res[1][0], rtol=1e-3, atol=1e-4)
    for name, got, want in zip(GRAD_NAMES, res[0][1], res[1][1]):
        assert ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item() <= 1e-3, name


@pytest.mark.parametrize("shape", list(K4_TF32_SHAPES))
def test_k4_f32_route_repeats_bit_for_bit(cuda, shape):
    """Two calls of each f32-route stage give the same bits: no atomics, one
    writer per output element."""
    hbt = hstu_block_train
    d, h, dqk, dv = K4_TF32_SHAPES[shape]
    args, kw = _k1_args(3, 211, d, h, dqk, dv, 211, torch.float32, cuda, seed=5)
    meta = hbt.BlockMeta(h, dqk, dv, kw["inv_n"], kw["eps"], 128, 0.2, attn_rate=0.2)
    tables = (args["rel_pos"], args["ext"], args["tsw"])
    d_o = torch.randn(3, 211, meta.o_width, device=cuda)
    runs = []
    for _ in range(2):
        y = hbt.tf32_project(args["x"], args["uvqk"], meta)
        attn = hbt.tf32_attention(y, args["colmask"], *tables, 11, meta)
        out = hbt.tf32_out_gemm(args["x"], y, attn, args["o_kernel"], args["o_bias"], 11, meta)
        d_y, d_attn = hbt.tf32_bwd_rows(y, d_o, attn, meta)
        d_y, dbias = hbt.tf32_bwd_dq(y, d_attn, args["colmask"], *tables, meta, 11, d_y)
        d_y = hbt.tf32_bwd_dkv(y, d_attn, args["colmask"], *tables, meta, 11, d_y)
        runs.append((y, attn, out, d_attn, d_y, dbias))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_k4_f32_entry_points_refuse_against_the_route(cuda):
    """The 3xTF32 entry points refuse every instance outside the route (dqk =
    64, h = 5, n = 513; D = 273 for the GEMMs) and the CUDA-core ones the f32
    instances on it (n = 8, and the combined preprocessor's n = 422):
    cudaErrorInvalidValue (1), nothing launched; the wrappers raise off the
    route."""
    from rails_tpu_torch.ops import _build

    lib = _build.load_library()
    buf = torch.zeros(1 << 20, device=cuda)
    p = buf.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.rails_hstu_tf32_project(p, p, p, 1, 8, 273, 2, 16, 16, 1e-6, stream) == 1
    assert lib.rails_hstu_tf32_out(p, p, p, p, p, p, 1, 8, 273, 2, 16, 16, 1e-6, 0, 0, 0, 0, 1.0,
                                   stream) == 1
    for h, dqk, n in ((2, 64, 8), (5, 16, 8), (2, 16, 513)):
        assert lib.rails_hstu_tf32_project(p, p, p, 1, n, 64, h, dqk, dqk, 1e-6, stream) == 1
        assert lib.rails_hstu_tf32_attention(p, p, None, None, None, p, 1, n, h, dqk, dqk, 0.1, 127,
                                             0, 0, 0, 0, 1.0, stream) == 1
        assert lib.rails_hstu_tf32_out(p, p, p, p, p, p, 1, n, 64, h, dqk, dqk, 1e-6, 0, 0, 0, 0,
                                       1.0, stream) == 1
        for stage in range(3):
            assert lib.rails_hstu_tf32_bwd(stage, p, p, p, p, p, p, None, p, None, None, None, 1, n,
                                           h, dqk, dqk, 0.1, 1e-6, 127, 0, 0, 0, 0, 0, 1.0,
                                           stream) == 1
    drop = (0, 0, 0, 1.0, 0, 0, 1.0)
    for n in (8, 422):
        assert lib.rails_hstu_train_fwd(0, p, p, p, p, p, None, None, None, p, p, p, 1, n, 64, 2,
                                        16, 16, 0.125, 0.25, 1e-6, 127, 0, 0, 0, 0, *drop,
                                        stream) == 1
        assert lib.rails_hstu_train_bwd(0, p, p, p, p, p, p, p, p, p, p, 1, n, 2, 16, 16, 0.125,
                                        1e-6, 127, 0, 0, 1, 0, 0, 0, 1.0, stream) == 1
    torch.cuda.synchronize()
    args, meta = _k4_variant_block("softmax", "n1", torch.float32, cuda)
    with pytest.raises(ValueError, match="no 3xTF32 instance"):
        hstu_block_train.tf32_project(args["x"], args["uvqk"], meta)


def test_k4_library_refuses_a_route_against_the_width_rule(cuda):
    """The CUDA-core entry points refuse the bf16 SiLU instances at the
    tensor-core widths, and the tensor-core ones every width outside them
    (dqk = dv = 64): cudaErrorInvalidValue (1), nothing launched."""
    from rails_tpu_torch.ops import _build

    lib = _build.load_library()
    b, n, d, h = 1, 8, 64, 2
    buf = torch.zeros(1 << 20, device=cuda)
    p = buf.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    drop = (0, 0, 0, 1.0, 0, 0, 1.0)
    for dqk, want in ((16, 1), (64, None)):
        err = lib.rails_hstu_train_fwd(1, p, p, p, p, p, None, None, None, p, p, p, b, n, d, h, dqk,
                                       dqk, 1.0 / n, 0.25, 1e-6, 127, 0, 0, 0, 0, *drop, stream)
        assert (err == want) if want else err == 0, (dqk, err)
        err = lib.rails_hstu_train_bwd(1, p, p, p, p, p, p, p, p, p, p, b, n, h, dqk, dqk,
                                       1.0 / n, 1e-6, 127, 0, 0, 1, 0, 0, 0, 1.0, stream)
        assert (err == want) if want else err == 0, (dqk, err)
    torch.cuda.synchronize()
    assert lib.rails_hstu_tc_train_attention(p, p, p, None, None, None, p, p, b, n, h, 64, 64, 0.125,
                                             1e-6, 127, 0, 0, 0, 0, 0, 0, 1.0, 0, 0, 1.0,
                                             stream) == 1
    for stage in range(3):
        assert lib.rails_hstu_tc_train_bwd(stage, p, p, p, p, p, p, None, p, None, None, None, b,
                                           n, h, 64, 64, 1.0 / n, 1e-6, 127, 0, 0, 0, 0, 0, 1.0,
                                           stream) == 1
    with pytest.raises(ValueError, match="no tensor-core instance"):
        args, meta = _k4_variant_block("no_bias", "n1", torch.float32, cuda)
        hstu_block_train.attn_bwd_rows(torch.zeros(1, 1, 128, device=cuda),
                                       torch.zeros(1, 1, 32, device=cuda), args["colmask"], None,
                                       None, None, meta)


@pytest.mark.parametrize("numel", [1, 7, 4099, 1_000_003, (26_745 * 256)])
def test_k7_matches_plain_and_torch_fused_adamw(cuda, numel):
    g = torch.Generator(device=cuda).manual_seed(numel)
    grad = 1e-2 * torch.randn(numel, generator=g, device=cuda)
    p = torch.randn(numel, generator=g, device=cuda)
    mu = 1e-3 * torch.randn(numel, generator=g, device=cuda)
    nu = 1e-5 * torch.rand(numel, generator=g, device=cuda)
    count = 4
    c1, c2 = 1.0 / (1.0 - 0.9 ** count), 1.0 / (1.0 - 0.98 ** count)
    kw = dict(lr=1e-3, c1=c1, c2=c2, b1=0.9, b2=0.98, eps=1e-8, wd=1e-3)
    got = [t.clone() for t in (p, mu, nu)]
    ref = [t.clone() for t in (p, mu, nu)]
    before = fused_adamw.adamw_update_leaves.launches
    fused_adamw.adamw_leaf_update(grad, *got, **kw)
    assert fused_adamw.adamw_update_leaves.launches == before + 1
    fused_adamw.adamw_leaf_update_reference(grad, *ref, **kw)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    lib = [t.clone() for t in (p, mu, nu)]
    torch._fused_adamw_([lib[0]], [grad], [lib[1]], [lib[2]], [],
                        [torch.tensor(float(count), device=cuda)], lr=1e-3, beta1=0.9,
                        beta2=0.98, weight_decay=1e-3, eps=1e-8, amsgrad=False, maximize=False)
    torch.testing.assert_close(got[0], lib[0], rtol=1e-6, atol=1e-6)


K7_NUMELS = (1, 7, 4099, 1_000_003, 26_745 * 256)


def _k7_leaves(device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    return [(1e-2 * torch.randn(n, generator=g, device=device),
             torch.randn(n, generator=g, device=device),
             1e-3 * torch.randn(n, generator=g, device=device),
             1e-5 * torch.rand(n, generator=g, device=device)) for n in K7_NUMELS]


def test_k7_updates_every_leaf_in_one_launch(cuda):
    kw = dict(lr=1e-3, c1=1.0 / (1.0 - 0.9**4), c2=1.0 / (1.0 - 0.98**4), b1=0.9, b2=0.98,
              eps=1e-8, wd=1e-3)
    leaves = _k7_leaves(cuda)
    got = [(g, *(t.clone() for t in rest)) for g, *rest in leaves]
    ref = [(g, *(t.clone() for t in rest)) for g, *rest in leaves]
    before = fused_adamw.adamw_update_leaves.launches
    fused_adamw.adamw_update_leaves(got, **kw)
    assert fused_adamw.adamw_update_leaves.launches == before + 1
    fused_adamw.adamw_update_leaves_reference(ref, **kw)
    for n, a, b in zip(K7_NUMELS, got, ref):
        for x, y in zip(a[1:], b[1:]):
            assert torch.equal(x, y), n     # the same separately rounded f32 operations


def test_k7_takes_more_leaves_than_its_table_in_more_launches(cuda):
    kw = dict(lr=1e-3, c1=10.0, c2=50.0, b1=0.9, b2=0.98, eps=1e-8, wd=1e-3)
    g = torch.Generator(device=cuda).manual_seed(50)
    leaves = [tuple(torch.rand(1000 + k, generator=g, device=cuda) for _ in range(4))
              for k in range(fused_adamw.MAX_LEAVES + 2)]
    got = [(gr, *(t.clone() for t in rest)) for gr, *rest in leaves]
    ref = [(gr, *(t.clone() for t in rest)) for gr, *rest in leaves]
    before = fused_adamw.adamw_update_leaves.launches
    fused_adamw.adamw_update_leaves(got, **kw)
    assert fused_adamw.adamw_update_leaves.launches == before + 2
    fused_adamw.adamw_update_leaves_reference(ref, **kw)
    assert all(torch.equal(x, y) for a, b in zip(got, ref) for x, y in zip(a, b))


def test_k7_rejects_misaligned_or_non_f32_leaves(cuda):
    kw = dict(lr=1e-3, c1=10.0, c2=50.0, b1=0.9, b2=0.98, eps=1e-8, wd=1e-3)
    leaves = _k7_leaves(cuda)[:3]
    g, p, mu, nu = leaves[2]
    misaligned = (g[1:], p[1:], mu[1:], nu[1:])
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_adamw.adamw_update_leaves(leaves[:2] + [misaligned], **kw)
    with pytest.raises(ValueError, match="contiguous f32"):
        fused_adamw.adamw_update_leaves(leaves[:2] + [(g, p.double(), mu, nu)], **kw)


def test_train_step_on_cuda_matches_cpu(cuda, monkeypatch):
    """One synthetic-small train step through the kernels and through the
    plain versions on the CPU, from the same weights and negatives with every
    dropout off: the same loss and gradients."""
    from rails_tpu_torch.losses import samplers

    cfg = get_experiment_config("synthetic-small")
    cfg = cfg.replace(
        hstu=cfg.hstu.replace(fused_train=True, linear_dropout_rate=0.0),
        train=cfg.train.replace(dropout_rate=0.0, num_negatives=16),
        mol=cfg.mol.replace(uid_dropout_rate=0.0, item_dropout_rate=0.0,
                            softmax_dropout_rate=0.0),
    )
    num_items = 300
    seqs = generate_synthetic_sequences(num_users=64, num_items=num_items, max_len=34, seed=2)
    ds = SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1)
    all_ids = np.arange(1, num_items + 1, dtype=np.int32)
    negatives = np.random.default_rng(0).integers(1, num_items + 1, (16 * 34, 16)).astype(np.int32)
    out = {}
    for device in ("cpu", cuda):
        monkeypatch.setattr(samplers.LocalNegativesSampler, "sample",
                            lambda self, gen, shape, d=device: torch.from_numpy(negatives).to(d))
        model, state, step, _ = create_train_state(cfg, num_items, all_ids, seed=0, device=device)
        batch = next(ds.batches(16, cfg.train.gr_output_length + 1, shuffle=False, device=device))
        _, m = step(state, batch, torch.Generator(device=device).manual_seed(0))
        out[str(device)] = (m["loss"].item(), {k: p.grad.cpu() for k, p in model.named_parameters()})
    (loss_c, g_c), (loss_g, g_g) = out["cpu"], out[str(cuda)]
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)
    for k in g_c:
        torch.testing.assert_close(g_g[k], g_c[k], rtol=5e-3, atol=1e-4, msg=k)


K5_NAMES = ("q_comp", "qp", "item_comp", "ip", "w1", "b1", "w2", "b2")


def _k5_args(m, r, p_q, p_x, d_p, h, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    l = p_q * p_x
    args = (
        l2_normalize(torch.randn(m, p_q, d_p, generator=g)), torch.randn(m, l, generator=g),
        l2_normalize(torch.randn(r, p_x, d_p, generator=g)), torch.randn(r, l, generator=g),
        torch.randn(l, h, generator=g) / l**0.5, 0.1 * torch.randn(1, h, generator=g),
        torch.randn(h, l, generator=g) / h**0.5, 0.1 * torch.randn(1, l, generator=g),
    )
    return [a.to(device) for a in args]


def _k5_route_launches(dtype, geom):
    """(launches, tc_launches) that one call of a K5 wrapper must add: the
    tensor-core route exactly where `tc_route` takes the geometry."""
    p_q, p_x, d_p, h = geom
    return 1, int(mol_loss_train.tc_route(dtype, p_q, p_x, d_p, h))


def _k5_counts():
    return tuple((f.launches, f.tc_launches) for f in (mol_loss_train.fused_mol_loss_forward,
                                                       mol_loss_train.fused_mol_loss_backward))


@pytest.mark.parametrize(
    "m,r,geom,pi_rate,qi_rate",
    [(1, 1, (4, 2, 16, 24), 0.2, 0.0), (13, 37, (4, 2, 16, 24), 0.0, 0.0),
     (20, 130, (4, 2, 16, 24), 0.2, 0.1), (24, 40, (4, 2, 16, 24), 0.9, 0.0),
     (9, 128, (8, 4, 128, 128), 0.2, 0.1), (300, 200, (8, 4, 128, 128), 0.5, 0.3),
     (13, 37, (8, 8, 32, 128), 0.2, 0.1), (300, 520, (8, 8, 32, 128), 0.2, 0.0),
     (77, 130, (8, 4, 64, 128), 0.2, 0.1), (5, 3, (8, 4, 64, 128), 0.9, 0.0),
     (40, 70, (8, 4, 120, 64), 0.2, 0.1)],
    ids=["one_pair", "rate0", "padded", "clamps_at_eps", "ml20m_small", "ml20m_many_blocks",
         "books_small", "books_many_blocks", "ml1m_small", "ml1m_clamps_at_eps",
         "dp120_h64"],
)
def test_k5_matches_plain(cuda, m, r, geom, pi_rate, qi_rate):
    """Forward and the 8 gradients of the K5 kernels against the plain
    forward and backward, at M not a multiple of 8, R not a multiple of 16, 32
    or 128, and a softmax-dropout rate at which many pairs' renorm clamps at
    eps; each call on the route `tc_route` names (`.tc_launches`): the
    tensor cores (3xTF32) at P_Q = 8, P_X = 4, the CUDA cores at 4x2 and
    H = 24."""
    p_q, p_x, d_p, h = geom
    args = _k5_args(m, r, p_q, p_x, d_p, h, cuda, seed=m)
    kw = dict(p_q=p_q, p_x=p_x, temperature=0.05, qi_rate=qi_rate, pi_rate=pi_rate, eps=1e-6)
    cot = torch.randn(m, r, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = _k5_counts()
    got = mol_loss_train.fused_mol_loss_forward(*args, -1234567, **kw)
    grads = mol_loss_train.fused_mol_loss_backward(*args, -1234567, cot, **kw)
    add = _k5_route_launches(torch.float32, geom)
    assert _k5_counts() == tuple((b[0] + add[0], b[1] + add[1]) for b in before)
    want = mol_loss_train.fused_mol_loss_forward_reference(*args, -1234567, **kw)
    want_grads = mol_loss_train.fused_mol_loss_backward_reference(*args, -1234567, cot, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)   # logits carry 1/T = 20
    for name, a, b in zip(K5_NAMES, grads, want_grads):
        assert a.shape == b.shape, name
        scale = b.abs().max().clamp_min(1e-30)
        assert ((a - b).abs().max() / scale).item() <= 1e-3, name


@pytest.mark.parametrize(
    "m,r,geom,pi_rate,qi_rate",
    [(1, 1, (4, 2, 16, 24), 0.2, 0.0), (20, 130, (4, 2, 16, 24), 0.2, 0.1),
     (9, 128, (8, 4, 128, 128), 0.2, 0.1), (13, 37, (8, 8, 32, 128), 0.2, 0.1),
     (300, 520, (8, 8, 32, 128), 0.0, 0.0), (70, 33, (8, 8, 128, 96), 0.2, 0.1),
     (13, 37, (8, 8, 32, 24), 0.2, 0.1)],
    ids=["one_pair", "padded", "ml20m_small", "books_small", "books_many_blocks",
         "px8_dp128_h96", "books_h24"],
)
def test_k5_bf16_matches_plain(cuda, m, r, geom, pi_rate, qi_rate):
    """The bf16 K5 (bf16 operands, f32 weights, the qi MLP in bf16) against
    the bf16 plain versions, which round at the same points and sum in other
    orders: the forward within 2e-2 and each gradient within 3e-2 of its
    largest value, gradients in the operands' dtypes; `.bf16_launches` counts,
    and `.tc_launches` where `tc_route` takes the geometry (P_Q = 8)."""
    p_q, p_x, d_p, h = geom
    args = _k5_args(m, r, p_q, p_x, d_p, h, cuda, seed=m)
    args = [a.bfloat16() for a in args[:4]] + args[4:]
    kw = dict(p_q=p_q, p_x=p_x, temperature=0.05, qi_rate=qi_rate, pi_rate=pi_rate, eps=1e-6)
    cot = torch.randn(m, r, generator=torch.Generator().manual_seed(1)).to(cuda)
    fwd, bwd = mol_loss_train.fused_mol_loss_forward, mol_loss_train.fused_mol_loss_backward
    before = (fwd.bf16_launches, bwd.bf16_launches)
    before_tc = _k5_counts()
    got = fwd(*args, 77, **kw)
    grads = bwd(*args, 77, cot, **kw)
    assert (fwd.bf16_launches, bwd.bf16_launches) == (before[0] + 1, before[1] + 1)
    add = _k5_route_launches(torch.bfloat16, geom)
    assert _k5_counts() == tuple((b[0] + add[0], b[1] + add[1]) for b in before_tc)
    want = mol_loss_train.fused_mol_loss_forward_reference(*args, 77, **kw)
    want_grads = mol_loss_train.fused_mol_loss_backward_reference(*args, 77, cot, **kw)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-2
    for name, a, b, x in zip(K5_NAMES, grads, want_grads, args):
        assert a.dtype == b.dtype == x.dtype and a.shape == b.shape, name
        scale = b.float().abs().max().clamp_min(1e-30)
        assert ((a.float() - b.float()).abs().max() / scale).item() <= 3e-2, name


# One geometry per K5 route: (dtype, m, r, (P_Q, P_X, d_P, H)).
K5_ROUTES = {
    "tc_f32": (torch.float32, 300, 200, (8, 4, 128, 128)),
    "tc_bf16": (torch.bfloat16, 300, 520, (8, 8, 32, 128)),
    "cuda_core_f32": (torch.float32, 20, 130, (4, 2, 16, 24)),
    "cuda_core_bf16": (torch.bfloat16, 13, 37, (8, 8, 32, 24)),
}


def _k5_route_case(route, device):
    dtype, m, r, geom = K5_ROUTES[route]
    p_q, p_x, d_p, h = geom
    args = _k5_args(m, r, p_q, p_x, d_p, h, device, seed=m)
    args = [a.to(dtype) for a in args[:4]] + args[4:]
    kw = dict(p_q=p_q, p_x=p_x, temperature=0.05, qi_rate=0.1, pi_rate=0.2, eps=1e-6)
    cot = torch.randn(m, r, generator=torch.Generator().manual_seed(1)).to(device)
    return args, kw, cot


@pytest.mark.parametrize("route", list(K5_ROUTES))
def test_k5_backward_repeats_bit_for_bit(cuda, route):
    """No floating-point atomics on either route: two backward calls (and two
    forward calls) on the same inputs give the same bits."""
    args, kw, cot = _k5_route_case(route, cuda)
    assert mol_loss_train.tc_route(args[0].dtype, kw["p_q"], kw["p_x"], args[0].shape[2],
                                   args[4].shape[1]) == route.startswith("tc")
    for fn, extra in ((mol_loss_train.fused_mol_loss_forward, ()),
                      (mol_loss_train.fused_mol_loss_backward, (cot,))):
        a = fn(*args, 5, *extra, **kw)
        b = fn(*args, 5, *extra, **kw)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y), fn.__name__


def _k5_errors(got, got_grads, want, want_grads):
    """max|kernel - plain| over max|plain| of the forward and of each gradient."""
    def share(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()
    return [share(got, want)] + [share(a, b) for a, b in zip(got_grads, want_grads)]


@pytest.mark.parametrize("fault", ["w2_rows_swapped", "pi_mask_bit_flipped",
                                   "qi_mask_bit_flipped"])
@pytest.mark.parametrize("route", ["tc_f32", "tc_bf16"])
def test_k5_tolerance_catches_seeded_faults(cuda, route, fault, monkeypatch):
    """The tolerances the kernel meets reject a seeded fault: the kernel run
    with W2's rows 0 and 1 swapped, or held to a plain version whose dropout
    mask has one bit flipped (the kept logit of largest softmax weight in the
    pi stream, of largest |t| in the qi stream), lies outside them (f32:
    rtol 1e-4 / atol 1e-3 forward, 1e-3 gradients; bf16: 2e-2 / 3e-2)."""
    args, kw, cot = _k5_route_case(route, cuda)
    bf16 = args[0].dtype == torch.bfloat16
    plain = [mol_loss_train.fused_mol_loss_forward_reference(*args, 5, **kw),
             mol_loss_train.fused_mol_loss_backward_reference(*args, 5, cot, **kw)]
    if fault == "w2_rows_swapped":
        bad = list(args)
        bad[6] = args[6][[1, 0] + list(range(2, args[6].shape[0]))].contiguous()
        got = mol_loss_train.fused_mol_loss_forward(*bad, 5, **kw)
        got_grads = mol_loss_train.fused_mol_loss_backward(*bad, 5, cot, **kw)
    else:
        got = mol_loss_train.fused_mol_loss_forward(*args, 5, **kw)
        got_grads = mol_loss_train.fused_mol_loss_backward(*args, 5, cot, **kw)
        salt = hash_dropout.PI_SALT if fault.startswith("pi") else hash_dropout.QI_SALT
        f = mol_loss_train._forward_parts(*args, 5, **kw)
        weight = f["p"] if salt == hash_dropout.PI_SALT else f["t"].abs()
        true_mask = mol_loss_train.loss_mask

        def flipped(seed, s, m, r, p_q, p_x, rate, device):
            mask = true_mask(seed, s, m, r, p_q, p_x, rate, device)
            if s == salt:
                mask = mask.contiguous().clone()
                at = torch.argmax(torch.where(mask > 0, weight, -1.0))
                mask.view(-1)[at] = 0.0
            return mask

        monkeypatch.setattr(mol_loss_train, "loss_mask", flipped)
        plain = [mol_loss_train.fused_mol_loss_forward_reference(*args, 5, **kw),
                 mol_loss_train.fused_mol_loss_backward_reference(*args, 5, cot, **kw)]
    errs = _k5_errors(got, got_grads, *plain)
    if bf16:
        outside = errs[0] > 2e-2 or max(errs[1:]) > 3e-2
    else:
        fwd_ok = torch.allclose(got, plain[0], rtol=1e-4, atol=1e-3)
        outside = not fwd_ok or max(errs[1:]) > 1e-3
    assert outside, (fault, errs)


def test_k5_rejects_what_it_has_no_instance_for(cuda):
    args = _k5_args(8, 16, 2, 2, 16, 8, cuda)
    kw = dict(p_q=2, p_x=2, temperature=0.05, qi_rate=0.0, pi_rate=0.0, eps=1e-6)
    with pytest.raises(NotImplementedError, match="no kernel instance"):
        mol_loss_train.fused_mol_loss_forward(*args, 0, **kw)
    args = _k5_args(8, 16, 4, 2, 16, 8, cuda)
    kw.update(p_q=4)
    mixed = [args[0].bfloat16()] + args[1:]      # bf16 queries against f32 items
    with pytest.raises(NotImplementedError, match="all f32 or all bf16"):
        mol_loss_train.fused_mol_loss_forward(*mixed, 0, **kw)


K6_BOOKS = [f"books_{r}_{o}" for r in ("f32", "bf16") for o in ("f32", "bf16")]


def _k6_case(case):
    """(ids, rows, num_rows, out_dtype) of a K6 case, on the CPU."""
    g = torch.Generator().manual_seed(len(case))
    num_rows, d, out_dtype = 300, 128, torch.float32
    if case == "duplicates":
        ids = torch.randint(0, 7, (6, 50), generator=g)
    elif case == "wrap_and_drop":
        ids = torch.randint(-num_rows - 20, num_rows + 20, (4, 77), generator=g)
    elif case == "empty":
        ids = torch.zeros(0, dtype=torch.int64)
    elif case == "narrow":
        num_rows, d = 97, 40
        ids = torch.randint(-5, num_rows, (3, 31), generator=g)
    elif case == "ml20m":      # padding id 0 owns ~60% of the batch: a run of many pieces
        num_rows, d = 26_745, 256
        ids = torch.randint(0, num_rows, (128, 211), generator=g)
        ids = torch.where(torch.rand(128, 211, generator=g) < 0.6, 0, ids)
    elif case == "one_id":     # 1,000 entries of one row: 4 pieces of <= 256
        ids = torch.full((1000,), 17)
    elif case.startswith("books"):   # Amazon Books: (64, 61) ids into (695,763, 64)
        num_rows, d = 695_763, 64
        ids = torch.randint(0, num_rows, (64, 61), generator=g)
        ids = torch.where(torch.rand(64, 61, generator=g) < 0.57, 0, ids)
        out_dtype = torch.bfloat16 if case.endswith("bf16") else torch.float32
    elif case == "long_runs":  # runs just past the in-warp sort limit (32) and the piece (256)
        runs = ((5, 33), (9, 32), (11, 257), (12, 513))
        ids = torch.cat([torch.full((n,), r) for r, n in runs])
        ids = ids[torch.randperm(ids.numel(), generator=g)]
    elif case == "many_long_rows":  # 700 rows of 33-96 updates each: ~45,000 ids, 11 chunks
        counts = torch.randint(33, 97, (700,), generator=g)
        ids = torch.repeat_interleave(torch.arange(700), counts)
        ids = ids[torch.randperm(ids.numel(), generator=g)]
    elif case == "odd_width":  # D % 4 != 0: one value a lane
        num_rows, d = 97, 30
        ids = torch.randint(-5, num_rows, (3, 31), generator=g)
        ids[0, :9] = 7      # one row with 9 updates
    elif case == "one_row":
        num_rows = 1
        ids = torch.randint(-1, 1, (5, 40), generator=g)
    elif case == "all_dropped":
        ids = torch.cat([torch.randint(num_rows, 2 * num_rows, (50,), generator=g),
                         torch.randint(-3 * num_rows, -num_rows, (50,), generator=g)])
    else:
        ids = torch.randint(0, num_rows, (2, 64), generator=g)
    rows = torch.randn(ids.shape + (d,), generator=g)
    if case == "bf16" or case.startswith("books_bf16"):
        rows = rows.bfloat16()
    return ids.to(torch.int32), rows, num_rows, out_dtype


@pytest.mark.parametrize("case", ["duplicates", "wrap_and_drop", "empty", "narrow", "bf16",
                                  "ml20m", "one_id", *K6_BOOKS, "long_runs", "many_long_rows",
                                  "odd_width", "one_row", "all_dropped"])
def test_k6_matches_plain(cuda, case):
    ids, rows, num_rows, out_dtype = _k6_case(case)
    ids, rows = ids.to(cuda), rows.to(cuda)
    d = rows.shape[-1]
    before = scatter_add.scatter_add_rows.launches
    got = scatter_add.scatter_add_rows(ids, rows, num_rows, out_dtype=out_dtype)
    assert scatter_add.scatter_add_rows.launches == before + 1
    want = scatter_add.scatter_add_rows_reference(ids, rows, num_rows, out_dtype=out_dtype)
    assert got.dtype == want.dtype == out_dtype and got.shape == want.shape
    # Both sum in f32, in other orders where ids repeat (up to ~16k times here):
    # each within the recursive-summation bound n_t * 2^-24 * sum |x| of row t;
    # a bf16 table rounds both f32 sums once more (2^-8 of the value).
    flat = ids.reshape(-1).long()
    flat = torch.where(flat < 0, flat + num_rows, flat)
    keep = (flat >= 0) & (flat < num_rows)
    mass = torch.zeros(num_rows, d, dtype=torch.float64, device=cuda).index_add_(
        0, flat[keep], rows.reshape(-1, d)[keep].double().abs())
    count = torch.bincount(flat[keep], minlength=num_rows).double()[:, None]
    tol = 2 * count * 2.0**-24 * mass
    if out_dtype == torch.bfloat16:
        tol = tol + 2.0**-8 * want.double().abs()
    assert bool(((got.double() - want.double()).abs() <= tol).all())
    if case == "all_dropped":
        assert not bool(got.any())


@pytest.mark.parametrize("case", ["ml20m", "one_id", "long_runs", "many_long_rows"])
def test_k6_two_calls_give_the_same_bits(cuda, case):
    ids, rows, num_rows, out_dtype = _k6_case(case)
    ids, rows = ids.to(cuda), rows.to(cuda)
    first = scatter_add.scatter_add_rows(ids, rows, num_rows, out_dtype=out_dtype)
    assert torch.equal(first, scatter_add.scatter_add_rows(ids, rows, num_rows,
                                                           out_dtype=out_dtype))


def test_fast_train_step_on_cuda_matches_cpu(cuda, monkeypatch):
    """One synthetic-small -fast step (shared negatives, K5, K6) through the
    kernels and through the plain versions on the CPU, from the same weights
    and (R,) negatives with every dropout off: the same loss and gradients."""
    from rails_tpu_torch.losses import samplers

    cfg = get_experiment_config("synthetic-small")
    cfg = cfg.replace(
        hstu=cfg.hstu.replace(fused_train=True, linear_dropout_rate=0.0),
        train=cfg.train.replace(dropout_rate=0.0, num_negatives=40, shared_negatives=True,
                                fused_mol_loss=True, pallas_scatter_grad=True),
        mol=cfg.mol.replace(uid_dropout_rate=0.0, item_dropout_rate=0.0,
                            softmax_dropout_rate=0.0),
    )
    num_items = 300
    seqs = generate_synthetic_sequences(num_users=64, num_items=num_items, max_len=34, seed=2)
    ds = SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1)
    all_ids = np.arange(1, num_items + 1, dtype=np.int32)
    negatives = np.random.default_rng(0).integers(1, num_items + 1, (40,)).astype(np.int32)
    out = {}
    for device in ("cpu", cuda):
        monkeypatch.setattr(samplers.LocalNegativesSampler, "sample",
                            lambda self, gen, shape, d=device: torch.from_numpy(negatives).to(d))
        model, state, step, _ = create_train_state(cfg, num_items, all_ids, seed=0, device=device)
        batch = next(ds.batches(16, cfg.train.gr_output_length + 1, shuffle=False, device=device))
        before = (mol_loss_train.fused_mol_loss_forward.launches,
                  scatter_add.scatter_add_rows.launches)
        _, m = step(state, batch, torch.Generator(device=device).manual_seed(0))
        launched = (mol_loss_train.fused_mol_loss_forward.launches - before[0],
                    scatter_add.scatter_add_rows.launches - before[1])
        assert launched == ((0, 0) if device == "cpu" else (1, 3))
        out[str(device)] = (m["loss"].item(), {k: p.grad.cpu() for k, p in model.named_parameters()})
    (loss_c, g_c), (loss_g, g_g) = out["cpu"], out[str(cuda)]
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)
    for k in g_c:
        torch.testing.assert_close(g_g[k], g_c[k], rtol=5e-3, atol=1e-4, msg=k)


# The K1/K4 instances of the rated and combined preprocessors at ML-20M
# widths (b, n, D, h, dqk, dv, max_seq_len): the rated one widens D to
# 256 + 8 = 264, the combined one doubles n to 2 x 211 = 422; and the edges
# of the tensor-core routes that take them, D = 272 and n = 512 (K1's f32
# pointwise attention and K4's 32-row attention blocks at their longest).
PREPROC_SHAPES = {"rated": (2, 211, 264, 8, 32, 32, 211),
                  "combined": (2, 422, 256, 8, 32, 32, 422),
                  "d272": (2, 40, 272, 8, 32, 32, 40),
                  "n512": (1, 512, 256, 8, 32, 32, 512)}


def _k1_route_counts():
    return (hstu_block.project.launches, hstu_block.tf32_project.launches,
            hstu_block.fused_hstu_block.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("instance", list(PREPROC_SHAPES))
def test_k1_preprocessor_instances_match_plain(cuda, instance, dtype):
    """K1 at the rated width, the combined length and the routes' edges (D =
    272, n = 512), against its plain version, on the tensor cores: bf16
    through `project` and its two other stages, f32 through the 3xTF32
    stages (`tf32_project`)."""
    b, n, d, h, dqk, dv, max_seq_len = PREPROC_SHAPES[instance]
    args, kw = _k1_args(b, n, d, h, dqk, dv, max_seq_len, dtype, cuda, seed=n)
    tc = hstu_block.tc_block(dtype, d, h, dqk, dv, "silu")
    tf32 = hstu_block.tf32_block(dtype, d, n, h, dqk, dv, "silu")
    assert (tc, tf32) == ((True, False) if dtype == torch.bfloat16 else (False, True))
    before = _k1_route_counts()
    got = hstu_block.fused_hstu_block(**args, **kw)
    launched = tuple(a - c for a, c in zip(_k1_route_counts(), before))
    assert launched == (int(tc), int(tf32), 1)
    want = hstu_block.fused_hstu_block_reference(**args, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("instance", list(PREPROC_SHAPES))
def test_k4_preprocessor_instances_match_plain(cuda, instance, dtype, monkeypatch):
    """K4 (forward and attention backward) at the rated width, the combined
    length and the routes' edges (D = 272, n = 512) against its plain
    version, at the default instance's tolerances (f32: autograd of the plain
    forward; bf16: the glue over the plain forward and backward), on the
    tensor-core routes of `tc_fwd_route`, `tc_bwd_route`, `tf32_fwd_route`
    and `tf32_bwd_route` in both directions, which the `.tc_launches`
    counters show."""
    b, n, d, h, dqk, dv, max_seq_len = PREPROC_SHAPES[instance]
    args, kw = _k1_args(b, n, d, h, dqk, dv, max_seq_len, dtype, cuda, seed=n + 1)
    args["x"] = args["x"] * args["colmask"][..., None].to(dtype)
    meta = hstu_block_train.BlockMeta(h, dqk, dv, kw["inv_n"], kw["eps"], 128, 0.2)
    bf16 = dtype == torch.bfloat16
    fwd, bwd = hstu_block_train.fused_train_block_forward, hstu_block_train.attn_backward
    want_tc = (int(hstu_block_train.tc_fwd_route(dtype, d, meta)
                   or hstu_block_train.tf32_fwd_route(dtype, d, n, meta)),
               int(hstu_block_train.tc_bwd_route(dtype, meta)
                   or hstu_block_train.tf32_bwd_route(dtype, n, meta)))
    assert want_tc == (1, 1)
    w = torch.cos(torch.arange(args["x"].numel(), device=cuda, dtype=torch.float32)).reshape(
        args["x"].shape)
    res = []
    for plain in (False, True):
        fn = hstu_block_train.fused_train_block
        if plain and bf16:
            monkeypatch.setattr(hstu_block_train, "fused_train_block_forward",
                                hstu_block_train.fused_train_block_forward_reference)
            monkeypatch.setattr(hstu_block_train, "attn_backward",
                                hstu_block_train.attn_backward_reference)
        elif plain:
            fn = hstu_block_train.fused_train_block_autograd_reference
        before = (fwd.launches, bwd.launches, fwd.tc_launches, bwd.tc_launches)
        leaves = [args[k].clone().requires_grad_(True) for k in GRAD_NAMES]
        out = fn(*leaves, args["colmask"], args["ext"], 13, meta)
        (out.float() * w).sum().backward()
        launched = tuple(a - c for a, c in zip(
            (fwd.launches, bwd.launches, fwd.tc_launches, bwd.tc_launches), before))
        assert launched == ((0, 0, 0, 0) if plain else (1, 1) + want_tc)
        res.append((out.detach().float(), [t.grad.float() for t in leaves]))
    (out_k, g_k), (out_p, g_p) = res
    assert bool(torch.isfinite(out_k).all())
    if bf16:
        assert ((out_k - out_p).abs().max() / out_p.abs().max()).item() <= 1e-2
    else:
        torch.testing.assert_close(out_k, out_p, rtol=1e-3, atol=1e-4)
    for name, got, want in zip(GRAD_NAMES, g_k, g_p):
        scale = want.abs().max().clamp_min(1e-30)
        assert ((got - want).abs().max() / scale).item() <= (2e-2 if bf16 else 1e-3), name


def test_k6_on_a_categorical_table(cuda):
    """The categorical embedding's gather backward through K6 into its
    (num_categories + 1, D) table at ML-20M width: 128 users x 211 ids over
    20 categories (about 1,350 updates a row), against the plain scatter,
    each row within its recursive-summation bound; two calls bit-equal."""
    from rails_tpu_torch.models.embedding import CategoricalEmbeddingModule

    g = torch.Generator().manual_seed(4)
    remap = torch.randint(0, 20, (26_744,), generator=g).numpy()
    ids = torch.randint(0, 26_745, (128, 211), generator=g).to(torch.int32)
    emb = CategoricalEmbeddingModule(20, 256, remap, g, scatter_grad_kernel=True).to(cuda)
    rows = emb.category_ids(ids.to(cuda)).to(torch.int32)
    upstream = torch.randn(128, 211, 256, generator=g).to(cuda)
    grads = []
    for _ in range(2):
        before = scatter_add.scatter_add_rows.launches
        emb.embedding.grad = None
        (emb(ids.to(cuda)) * upstream).sum().backward()
        assert scatter_add.scatter_add_rows.launches == before + 1
        grads.append(emb.embedding.grad.clone())
    assert torch.equal(grads[0], grads[1])
    want = scatter_add.scatter_add_rows_reference(rows, upstream, 21)
    flat = rows.reshape(-1).long()
    mass = torch.zeros(21, 256, dtype=torch.float64, device=cuda).index_add_(
        0, flat, upstream.reshape(-1, 256).double().abs())
    count = torch.bincount(flat, minlength=21).double()[:, None]
    assert int(count[1:].min()) > 1000
    assert bool(((grads[0].double() - want.double()).abs() <= 2 * count * 2.0**-24 * mass).all())


def test_kmeans_repeats_bit_for_bit_on_the_card(cuda):
    """IVF's k-means on the card: one seed, the same centroids twice (the
    seeding's generator draws and the one-hot cluster sums repeat), and a
    valid mask with pad rows."""
    from rails_tpu_torch.index.ivf import kmeans

    g = torch.Generator(device=cuda).manual_seed(3)
    centers = 4.0 * torch.randn(24, 32, generator=g, device=cuda)
    data = centers[torch.randint(0, 24, (20_000,), generator=g, device=cuda)]
    data = (data + 0.5 * torch.randn(data.shape, generator=g, device=cuda)).to(torch.bfloat16)
    valid = torch.arange(20_000, device=cuda) % 97 != 0
    a = kmeans(data, 64, num_iters=5, chunk=4096, valid=valid)
    b = kmeans(data, 64, num_iters=5, chunk=4096, valid=valid)
    assert a.shape == (64, 32) and torch.isfinite(a).all()
    assert torch.equal(a, b)


def test_ivf_full_probe_equals_exact_fused_on_the_card(cuda):
    """`MoLIVFTopK{nlist}` over a few thousand items on the card probes every
    list and returns the exact fused (K2) method's top-k: scores within the
    two scorers' f32 difference, ids where scores stand apart; two builds
    with one seed give the same index."""
    from rails_tpu_torch.index.ivf import build_ivf_index, mol_ivf_top_k
    from rails_tpu_torch.index.top_k import build_mol_topk_state, mol_brute_force_top_k_fused

    cfg = get_experiment_config("synthetic-small")
    num_items, k = 3000, 40
    model = SequentialRecommender(cfg, num_items, device=cuda,
                                  generator=torch.Generator().manual_seed(0))
    seqs = generate_synthetic_sequences(num_users=64, num_items=num_items, max_len=34, seed=1)
    ds = SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1)
    batch = next(ds.batches(32, cfg.train.gr_output_length + 1, shuffle=False, device=cuda))
    with torch.inference_mode():
        ids = torch.arange(1, num_items + 1, dtype=torch.int32, device=cuda)
        state = build_mol_topk_state(model, ids, model.get_item_embeddings(ids), torch.float32,
                                     build_fused=True)
        index = build_ivf_index(state.avg_component, state.item_ids, nlist=16, chunk=1024,
                                mol_state=state)
        again = build_ivf_index(state.avg_component, state.item_ids, nlist=16, chunk=1024,
                                mol_state=state)
        for a, b in zip(index, again):
            assert torch.equal(a, b)
        state = state._replace(ivf=index)
        q, uids = model.encode(batch.features), batch.features.user_ids
        exact = mol_brute_force_top_k_fused(model, state, q, k, uids)
        got = mol_ivf_top_k(model, state, q, k, nprobe=16, user_ids=uids)
    torch.testing.assert_close(got.scores, exact.scores, rtol=1e-4, atol=1e-4)
    scores = exact.scores
    gap = (scores[:, 1:] - scores[:, :-1]).abs() > 1e-4
    isolated = torch.ones_like(scores, dtype=torch.bool)
    isolated[:, 1:] &= gap
    isolated[:, :-1] &= gap
    assert torch.equal(got.ids[isolated], exact.ids[isolated])


# ---------------------------------------------------------------------------
# The scale slice on one card: two gloo ranks share it, each joined with a
# time limit (`core.distributed.run_ranks`).

RANK_TIMEOUT = 300.0


def _rank_model(device, mesh=None):
    cfg = get_experiment_config("synthetic-small")
    cfg = cfg.replace(hstu=cfg.hstu.replace(fused_train=True),
                      train=cfg.train.replace(local_batch_size=16))
    model, state, step, _ = create_train_state(cfg, 3000, np.arange(1, 3001, dtype=np.int32),
                                               seed=0, device=device, mesh=mesh)
    seqs = generate_synthetic_sequences(num_users=64, num_items=3000,
                                        max_len=cfg.data.max_sequence_length + 2, seed=2)
    batch = next(SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1).batches(
        16, cfg.train.gr_output_length + 1, shuffle=False, device=device))
    return cfg, model, state, step, batch


def _serve(model, batch, device, mesh=None):
    from rails_tpu_torch.index import top_k as tk
    from rails_tpu_torch.index.sharded import make_sharded_top_k_fn, pad_and_shard_state

    with torch.inference_mode():
        ids = torch.arange(1, 3001, dtype=torch.int32, device=device)
        state = tk.build_mol_topk_state(model, ids, model.get_item_embeddings(ids),
                                        torch.bfloat16, build_fused=True, fused_only=True)
        q = model.encode(batch.features)
        if mesh is None:
            return tk.mol_brute_force_top_k_fused(model, state, q, 50, batch.features.user_ids)
        fn = make_sharded_top_k_fn("MoLBruteForceTopKFused", model,
                                   pad_and_shard_state(state, mesh), mesh, k=50)
        return fn(q, batch.features.user_ids)


def _train(state, step, batch, device, steps=2):
    gen = torch.Generator(device=device).manual_seed(0)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, gen)
        losses.append(m["loss"].item())
    params = {k: p.detach().cpu() for k, p in state.model.named_parameters()}
    return losses, params


def gpu_rank(rank: int, world: int, store: str, out_dir: str, mode: str) -> None:
    """One rank on the card: the sharded brute force or two data-parallel
    steps of the synthetic-small model."""
    import os

    from rails_tpu_torch.core import distributed
    from rails_tpu_torch.core.config import MeshConfig
    from rails_tpu_torch.core.mesh import make_mesh, shard_batch

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(f"file://{store}", world, rank, backend="gloo", device=device)
    if mode == "serve":
        mesh = make_mesh(MeshConfig(item_parallel=world))
        _, model, _, _, batch = _rank_model(device)
        res = _serve(model, batch, device, mesh)
        out = (res.scores.float().cpu(), res.ids.cpu(), mol_scoring.fused_mol_scores_t.launches)
    else:
        mesh = make_mesh(MeshConfig(data_parallel=world, item_parallel=1))
        _, _, state, step, batch = _rank_model(device, mesh)
        out = _train(state, step, shard_batch(batch, mesh), device) + (
            hstu_block_train.fused_train_block_forward.launches,)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()


def _run_gpu_ranks(tmp_path, mode):
    from rails_tpu_torch.core.distributed import run_ranks

    run_ranks(gpu_rank, 2, (2, str(tmp_path / "store"), str(tmp_path), mode),
              timeout=RANK_TIMEOUT)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]


def test_two_rank_sharded_brute_force_on_one_card(cuda, tmp_path):
    """Two gloo ranks on the card serve a 3,000-item corpus split in two
    through K2: both return the single-process path's list (a shard's
    columns score as in the whole table), and each launched K2."""
    _, model, _, _, batch = _rank_model(cuda)
    want = _serve(model, batch, cuda)
    outs = _run_gpu_ranks(tmp_path, "serve")
    for scores, ids, launches in outs:
        assert launches > 0
        torch.testing.assert_close(scores, want.scores.float().cpu(), rtol=0, atol=0)
        assert torch.equal(ids, want.ids.cpu())


def test_two_rank_dp_step_on_one_card(cuda, tmp_path):
    """Two data-parallel steps of two gloo ranks on the card (K3/K4 with
    dropout, K7) == two single-process steps over the global batch of 16:
    losses within relative 1e-5, parameters within 1e-5; the ranks'
    parameters bit-equal."""
    _, _, state, step, batch = _rank_model(cuda)
    want_losses, want_params = _train(state, step, batch, cuda)
    outs = _run_gpu_ranks(tmp_path, "train")
    for losses, params, launches in outs:
        assert launches > 0
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        for k, p in want_params.items():
            torch.testing.assert_close(params[k], p, rtol=0, atol=1e-5)
    for k, p in outs[0][1].items():
        assert torch.equal(p, outs[1][1][k]), k
