"""HSTU block training step (K4, with K3 dropout): CUDA kernels + plain versions.

Replaces `make_fused_train_block` (`rails_tpu/ops/pallas/hstu_block_train.py`):
the forward `pallas_call` (:574, body `_fwd_kernel` :124-232), the
attention-core backward `pallas_call` (:629, body `_attn_bwd_kernel`
:248-435, pointwise-SiLU branch) and the glue of its custom VJP
(`block_bwd`, :657-756), for the block the `ml-20m-hstu-mol` config trains:
internal bias, SiLU, `rel_bias`, o_input dropout, no attention dropout, with
f32 or bf16 operands (the matmul dtype is the weights', `uvqk.dtype`).

- `fused_train_block_forward`: K1's three launches with the K3 keep mask in
  the output GEMM's loader (`csrc/hstu_block_train.cu`); returns the block
  output (x's dtype) and attn (B, n, h*dv) f32. The f32 backward keeps attn in
  place of the JAX backward's recompute of the attention (16 layers x 27.7 MB
  at B = 128, n = 211); the bf16 backward recomputes it from the bf16 y, as
  JAX does, because that attn differs from the forward's (v rounds twice).
- `attn_backward`: the attention-core backward in two launches (three in
  bf16, the first recomputing attn), a row kernel (LN backward of attn) and a
  per-user kernel over the heads (d_q, d_k, d_v and the dense d(bias)); no
  atomics, so the result repeats bit for bit. y and d(o_input) come in the
  matmul dtype; d_y, attn and dbias are f32.
- `FusedTrainBlock`: the autograd Function. Its backward is the JAX glue in
  torch: z = LN(x) @ uvqk recomputed (as the JAX glue does), d_o_in =
  dy @ Wo^T times the keep mask (`ops.hash_dropout.hash_keep_mask`), the
  kernel, then dWo, dbo, dW, dx, d rel_pos = sum_b dbias and d tsw binned from
  dbias by time bucket with `bincount(weights=)` (the JAX glue's one-hot
  einsum would materialise B*n*n*128 floats, 2.9 GB at B = 128; `index_add_`
  into 128 bins serialised on its atomics, 5.5 ms per layer on the H100).
  Its GEMMs are plain matrix products outside the kernels: each operand is
  rounded to the matmul dtype where JAX casts to `mm` (n0, dy, o_in, d_z; y,
  sig and z stay f32) and the product runs in f32, which is JAX's
  `preferred_element_type=f32` exactly. dx comes back in x's dtype, dW and dWo
  in the weights' dtype, dbo f32.

Each wrapper follows the port's dispatch rule (`core.device.use_kernel`):
CPU tensors run the plain version (`*_reference`), CUDA tensors launch the
kernel or raise; on the CPU, `FusedTrainBlock` runs the plain forward and the
plain attention backward inside the same glue. `.launches` counts kernel
launches of each wrapper, and `.bf16_launches` those of its bf16 instance as
well. The other variants of the TPU kernel (attention dropout, `concat_ua`,
`softmax_rel_bias`, no bias, no activation) raise NotImplementedError naming
`K4 variants` in `models.hstu.HSTUStack`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rails_tpu_torch.core.device import use_kernel
from rails_tpu_torch.ops import _build
from rails_tpu_torch.ops.hash_dropout import (
    hash_keep_mask,
    hash_keep_mask_reference,
    keep_threshold,
    wrap_i32,
)
from rails_tpu_torch.ops.hstu_block import (
    MAX_SMEM_BYTES,
    block_forward_reference,
    ln,
    time_bucket,
)

# The causal / column-validity penalty folded into the train kernels' bias.
PENALTY = 30000.0
# Head dims the backward kernel takes (one per lane of a warp).
MAX_HEAD_DIM = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class BlockMeta(NamedTuple):
    """Static description of a train block: geometry, normaliser, LN eps,
    time-bucket clip and o_input dropout rate."""

    num_heads: int
    dqk: int
    dv: int
    inv_n: float
    eps: float
    num_buckets: int
    rate: float


def ln_backward(a: torch.Tensor, dn: torch.Tensor, eps: float) -> torch.Tensor:
    """d/da of n = (a - mean(a)) * rsqrt(var(a) + eps), given dn (`_ln_bwd`)."""
    mu = a.mean(dim=-1, keepdim=True)
    var = a.var(dim=-1, keepdim=True, unbiased=False)
    inv = torch.rsqrt(var + eps)
    nh = (a - mu) * inv
    return inv * (dn - dn.mean(dim=-1, keepdim=True)
                  - nh * (dn * nh).mean(dim=-1, keepdim=True))


def _bias_with_penalty(colmask, rel_pos, ext, tsw, num_buckets) -> torch.Tensor:
    """(B, n, n) f32: rel-pos + time-bucket bias + the -30000 penalty of
    non-causal and padded columns (`_compute_bias`)."""
    n = rel_pos.shape[0]
    delta = ext[:, 1:, None] - ext[:, None, :n]
    bias = rel_pos[None] + tsw[time_bucket(delta, num_buckets).long()]
    causal = torch.tril(torch.ones(n, n, dtype=torch.float32, device=rel_pos.device))
    mask = causal[None] * colmask[:, None, :]
    return bias + (mask - 1.0) * PENALTY


def fused_train_block_forward_reference(
    x: torch.Tensor,          # (B, n, D) f32 or bf16
    colmask: torch.Tensor,    # (B, n) f32 {0, 1}
    uvqk: torch.Tensor,       # (D, 2h*dv + 2h*dqk), x's dtype
    o_kernel: torch.Tensor,   # (h*dv, D), x's dtype
    o_bias: torch.Tensor,     # (D,) f32
    rel_pos: torch.Tensor,    # (n, n) f32
    ext: torch.Tensor,        # (B, n+1) int32
    tsw: torch.Tensor,        # (128,) f32
    seed: int,
    meta: BlockMeta,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward: (out (B, n, D) in x's dtype, attn
    (B, n, h*dv) f32)."""
    keep = None
    if meta.rate > 0.0:
        keep = hash_keep_mask_reference(x.shape[0], x.shape[1], meta.num_heads * meta.dv, seed,
                                        meta.rate, x.device)
    return block_forward_reference(
        x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, num_heads=meta.num_heads,
        dqk=meta.dqk, dv=meta.dv, inv_n=meta.inv_n, eps=meta.eps,
        num_buckets=meta.num_buckets, keep=keep,
    )


def _check(name: str, tensors: dict) -> None:
    for key, (t, dtype, shape) in tensors.items():
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: {key} must be a contiguous {dtype} {shape}; got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )


def _count(fn, dtype: torch.dtype) -> None:
    fn.launches += 1
    if dtype == torch.bfloat16:
        fn.bf16_launches += 1


def fused_train_block_forward(
    x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, seed: int, meta: BlockMeta,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train block's forward; same arguments as
    `fused_train_block_forward_reference`."""
    tensors = (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw)
    if not use_kernel(*tensors):
        return fused_train_block_forward_reference(*tensors, seed, meta)
    b, n, d = x.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    f = 2 * h * dv + 2 * h * dqk
    f32, mm = torch.float32, x.dtype
    if mm not in _DTYPE_CODE:
        raise ValueError(f"fused_train_block_forward: unsupported dtype {mm}")
    _check("fused_train_block_forward", {
        "x": (x, mm, (b, n, d)), "colmask": (colmask, f32, (b, n)),
        "uvqk": (uvqk, mm, (d, f)), "o_kernel": (o_kernel, mm, (h * dv, d)),
        "o_bias": (o_bias, f32, (d,)), "rel_pos": (rel_pos, f32, (n, n)),
        "ext": (ext, torch.int32, (b, n + 1)), "tsw": (tsw, f32, (128,)),
    })
    lib = _build.load_library()
    smem = lib.rails_hstu_attn_smem_bytes(n, dqk, dv)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"fused_train_block_forward: n={n} needs {smem} B of shared memory")
    drop = meta.rate > 0.0
    with torch.cuda.device(x.device):
        y = torch.empty(b * n, f, dtype=f32, device=x.device)
        attn = torch.empty(b, n, h * dv, dtype=f32, device=x.device)
        out = torch.empty_like(x)
        err = lib.rails_hstu_train_fwd(
            _DTYPE_CODE[mm], x.data_ptr(), colmask.data_ptr(), uvqk.data_ptr(),
            o_kernel.data_ptr(), o_bias.data_ptr(), rel_pos.data_ptr(), ext.data_ptr(),
            tsw.data_ptr(), y.data_ptr(), attn.data_ptr(), out.data_ptr(), b, n, d, h, dqk, dv,
            meta.inv_n, meta.eps, min(meta.num_buckets, 127), int(drop), wrap_i32(seed),
            keep_threshold(meta.rate) if drop else 0,
            1.0 / (1.0 - meta.rate) if drop else 1.0,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "fused_train_block_forward")
    _count(fused_train_block_forward, mm)
    return out, attn


fused_train_block_forward.launches = 0
fused_train_block_forward.bf16_launches = 0


def attn_backward_reference(
    y: torch.Tensor,          # (B, n, F) silu(LN(x) @ uvqk) in the matmul dtype
    d_o_in: torch.Tensor,     # (B, n, h*dv) y's dtype, keep mask applied
    attn: Optional[torch.Tensor],   # (B, n, h*dv) f32 from the forward (f32), or None
    colmask: torch.Tensor,    # (B, n) f32
    rel_pos: torch.Tensor,    # (n, n) f32
    ext: torch.Tensor,        # (B, n+1) int32
    tsw: torch.Tensor,        # (128,) f32
    meta: BlockMeta,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the attention-core backward, batched over users and
    heads: (d_y (B, n, F) = [d_u, d_v, d_q, d_k], dbias (B, n, n), attn), all
    f32. With `attn` None the attention output is recomputed from y, as the
    JAX backward does (the bf16 instance); every product rounds its operands
    to y's dtype where `_attn_bwd_kernel` casts to `mm`."""
    b, n, _ = y.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    hdv = h * dv
    mm = y.dtype

    def rnd(t: torch.Tensor) -> torch.Tensor:
        return t.to(mm).float()

    yf = y.float()
    u = yf[..., :hdv]
    v = rnd(yf[..., hdv : 2 * hdv] * meta.inv_n).reshape(b, n, h, dv)
    q = yf[..., 2 * hdv : 2 * hdv + h * dqk].reshape(b, n, h, dqk)
    k = yf[..., 2 * hdv + h * dqk :].reshape(b, n, h, dqk)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) + _bias_with_penalty(
        colmask, rel_pos, ext, tsw, meta.num_buckets)[:, None]
    sig = torch.sigmoid(s)
    a = rnd(s * sig)
    deriv = sig * (1.0 + s * (1.0 - sig))
    if attn is None:
        attn = torch.einsum("bhnm,bmhd->bnhd", a, v).reshape(b, n, hdv)
    d_o = d_o_in.float()
    d_u = d_o * ln(attn, meta.eps)
    d_attn = rnd(ln_backward(attn, d_o * u, meta.eps)).reshape(b, n, h, dv)
    d_s = torch.einsum("bnhd,bmhd->bhnm", d_attn, v) * deriv
    d_v = torch.einsum("bhnm,bnhd->bmhd", a, d_attn) * meta.inv_n
    d_s_mm = rnd(d_s)
    d_q = torch.einsum("bhnm,bmhd->bnhd", d_s_mm, k)
    d_k = torch.einsum("bhnm,bnhd->bmhd", d_s_mm, q)
    d_y = torch.cat([d_u, d_v.reshape(b, n, hdv), d_q.reshape(b, n, h * dqk),
                     d_k.reshape(b, n, h * dqk)], dim=-1)
    return d_y, d_s.sum(dim=1), attn


def attn_backward(
    y, d_o_in, attn, colmask, rel_pos, ext, tsw, meta: BlockMeta,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention-core backward; same arguments and results as
    `attn_backward_reference`. The f32 instance takes the forward's attn, the
    bf16 one recomputes it (`attn` None)."""
    if (attn is None) != (y.dtype == torch.bfloat16):
        raise ValueError("attn_backward: pass the forward's attn with f32 operands and None "
                         f"(recomputed) with bf16 ones; got y {y.dtype}, attn "
                         f"{'None' if attn is None else 'given'}")
    tensors = (y, d_o_in, colmask, rel_pos, ext, tsw) + (() if attn is None else (attn,))
    if not use_kernel(*tensors):
        return attn_backward_reference(y, d_o_in, attn, colmask, rel_pos, ext, tsw, meta)
    b, n, f = y.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    if dqk > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the train block's backward kernel takes head dims <= {MAX_HEAD_DIM}; got "
            f"dqk={dqk}, dv={dv} (ROADMAP.md, Queue 1: K4 variants)"
        )
    f32, mm = torch.float32, y.dtype
    expect = {
        "y": (y, mm, (b, n, 2 * h * dv + 2 * h * dqk)), "d_o_in": (d_o_in, mm, (b, n, h * dv)),
        "colmask": (colmask, f32, (b, n)), "rel_pos": (rel_pos, f32, (n, n)),
        "ext": (ext, torch.int32, (b, n + 1)), "tsw": (tsw, f32, (128,)),
    }
    if attn is not None:
        expect["attn"] = (attn, f32, (b, n, h * dv))
    _check("attn_backward", expect)
    lib = _build.load_library()
    smem = max(lib.rails_hstu_train_bwd_smem_bytes(n, dqk, dv),
               lib.rails_hstu_attn_smem_bytes(n, dqk, dv) if attn is None else 0)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"attn_backward: n={n} needs {smem} B of shared memory")
    with torch.cuda.device(y.device):
        if attn is None:
            attn = torch.empty(b, n, h * dv, dtype=f32, device=y.device)
        d_attn = torch.empty(b, n, h * dv, dtype=f32, device=y.device)
        d_y = torch.empty(b, n, f, dtype=f32, device=y.device)
        dbias = torch.empty(b, n, n, dtype=f32, device=y.device)
        err = lib.rails_hstu_train_bwd(
            _DTYPE_CODE[mm], y.data_ptr(), d_o_in.data_ptr(), attn.data_ptr(),
            colmask.data_ptr(), rel_pos.data_ptr(), ext.data_ptr(), tsw.data_ptr(),
            d_attn.data_ptr(), d_y.data_ptr(), dbias.data_ptr(), b, n, h, dqk, dv, meta.inv_n,
            meta.eps, min(meta.num_buckets, 127), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "attn_backward")
    _count(attn_backward, mm)
    return d_y, dbias, attn


attn_backward.launches = 0
attn_backward.bf16_launches = 0


class FusedTrainBlock(torch.autograd.Function):
    """One HSTU block in training, differentiable with respect to x, rel_pos,
    tsw, uvqk, o_kernel and o_bias (the JAX block's custom VJP)."""

    @staticmethod
    def forward(ctx, x, rel_pos, tsw, uvqk, o_kernel, o_bias, colmask, ext, seed: int,
                meta: BlockMeta):
        out, attn = fused_train_block_forward(
            x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, seed, meta)
        # The bf16 backward recomputes attn from its bf16 y, as JAX does.
        keep_attn = attn if uvqk.dtype == torch.float32 else None
        ctx.save_for_backward(x, rel_pos, tsw, uvqk, o_kernel, colmask, ext, keep_attn)
        ctx.seed, ctx.meta = seed, meta
        return out

    @staticmethod
    def backward(ctx, dy):
        x, rel_pos, tsw, uvqk, o_kernel, colmask, ext, attn = ctx.saved_tensors
        m = ctx.meta
        b, n, d = x.shape
        hdv = m.num_heads * m.dv
        mm = uvqk.dtype

        def rnd(t: torch.Tensor) -> torch.Tensor:   # JAX's casts to mm before a product
            return t.to(mm).float()

        x32, dy32 = x.float(), dy.contiguous().float()
        n0 = ln(x32, m.eps)
        z = rnd(n0) @ uvqk.float()
        sig = torch.sigmoid(z)
        y = z * sig
        d_o_in = rnd(dy32) @ o_kernel.float().T
        keep = None
        if m.rate > 0.0:
            keep = hash_keep_mask(b, n, hdv, ctx.seed, m.rate, x.device)
            d_o_in = d_o_in * keep
        d_y, dbias, attn = attn_backward(y.to(mm), d_o_in.to(mm), attn, colmask, rel_pos, ext,
                                         tsw, m)
        o_in = y[..., :hdv] * ln(attn, m.eps)
        if keep is not None:
            o_in = o_in * keep
        dwo = rnd(o_in).reshape(-1, hdv).T @ rnd(dy32).reshape(-1, d)
        dbo = dy32.sum(dim=(0, 1))
        d_z = rnd(d_y * (sig * (1.0 + z * (1.0 - sig))))
        dw = rnd(n0).reshape(-1, d).T @ d_z.reshape(-1, d_z.shape[-1])
        dx = (ln_backward(x32, d_z @ uvqk.float().T, m.eps) + dy32).to(x.dtype)
        d_rel_pos = dbias.sum(dim=0)
        delta = ext[:, 1:, None] - ext[:, None, :n]
        bins = time_bucket(delta, m.num_buckets).reshape(-1)
        d_tsw = torch.bincount(bins, weights=dbias.reshape(-1), minlength=tsw.shape[0])
        return (dx, d_rel_pos, d_tsw, dw.to(mm), dwo.to(o_kernel.dtype), dbo,
                None, None, None, None)


def fused_train_block(x, rel_pos, tsw, uvqk, o_kernel, o_bias, colmask, ext, seed: int,
                      meta: BlockMeta) -> torch.Tensor:
    """One HSTU block in training (`make_fused_train_block(...)(...)`)."""
    return FusedTrainBlock.apply(x, rel_pos, tsw, uvqk, o_kernel, o_bias, colmask, ext,
                                 wrap_i32(seed), meta)


def fused_train_block_autograd_reference(x, rel_pos, tsw, uvqk, o_kernel, o_bias, colmask, ext,
                                         seed: int, meta: BlockMeta) -> torch.Tensor:
    """The plain forward under autograd: the yardstick of `FusedTrainBlock`'s
    gradients in the tests."""
    return fused_train_block_forward_reference(
        x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, wrap_i32(seed), meta)[0]
