"""HSTU block training step (K4, with K3 dropout): CUDA kernels + plain versions.

Replaces `make_fused_train_block` (`rails_tpu/ops/pallas/hstu_block_train.py`):
the forward `pallas_call` (:574, body `_fwd_kernel` :124-232), the
attention-core backward `pallas_call` (:629, body `_attn_bwd_kernel`
:248-435, pointwise-SiLU branch) and the glue of its custom VJP
(`block_bwd`, :657-756), for the block the `ml-20m-hstu-mol` config trains:
internal bias, SiLU, `rel_bias`, o_input dropout, no attention dropout, f32.

- `fused_train_block_forward`: K1's three launches with the K3 keep mask in
  the output GEMM's loader (`csrc/hstu_block_train.cu`); returns the block
  output and attn (B, n, h*dv), which the backward keeps in place of the
  JAX backward's recompute of the attention (16 layers x 27.7 MB at B = 128,
  n = 211).
- `attn_backward`: the attention-core backward in two launches, a row kernel
  (LN backward of attn) and a per-user kernel over the heads (d_q, d_k, d_v
  and the dense d(bias)); no atomics, so the result repeats bit for bit.
- `FusedTrainBlock`: the autograd Function. Its backward is the JAX glue in
  torch: z = LN(x) @ uvqk recomputed (as the JAX glue does), d_o_in =
  dy @ Wo^T times the keep mask (`ops.hash_dropout.hash_keep_mask`), the
  kernel, then dWo, dbo, dW, dx, d rel_pos = sum_b dbias and d tsw binned from
  dbias by time bucket with `bincount(weights=)` (the JAX glue's one-hot
  einsum would materialise B*n*n*128 floats, 2.9 GB at B = 128; `index_add_`
  into 128 bins serialised on its atomics, 5.5 ms per layer on the H100).

Each wrapper follows the port's dispatch rule (`core.device.use_kernel`):
CPU tensors run the plain version (`*_reference`), CUDA tensors launch the
kernel or raise; on the CPU, `FusedTrainBlock` runs the plain forward and the
plain attention backward inside the same glue. `.launches` counts kernel
launches of each wrapper. The other variants of the TPU kernel (attention
dropout, `concat_ua`, `softmax_rel_bias`, no bias, no activation, bf16)
raise NotImplementedError in `models.hstu.HSTUStack`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

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
    x: torch.Tensor,          # (B, n, D) f32
    colmask: torch.Tensor,    # (B, n) f32 {0, 1}
    uvqk: torch.Tensor,       # (D, 2h*dv + 2h*dqk) f32
    o_kernel: torch.Tensor,   # (h*dv, D) f32
    o_bias: torch.Tensor,     # (D,) f32
    rel_pos: torch.Tensor,    # (n, n) f32
    ext: torch.Tensor,        # (B, n+1) int32
    tsw: torch.Tensor,        # (128,) f32
    seed: int,
    meta: BlockMeta,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward: (out (B, n, D), attn (B, n, h*dv))."""
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
    f32 = torch.float32
    _check("fused_train_block_forward", {
        "x": (x, f32, (b, n, d)), "colmask": (colmask, f32, (b, n)),
        "uvqk": (uvqk, f32, (d, f)), "o_kernel": (o_kernel, f32, (h * dv, d)),
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
            x.data_ptr(), colmask.data_ptr(), uvqk.data_ptr(), o_kernel.data_ptr(),
            o_bias.data_ptr(), rel_pos.data_ptr(), ext.data_ptr(), tsw.data_ptr(),
            y.data_ptr(), attn.data_ptr(), out.data_ptr(), b, n, d, h, dqk, dv,
            meta.inv_n, meta.eps, min(meta.num_buckets, 127), int(drop), wrap_i32(seed),
            keep_threshold(meta.rate) if drop else 0,
            1.0 / (1.0 - meta.rate) if drop else 1.0,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "fused_train_block_forward")
    fused_train_block_forward.launches += 1
    return out, attn


fused_train_block_forward.launches = 0


def attn_backward_reference(
    y: torch.Tensor,          # (B, n, F) f32 silu(LN(x) @ uvqk)
    d_o_in: torch.Tensor,     # (B, n, h*dv) f32, keep mask applied
    attn: torch.Tensor,       # (B, n, h*dv) f32 from the forward
    colmask: torch.Tensor,    # (B, n) f32
    rel_pos: torch.Tensor,    # (n, n) f32
    ext: torch.Tensor,        # (B, n+1) int32
    tsw: torch.Tensor,        # (128,) f32
    meta: BlockMeta,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the attention-core backward, batched over users and
    heads: (d_y (B, n, F) = [d_u, d_v, d_q, d_k], dbias (B, n, n))."""
    b, n, _ = y.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    hdv = h * dv
    u = y[..., :hdv]
    v = (y[..., hdv : 2 * hdv] * meta.inv_n).reshape(b, n, h, dv)
    q = y[..., 2 * hdv : 2 * hdv + h * dqk].reshape(b, n, h, dqk)
    k = y[..., 2 * hdv + h * dqk :].reshape(b, n, h, dqk)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) + _bias_with_penalty(
        colmask, rel_pos, ext, tsw, meta.num_buckets)[:, None]
    sig = torch.sigmoid(s)
    a = s * sig
    deriv = sig * (1.0 + s * (1.0 - sig))
    d_u = d_o_in * ln(attn, meta.eps)
    d_attn = ln_backward(attn, d_o_in * u, meta.eps).reshape(b, n, h, dv)
    d_s = torch.einsum("bnhd,bmhd->bhnm", d_attn, v) * deriv
    d_v = torch.einsum("bhnm,bnhd->bmhd", a, d_attn) * meta.inv_n
    d_q = torch.einsum("bhnm,bmhd->bnhd", d_s, k)
    d_k = torch.einsum("bhnm,bnhd->bmhd", d_s, q)
    d_y = torch.cat([d_u, d_v.reshape(b, n, hdv), d_q.reshape(b, n, h * dqk),
                     d_k.reshape(b, n, h * dqk)], dim=-1)
    return d_y, d_s.sum(dim=1)


def attn_backward(
    y, d_o_in, attn, colmask, rel_pos, ext, tsw, meta: BlockMeta,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention-core backward; same arguments as `attn_backward_reference`."""
    tensors = (y, d_o_in, attn, colmask, rel_pos, ext, tsw)
    if not use_kernel(*tensors):
        return attn_backward_reference(*tensors, meta)
    b, n, f = y.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    if dqk > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the train block's backward kernel takes head dims <= {MAX_HEAD_DIM}; got "
            f"dqk={dqk}, dv={dv} (ROADMAP.md, Queue 1: K1 variants)"
        )
    f32 = torch.float32
    _check("attn_backward", {
        "y": (y, f32, (b, n, 2 * h * dv + 2 * h * dqk)), "d_o_in": (d_o_in, f32, (b, n, h * dv)),
        "attn": (attn, f32, (b, n, h * dv)), "colmask": (colmask, f32, (b, n)),
        "rel_pos": (rel_pos, f32, (n, n)), "ext": (ext, torch.int32, (b, n + 1)),
        "tsw": (tsw, f32, (128,)),
    })
    lib = _build.load_library()
    smem = lib.rails_hstu_train_bwd_smem_bytes(n, dqk, dv)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"attn_backward: n={n} needs {smem} B of shared memory")
    with torch.cuda.device(y.device):
        d_attn = torch.empty(b, n, h * dv, dtype=f32, device=y.device)
        d_y = torch.empty(b, n, f, dtype=f32, device=y.device)
        dbias = torch.empty(b, n, n, dtype=f32, device=y.device)
        err = lib.rails_hstu_train_bwd(
            y.data_ptr(), d_o_in.data_ptr(), attn.data_ptr(), colmask.data_ptr(),
            rel_pos.data_ptr(), ext.data_ptr(), tsw.data_ptr(), d_attn.data_ptr(),
            d_y.data_ptr(), dbias.data_ptr(), b, n, h, dqk, dv, meta.inv_n, meta.eps,
            min(meta.num_buckets, 127), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "attn_backward")
    attn_backward.launches += 1
    return d_y, dbias


attn_backward.launches = 0


class FusedTrainBlock(torch.autograd.Function):
    """One HSTU block in training, differentiable with respect to x, rel_pos,
    tsw, uvqk, o_kernel and o_bias (the JAX block's custom VJP)."""

    @staticmethod
    def forward(ctx, x, rel_pos, tsw, uvqk, o_kernel, o_bias, colmask, ext, seed: int,
                meta: BlockMeta):
        out, attn = fused_train_block_forward(
            x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, seed, meta)
        ctx.save_for_backward(x, rel_pos, tsw, uvqk, o_kernel, colmask, ext, attn)
        ctx.seed, ctx.meta = seed, meta
        return out

    @staticmethod
    def backward(ctx, dy):
        x, rel_pos, tsw, uvqk, o_kernel, colmask, ext, attn = ctx.saved_tensors
        m = ctx.meta
        b, n, d = x.shape
        hdv = m.num_heads * m.dv
        dy = dy.contiguous()
        n0 = ln(x, m.eps)
        z = n0 @ uvqk
        sig = torch.sigmoid(z)
        y = z * sig
        d_o_in = dy @ o_kernel.T
        keep = None
        if m.rate > 0.0:
            keep = hash_keep_mask(b, n, hdv, ctx.seed, m.rate, x.device)
            d_o_in = d_o_in * keep
        d_y, dbias = attn_backward(y, d_o_in, attn, colmask, rel_pos, ext, tsw, m)
        o_in = y[..., :hdv] * ln(attn, m.eps)
        if keep is not None:
            o_in = o_in * keep
        dwo = o_in.reshape(-1, hdv).T @ dy.reshape(-1, d)
        dbo = dy.sum(dim=(0, 1))
        d_z = d_y * (sig * (1.0 + z * (1.0 - sig)))
        dw = n0.reshape(-1, d).T @ d_z.reshape(-1, d_z.shape[-1])
        dx = ln_backward(x, d_z @ uvqk.T, m.eps) + dy
        d_rel_pos = dbias.sum(dim=0)
        delta = ext[:, 1:, None] - ext[:, None, :n]
        bins = time_bucket(delta, m.num_buckets).reshape(-1)
        d_tsw = torch.bincount(bins, weights=dbias.reshape(-1), minlength=tsw.shape[0])
        return dx, d_rel_pos, d_tsw, dw, dwo, dbo, None, None, None, None


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
