"""HSTU block training step (K4, with K3 dropout): CUDA kernels + plain versions.

Replaces `make_fused_train_block` (`rails_tpu/ops/pallas/hstu_block_train.py`):
the forward `pallas_call` (:574, body `_fwd_kernel` :124-232), the
attention-core backward `pallas_call` (:629, body `_attn_bwd_kernel`
:248-435) and the glue of its custom VJP (`block_bwd`, :657-756), for every
variant of the block (`BlockMeta`): SiLU or no activation, pointwise
(`rel_bias`) or softmax (`softmax_rel_bias`) attention, u * LN(a) or the
concat_ua o_input [u, LN(a), u * LN(a)], the relative-attention bias built
in-kernel or none (rel_pos, ext and tsw None), o_input and attention dropout,
any head dim, with f32 or bf16 operands (the matmul dtype is the weights',
`uvqk.dtype`).

- `fused_train_block_forward`: K1's three launches with the K3 keep mask in
  the output GEMM's loader and the attention keep mask in the attention
  kernel (`csrc/hstu_block_train.cu`); returns the block output (x's dtype)
  and attn (B, n, h*dv) f32. The f32 backward keeps attn in place of the JAX
  backward's recompute of the attention (16 layers x 27.7 MB at B = 128,
  n = 211); the bf16 backward recomputes it from the bf16 y, as JAX does,
  because that attn differs from the forward's (v rounds twice). bf16 at
  the widths of K1's tensor-core kernels with the SiLU projection
  (`tc_fwd_route`) runs on the tensor cores: K1's `project` and `out_gemm`
  around `train_attention_oinput`, the TRAIN instance of K1's tensor-core
  attention (`csrc/hstu_block_tc.cuh`: both keep masks before their
  roundings, attn written in f32). f32 at those widths with n <= 512, the
  SiLU projection and the pointwise attention (`tf32_fwd_route`) runs on
  the tensor cores too, every product as 3xTF32 (`csrc/hstu_train_tf32.cuh`):
  `tf32_project`, `tf32_attention` and `tf32_out_gemm`, with plain versions
  `tf32_*_reference`.
- `attn_backward`: the attention-core backward, a row kernel (LN backward of
  attn) then, pointwise, a per-user kernel over the heads (d_q, d_k, d_v and
  the dense d(bias); `csrc/hstu_block_train.cu`) or, softmax, a kernel per
  (user, 32 query rows) and one per (user, 32 key columns)
  (`csrc/hstu_softmax_train.cu`); the bf16 instances first recompute attn.
  bf16 pointwise at the tensor-core widths (`tc_bwd_route`) runs three
  mma.sync stages over (user, 64-row) tiles instead (`csrc/hstu_train_tc.cuh`;
  `attn_bwd_rows`: attn recomputed, LN backward, d_u, d_attn; `attn_bwd_dq`:
  d_q and dbias; `attn_bwd_dkv`: d_k and d_v), whose plain versions
  `*_reference` compose to `attn_backward_reference` bit for bit. f32 on
  `tf32_bwd_route` runs `tf32_bwd_rows` (the LN row kernel), `tf32_bwd_dq`
  and `tf32_bwd_dkv` (3xTF32 over (user, 64-row) tiles, heads in turn; plain
  versions `tf32_bwd_rows_reference`, `attn_bwd_dq_reference`,
  `attn_bwd_dkv_reference`).
  No atomics, so the result repeats bit for bit. y and d(o_input) come in
  the matmul dtype; d_y, attn and dbias are f32.
- `FusedTrainBlock`: the autograd Function. Its backward is the JAX glue in
  torch: z = LN(x) @ uvqk recomputed (as the JAX glue does), y = SiLU(z) or
  z, d_o_in = dy @ Wo^T times the keep mask over o_input's width
  (`ops.hash_dropout.hash_keep_mask`), the kernel, then dWo from the
  recomputed o_input, dbo, dW, dx, and with the bias d rel_pos = sum_b dbias
  and d tsw binned from dbias by time bucket with `bincount(weights=)` (the
  JAX glue's one-hot einsum would materialise B*n*n*128 floats, 2.9 GB at
  B = 128; `index_add_` into 128 bins serialised on its atomics, 5.5 ms per
  layer on the H100); without the bias those gradients are None. Its GEMMs
  are plain matrix products outside the kernels: each operand is rounded to
  the matmul dtype where JAX casts to `mm` (n0, dy, o_in, d_z; y, sig and z
  stay f32) and the product runs in f32, which is JAX's
  `preferred_element_type=f32` exactly. dx comes back in x's dtype, dW and
  dWo in the weights' dtype, dbo f32.

Each wrapper follows the port's dispatch rule (`core.device.use_kernel`):
CPU tensors run the plain version (`*_reference`), CUDA tensors launch the
kernel or raise; on the CPU, `FusedTrainBlock` runs the plain forward and the
plain attention backward inside the same glue. `.launches` counts kernel
launches of each wrapper, `.bf16_launches` those of its bf16 instance as
well, `.tc_launches` those on the tensor cores, and
`.variant_launches[variant_name(...)]` those of each variant other than the
default (SiLU, rel_bias, the bias, no attention dropout, head dims <= 32);
each tensor-core stage wrapper (bf16 and f32) counts its own `.launches`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rails_tpu_torch.core.device import use_kernel
from rails_tpu_torch.ops import _build
from rails_tpu_torch.ops.hash_dropout import (
    attn_keep_mask_reference,
    hash_keep_mask,
    hash_keep_mask_reference,
    keep_threshold,
    wrap_i32,
)
from rails_tpu_torch.ops.hstu_block import (
    _ACTIVATIONS,
    MAX_SMEM_BYTES,
    block_forward_reference,
    check_tc_smem,
    ln,
    out_gemm,
    project,
    require_tc,
    split_vqk,
    tc_block,
    tc_widths,
    time_bucket,
    vqk_layout,
)

# The causal / column-validity penalty folded into the pointwise kernels' bias.
PENALTY = 30000.0
# Head dims the backward kernel holds in registers at a time; wider heads
# run its WIDE instances in chunks of this many.
HEAD_DIM_CHUNK = 32
# The longest sequence of K4's f32 route on the tensor cores (`kTf32MaxN`,
# csrc/hstu_block_tc.cuh), the combined preprocessor's 2 x 211 within it: a
# block holds its rows' bias for every key, so past n = 256 the attention
# kernels take 32-row blocks instead of 64 (`block_rows`,
# csrc/hstu_train_tf32.cuh), 200 KB at 512.
TF32_MAX_N = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class BlockMeta(NamedTuple):
    """Static description of a train block: geometry, normaliser, LN eps,
    time-bucket clip, o_input dropout rate, and the variant: activation
    ("silu" or "none"), softmax (`softmax_rel_bias`), concat_ua and the
    attention dropout rate. Whether the block has the relative-attention bias
    is read from `rel_pos` being None."""

    num_heads: int
    dqk: int
    dv: int
    inv_n: float
    eps: float
    num_buckets: int
    rate: float
    activation: str = "silu"
    softmax: bool = False
    concat_ua: bool = False
    attn_rate: float = 0.0

    @property
    def o_width(self) -> int:
        """Columns of o_input: h*dv, or 3*h*dv with concat_ua."""
        return self.num_heads * self.dv * (3 if self.concat_ua else 1)


def variant_name(meta: BlockMeta, has_bias: bool) -> str:
    """The variant's features joined by "+", or "default"."""
    parts = [name for name, on in (
        ("concat_ua", meta.concat_ua),
        ("softmax", meta.softmax),
        ("act_none", meta.activation == "none"),
        ("no_bias", not has_bias),
        ("attn_dropout", meta.attn_rate > 0.0),
        ("wide", max(meta.dqk, meta.dv) > HEAD_DIM_CHUNK),
    ) if on]
    return "+".join(parts) or "default"


def ln_backward(a: torch.Tensor, dn: torch.Tensor, eps: float) -> torch.Tensor:
    """d/da of n = (a - mean(a)) * rsqrt(var(a) + eps), given dn (`_ln_bwd`)."""
    mu = a.mean(dim=-1, keepdim=True)
    var = a.var(dim=-1, keepdim=True, unbiased=False)
    inv = torch.rsqrt(var + eps)
    nh = (a - mu) * inv
    return inv * (dn - dn.mean(dim=-1, keepdim=True)
                  - nh * (dn * nh).mean(dim=-1, keepdim=True))


def _mask(colmask: torch.Tensor) -> torch.Tensor:
    """(B, n, n) f32 causal x column-valid mask."""
    n = colmask.shape[1]
    causal = torch.tril(torch.ones(n, n, dtype=torch.float32, device=colmask.device))
    return causal[None] * colmask[:, None, :]


def _bias(rel_pos, ext, tsw, num_buckets: int) -> torch.Tensor:
    """(B, n, n) f32 rel-pos + time-bucket bias (`_compute_bias`)."""
    n = rel_pos.shape[0]
    delta = ext[:, 1:, None] - ext[:, None, :n]
    return rel_pos[None] + tsw[time_bucket(delta, num_buckets).long()]


def _check_variant(meta: BlockMeta, rel_pos, ext, tsw) -> bool:
    """Raise on a variant the block does not take; returns has_bias."""
    if meta.activation not in _ACTIVATIONS:
        raise ValueError(f"activation {meta.activation!r}; expected one of {_ACTIVATIONS}")
    has_bias = rel_pos is not None
    if any((t is not None) != has_bias for t in (ext, tsw)):
        raise ValueError("rel_pos, ext and tsw are given together (the bias) or all None")
    return has_bias


def tc_fwd_route(dtype: torch.dtype, d: int, meta: BlockMeta) -> bool:
    """Whether `fused_train_block_forward` runs on the tensor cores: K1's
    `tc_block` (bf16, D <= 272, dqk and dv <= 32, h <= 3 or an even h <= 8,
    the SiLU projection), pointwise or softmax attention, with or without the
    bias and either dropout. f32, linear_activation="none" and wider heads
    run the CUDA-core kernels of csrc/hstu_block_train.cu."""
    return tc_block(dtype, d, meta.num_heads, meta.dqk, meta.dv, meta.activation)


def tc_bwd_route(dtype: torch.dtype, meta: BlockMeta) -> bool:
    """Whether `attn_backward` runs on the tensor cores
    (csrc/hstu_train_tc.cuh): `tc_fwd_route`'s widths and activation with the
    pointwise attention. The softmax backward stays on
    csrc/hstu_softmax_train.cu."""
    return not meta.softmax and tc_block(dtype, 1, meta.num_heads, meta.dqk, meta.dv,
                                         meta.activation)


def tf32_fwd_route(dtype: torch.dtype, d: int, n: int, meta: BlockMeta) -> bool:
    """Whether `fused_train_block_forward` runs K4's f32 forward on the tensor
    cores, every product as 3xTF32 on mma.sync (csrc/hstu_train_tf32.cuh):
    f32 operands at `tc_route`'s widths (D <= 272, dqk and dv <= 32, h <= 3
    or an even h <= 8) with n <= TF32_MAX_N = 512, the SiLU projection and the
    pointwise attention, with or without the bias. o_input dropout,
    attention dropout and concat_ua take the same kernels (runtime
    switches). The softmax attention, linear_activation="none", wider heads
    and longer sequences run the CUDA-core kernels of
    csrc/hstu_block_train.cu and hstu_softmax_train.cu."""
    return (dtype == torch.float32 and meta.activation == "silu" and not meta.softmax
            and 1 <= n <= TF32_MAX_N and tc_widths(d, meta.num_heads, meta.dqk, meta.dv))


def tf32_bwd_route(dtype: torch.dtype, n: int, meta: BlockMeta) -> bool:
    """Whether `attn_backward` runs K4's f32 attention backward on the tensor
    cores (3xTF32): `tf32_fwd_route`'s rule without D."""
    return tf32_fwd_route(dtype, 1, n, meta)


def _keep_masks(b: int, n: int, seed: int, meta: BlockMeta, device):
    """(o_input keep mask or None, attention keep mask or None) of the layer
    seed, as the JAX kernels draw them."""
    keep = attn_keep = None
    if meta.rate > 0.0:
        keep = hash_keep_mask_reference(b, n, meta.o_width, seed, meta.rate, device)
    if meta.attn_rate > 0.0:
        attn_keep = attn_keep_mask_reference(b, n, 1 if meta.softmax else meta.num_heads, seed,
                                             meta.attn_rate, device)
    return keep, attn_keep


def fused_train_block_forward_reference(
    x: torch.Tensor,          # (B, n, D) f32 or bf16
    colmask: torch.Tensor,    # (B, n) f32 {0, 1}
    uvqk: torch.Tensor,       # (D, 2h*dv + 2h*dqk), x's dtype
    o_kernel: torch.Tensor,   # (o_width, D), x's dtype
    o_bias: torch.Tensor,     # (D,) f32
    rel_pos: Optional[torch.Tensor],   # (n, n) f32, or None (no bias)
    ext: Optional[torch.Tensor],       # (B, n+1) int32, or None
    tsw: Optional[torch.Tensor],       # (128,) f32, or None
    seed: int,
    meta: BlockMeta,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward: (out (B, n, D) in x's dtype, attn
    (B, n, h*dv) f32)."""
    _check_variant(meta, rel_pos, ext, tsw)
    b, n = x.shape[:2]
    keep, attn_keep = _keep_masks(b, n, seed, meta, x.device)
    return block_forward_reference(
        x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, num_heads=meta.num_heads,
        dqk=meta.dqk, dv=meta.dv, inv_n=meta.inv_n, eps=meta.eps,
        num_buckets=meta.num_buckets, keep=keep, activation=meta.activation,
        softmax=meta.softmax, attn_keep=attn_keep,
    )


def train_attention_oinput_reference(
    u: torch.Tensor,          # (B, n, h*dv) f32
    v: torch.Tensor,          # (B, n, h*dv) matmul dtype, 1/max_seq_len folded in unless softmax
    q: torch.Tensor,          # (B, n, h*dqk) matmul dtype
    k: torch.Tensor,          # (B, n, h*dqk) matmul dtype
    colmask: torch.Tensor,
    rel_pos: Optional[torch.Tensor],
    ext: Optional[torch.Tensor],
    tsw: Optional[torch.Tensor],
    seed: int,
    meta: BlockMeta,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the train forward's attention stage, between K1's
    `project_reference` and `out_gemm_reference` (composed they give
    `fused_train_block_forward_reference` bit for bit): (o_input (B, n,
    o_width) in the matmul dtype with its keep mask applied before the
    rounding, attn (B, n, h*dv) f32), the attention weights times their keep
    mask before they round (`_fwd_kernel` :209-229)."""
    has_bias = _check_variant(meta, rel_pos, ext, tsw)
    b, n, _ = u.shape
    h, dqk, dv, mm = meta.num_heads, meta.dqk, meta.dv, q.dtype
    keep, attn_keep = _keep_masks(b, n, seed, meta, u.device)
    v, q, k = v.float(), q.float(), k.float()
    add = _bias(rel_pos, ext, tsw, meta.num_buckets) if has_bias else None
    mask = _mask(colmask)
    if meta.softmax:
        qk = q @ k.transpose(1, 2)
        if add is not None:
            qk = qk + add
        p = qk * (1.0 / float(dqk) ** 0.5)
        e = torch.exp(p - p.amax(dim=-1, keepdim=True))
        a = e / e.sum(dim=-1, keepdim=True)
        a = a * mask
        if attn_keep is not None:
            a = a * attn_keep[:, 0]
        attn = a.to(mm).float() @ v
    else:
        qk = torch.einsum("bnhd,bmhd->bhnm", q.reshape(b, n, h, dqk), k.reshape(b, n, h, dqk))
        if add is not None:
            qk = qk + add[:, None]
        a = qk * torch.sigmoid(qk)
        a = a * mask[:, None]
        if attn_keep is not None:
            a = a * attn_keep
        attn = torch.einsum("bhnm,bmhd->bnhd", a.to(mm).float(), v.reshape(b, n, h, dv))
        attn = attn.reshape(b, n, h * dv)
    a_ln = ln(attn, meta.eps)
    o_in = torch.cat([u, a_ln, u * a_ln], dim=-1) if meta.concat_ua else u * a_ln
    if keep is not None:
        o_in = o_in * keep
    return o_in.to(mm), attn


def _check(name: str, tensors: dict) -> None:
    for key, (t, dtype, shape) in tensors.items():
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: {key} must be a contiguous {dtype} {shape}; got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )


def _bias_expect(has_bias: bool, b: int, n: int, rel_pos, ext, tsw) -> dict:
    if not has_bias:
        return {}
    return {"rel_pos": (rel_pos, torch.float32, (n, n)),
            "ext": (ext, torch.int32, (b, n + 1)), "tsw": (tsw, torch.float32, (128,))}


def _count(fn, dtype: torch.dtype, meta: BlockMeta, has_bias: bool, tc: bool = False) -> None:
    fn.launches += 1
    fn.tc_launches += tc
    if dtype == torch.bfloat16:
        fn.bf16_launches += 1
    name = variant_name(meta, has_bias)
    if name != "default":
        fn.variant_launches[name] = fn.variant_launches.get(name, 0) + 1


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _attn_drop_args(meta: BlockMeta) -> tuple:
    """(use, threshold, scale) of the attention keep mask."""
    if meta.attn_rate <= 0.0:
        return 0, 0, 1.0
    return 1, keep_threshold(meta.attn_rate), 1.0 / (1.0 - meta.attn_rate)


def train_attention_oinput(u, vqk, colmask, rel_pos, ext, tsw, seed: int,
                           meta: BlockMeta) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train forward's attention stage over K1's `project` (u, vqk):
    (o_input, attn) as `train_attention_oinput_reference` gives them. CUDA:
    `tc_attn_kernel` or `tc_softmax_kernel` of csrc/hstu_block_tc.cuh in
    their TRAIN instance (bf16 at the widths of `tc_route`, else raises)."""
    has_bias = _check_variant(meta, rel_pos, ext, tsw)
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    tensors = tuple(t for t in (u, vqk, colmask, rel_pos, ext, tsw) if t is not None)
    if not use_kernel(*tensors):
        v, q, k = split_vqk(vqk, num_heads=h, dqk=dqk, dv=dv)
        return train_attention_oinput_reference(u, v, q, k, colmask, rel_pos, ext, tsw, seed,
                                                meta)
    b, n, _ = u.shape
    require_tc(vqk.dtype, 1, h, dqk, dv, "train_attention_oinput")
    f32 = torch.float32
    _check("train_attention_oinput", {
        "u": (u, f32, (b, n, h * dv)),
        "vqk": (vqk, torch.bfloat16, (b, n, vqk_layout(h, dqk, dv)[2])),
        "colmask": (colmask, f32, (b, n)), **_bias_expect(has_bias, b, n, rel_pos, ext, tsw),
    })
    lib = _build.load_library()
    check_tc_smem(lib, n, h, dqk, dv, meta.softmax, "train_attention_oinput")
    drop = meta.rate > 0.0
    with torch.cuda.device(u.device):
        oin = torch.empty(b, n, meta.o_width, dtype=torch.bfloat16, device=u.device)
        attn = torch.empty(b, n, h * dv, dtype=f32, device=u.device)
        err = lib.rails_hstu_tc_train_attention(
            vqk.data_ptr(), u.data_ptr(), colmask.data_ptr(), _ptr(rel_pos), _ptr(ext), _ptr(tsw),
            oin.data_ptr(), attn.data_ptr(), b, n, h, dqk, dv, 1.0 / float(dqk) ** 0.5, meta.eps,
            min(meta.num_buckets, 127), int(has_bias), int(meta.softmax), int(meta.concat_ua),
            wrap_i32(seed), int(drop), keep_threshold(meta.rate) if drop else 0,
            1.0 / (1.0 - meta.rate) if drop else 1.0, *_attn_drop_args(meta),
            torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(lib, err, "train_attention_oinput")
    train_attention_oinput.launches += 1
    return oin, attn


train_attention_oinput.launches = 0


def fused_train_block_forward(
    x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, seed: int, meta: BlockMeta,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train block's forward; same arguments as
    `fused_train_block_forward_reference`. At `tc_fwd_route`'s widths: K1's
    `project`, `train_attention_oinput` and K1's `out_gemm`, three
    tensor-core launches (`.tc_launches` counts these calls)."""
    has_bias = _check_variant(meta, rel_pos, ext, tsw)
    tensors = tuple(t for t in (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw)
                    if t is not None)
    if not use_kernel(*tensors):
        return fused_train_block_forward_reference(x, colmask, uvqk, o_kernel, o_bias, rel_pos,
                                                   ext, tsw, seed, meta)
    b, n, d = x.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    f = 2 * h * dv + 2 * h * dqk
    f32, mm = torch.float32, x.dtype
    if mm not in _DTYPE_CODE:
        raise ValueError(f"fused_train_block_forward: unsupported dtype {mm}")
    _check("fused_train_block_forward", {
        "x": (x, mm, (b, n, d)), "colmask": (colmask, f32, (b, n)),
        "uvqk": (uvqk, mm, (d, f)), "o_kernel": (o_kernel, mm, (meta.o_width, d)),
        "o_bias": (o_bias, f32, (d,)), **_bias_expect(has_bias, b, n, rel_pos, ext, tsw),
    })
    if tc_fwd_route(mm, d, meta):
        u, vqk = project(x, uvqk, num_heads=h, dqk=dqk, dv=dv, inv_n=meta.inv_n, eps=meta.eps,
                         activation=meta.activation, softmax=meta.softmax)
        oin, attn = train_attention_oinput(u, vqk, colmask, rel_pos, ext, tsw, seed, meta)
        out = out_gemm(oin, o_kernel, o_bias, x)
        _count(fused_train_block_forward, mm, meta, has_bias, tc=True)
        return out, attn
    if tf32_fwd_route(mm, d, n, meta):
        y = tf32_project(x, uvqk, meta)
        attn = tf32_attention(y, colmask, rel_pos, ext, tsw, seed, meta)
        out = tf32_out_gemm(x, y, attn, o_kernel, o_bias, seed, meta)
        _count(fused_train_block_forward, mm, meta, has_bias, tc=True)
        return out, attn
    lib = _build.load_library()
    smem = (lib.rails_hstu_softmax_smem_bytes(n, h, dqk, dv) if meta.softmax
            else lib.rails_hstu_attn_smem_bytes(n, dqk, dv))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"fused_train_block_forward: n={n} needs {smem} B of shared memory")
    drop = meta.rate > 0.0
    with torch.cuda.device(x.device):
        y = torch.empty(b * n, f, dtype=f32, device=x.device)
        attn = torch.empty(b, n, h * dv, dtype=f32, device=x.device)
        out = torch.empty_like(x)
        err = lib.rails_hstu_train_fwd(
            _DTYPE_CODE[mm], x.data_ptr(), colmask.data_ptr(), uvqk.data_ptr(),
            o_kernel.data_ptr(), o_bias.data_ptr(), _ptr(rel_pos), _ptr(ext), _ptr(tsw),
            y.data_ptr(), attn.data_ptr(), out.data_ptr(), b, n, d, h, dqk, dv, meta.inv_n,
            1.0 / float(dqk) ** 0.5, meta.eps, min(meta.num_buckets, 127),
            int(meta.activation == "none"), int(meta.softmax), int(meta.concat_ua),
            int(has_bias), int(drop), wrap_i32(seed),
            keep_threshold(meta.rate) if drop else 0, 1.0 / (1.0 - meta.rate) if drop else 1.0,
            *_attn_drop_args(meta), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "fused_train_block_forward")
    _count(fused_train_block_forward, mm, meta, has_bias)
    return out, attn


fused_train_block_forward.launches = 0
fused_train_block_forward.bf16_launches = 0
fused_train_block_forward.tc_launches = 0
fused_train_block_forward.variant_launches = {}


def _d_o_split(d_o: torch.Tensor, gln: torch.Tensor, u: torch.Tensor, concat_ua: bool):
    """(d_u, d_gln) from d(o_input): o_input = u * gln, or [u, gln, u * gln]."""
    if not concat_ua:
        return d_o * gln, d_o * u
    w = u.shape[-1]
    d_prod = d_o[..., 2 * w:]
    return d_o[..., :w] + d_prod * gln, d_o[..., w:2 * w] + d_prod * u


def attn_backward_reference(
    y: torch.Tensor,          # (B, n, F) act(LN(x) @ uvqk) in the matmul dtype
    d_o_in: torch.Tensor,     # (B, n, o_width) y's dtype, keep mask applied
    attn: Optional[torch.Tensor],   # (B, n, h*dv) f32 from the forward (f32), or None
    colmask: torch.Tensor,    # (B, n) f32
    rel_pos: Optional[torch.Tensor],   # (n, n) f32, or None (no bias)
    ext: Optional[torch.Tensor],       # (B, n+1) int32, or None
    tsw: Optional[torch.Tensor],       # (128,) f32, or None
    meta: BlockMeta,
    seed: int = 0,            # the layer's seed: the attention keep mask's
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Plain version of the attention-core backward, batched over users and
    heads: (d_y (B, n, F) = [d_u, d_v, d_q, d_k], dbias (B, n, n) or None
    without the bias, attn), all f32. With `attn` None the attention output
    is recomputed from y, as the JAX backward does (the bf16 instance); every
    product rounds its operands to y's dtype where `_attn_bwd_kernel` casts
    to `mm`."""
    has_bias = _check_variant(meta, rel_pos, ext, tsw)
    b, n, _ = y.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    hdv, hq = h * dv, h * dqk
    mm = y.dtype

    def rnd(t: torch.Tensor) -> torch.Tensor:
        return t.to(mm).float()

    yf = y.float()
    u = yf[..., :hdv]
    q = yf[..., 2 * hdv : 2 * hdv + hq]
    k = yf[..., 2 * hdv + hq :]
    mask = _mask(colmask)
    bias = _bias(rel_pos, ext, tsw, meta.num_buckets) if has_bias else None
    keep = None
    if meta.attn_rate > 0.0:
        keep = attn_keep_mask_reference(b, n, 1 if meta.softmax else h, seed, meta.attn_rate,
                                        y.device)
    if meta.softmax:
        # One map over the full h*dqk contraction; the mask after
        # normalisation, so d_s is dense.
        v = rnd(yf[..., hdv : 2 * hdv])
        t = q @ k.transpose(1, 2)
        if bias is not None:
            t = t + bias
        t = t * (1.0 / float(dqk) ** 0.5)
        e = torch.exp(t - t.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        a = p * mask
        if keep is not None:
            a = a * keep[:, 0]
        a = rnd(a)
        if attn is None:
            attn = a @ v
        d_u, d_gln = _d_o_split(d_o_in.float(), ln(attn, meta.eps), u, meta.concat_ua)
        d_attn = rnd(ln_backward(attn, d_gln, meta.eps))
        d_a = d_attn @ v.transpose(1, 2)
        if keep is not None:
            d_a = d_a * keep[:, 0]
        d_p = d_a * mask
        d_s = p * (d_p - (d_p * p).sum(dim=-1, keepdim=True)) * (1.0 / float(dqk) ** 0.5)
        d_s_mm = rnd(d_s)
        d_v = a.transpose(1, 2) @ d_attn
        d_q = d_s_mm @ k
        d_k = d_s_mm.transpose(1, 2) @ q
        d_y = torch.cat([d_u, d_v, d_q, d_k], dim=-1)
        return d_y, d_s if has_bias else None, attn
    v = rnd(yf[..., hdv : 2 * hdv] * meta.inv_n).reshape(b, n, h, dv)
    q = q.reshape(b, n, h, dqk)
    k = k.reshape(b, n, h, dqk)
    penalty = (mask - 1.0) * PENALTY
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) + (
        penalty if bias is None else bias + penalty)[:, None]
    sig = torch.sigmoid(s)
    a = s * sig
    deriv = sig * (1.0 + s * (1.0 - sig))
    if keep is not None:
        a = a * keep
    a = rnd(a)
    if attn is None:
        attn = torch.einsum("bhnm,bmhd->bnhd", a, v).reshape(b, n, hdv)
    d_u, d_gln = _d_o_split(d_o_in.float(), ln(attn, meta.eps), u, meta.concat_ua)
    d_attn = rnd(ln_backward(attn, d_gln, meta.eps)).reshape(b, n, h, dv)
    d_a = torch.einsum("bnhd,bmhd->bhnm", d_attn, v)
    if keep is not None:
        d_a = d_a * keep
    d_s = d_a * deriv
    d_v = torch.einsum("bhnm,bnhd->bmhd", a, d_attn) * meta.inv_n
    d_s_mm = rnd(d_s)
    d_q = torch.einsum("bhnm,bmhd->bnhd", d_s_mm, k)
    d_k = torch.einsum("bhnm,bnhd->bmhd", d_s_mm, q)
    d_y = torch.cat([d_u, d_v.reshape(b, n, hdv), d_q.reshape(b, n, hq),
                     d_k.reshape(b, n, hq)], dim=-1)
    return d_y, d_s.sum(dim=1) if has_bias else None, attn


def _pointwise_maps(y, colmask, rel_pos, ext, tsw, meta: BlockMeta, seed: int):
    """The pointwise attention's per-head pieces as `attn_backward_reference`
    computes them from the bf16 y: (q, k (B, n, h, dqk), v (B, n, h, dv) JAX's
    twice-rounded bf16(bf16(y) / max_seq_len), a = bf16(silu(s) * keep) and
    silu'(s) (B, h, n, n), the keep mask or None), f32."""
    has_bias = _check_variant(meta, rel_pos, ext, tsw)
    b, n, _ = y.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    hdv, hq = h * dv, h * dqk
    mm = y.dtype
    yf = y.float()
    q = yf[..., 2 * hdv : 2 * hdv + hq].reshape(b, n, h, dqk)
    k = yf[..., 2 * hdv + hq :].reshape(b, n, h, dqk)
    v = (yf[..., hdv : 2 * hdv] * meta.inv_n).to(mm).float().reshape(b, n, h, dv)
    mask = _mask(colmask)
    bias = _bias(rel_pos, ext, tsw, meta.num_buckets) if has_bias else None
    keep = None
    if meta.attn_rate > 0.0:
        keep = attn_keep_mask_reference(b, n, h, seed, meta.attn_rate, y.device)
    penalty = (mask - 1.0) * PENALTY
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) + (
        penalty if bias is None else bias + penalty)[:, None]
    sig = torch.sigmoid(s)
    a = s * sig
    deriv = sig * (1.0 + s * (1.0 - sig))
    if keep is not None:
        a = a * keep
    return q, k, v, a.to(mm).float(), deriv, keep


def _stage_d_y(y: torch.Tensor, d_y: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.zeros(y.shape, dtype=torch.float32, device=y.device) if d_y is None else d_y


def attn_bwd_rows_reference(y, d_o_in, colmask, rel_pos, ext, tsw, meta: BlockMeta,
                            seed: int = 0, d_y: Optional[torch.Tensor] = None):
    """Plain version of the tensor-core backward's first stage (pointwise
    attention, bf16 y): (d_y with its d_u columns written, d_attn (B, n,
    h*dv) in y's dtype, attn (B, n, h*dv) f32), attn recomputed from y and
    d_attn = LN-backward(attn, d_gln) rounded, as `attn_backward_reference`
    computes them. A new d_y is zeros."""
    b, n, _ = y.shape
    hdv = meta.num_heads * meta.dv
    _, _, v, a, _, _ = _pointwise_maps(y, colmask, rel_pos, ext, tsw, meta, seed)
    attn = torch.einsum("bhnm,bmhd->bnhd", a, v).reshape(b, n, hdv)
    d_u, d_gln = _d_o_split(d_o_in.float(), ln(attn, meta.eps), y.float()[..., :hdv],
                            meta.concat_ua)
    d_y = _stage_d_y(y, d_y)
    d_y[..., :hdv] = d_u
    return d_y, ln_backward(attn, d_gln, meta.eps).to(y.dtype), attn


def attn_bwd_dq_reference(y, d_attn, colmask, rel_pos, ext, tsw, meta: BlockMeta, seed: int = 0,
                          d_y: Optional[torch.Tensor] = None):
    """Plain version of the second stage (and of the f32 route's dq stage,
    y f32): (d_y with its d_q columns written, dbias = sum_h d_s (B, n, n)
    f32, or None without the bias)."""
    has_bias = _check_variant(meta, rel_pos, ext, tsw)
    b, n, _ = y.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    _, k, v, _, deriv, keep = _pointwise_maps(y, colmask, rel_pos, ext, tsw, meta, seed)
    d_a = torch.einsum("bnhd,bmhd->bhnm", d_attn.float().reshape(b, n, h, dv), v)
    if keep is not None:
        d_a = d_a * keep
    d_s = d_a * deriv
    d_q = torch.einsum("bhnm,bmhd->bnhd", d_s.to(y.dtype).float(), k)
    d_y = _stage_d_y(y, d_y)
    d_y[..., 2 * h * dv : 2 * h * dv + h * dqk] = d_q.reshape(b, n, h * dqk)
    return d_y, d_s.sum(dim=1) if has_bias else None


def attn_bwd_dkv_reference(y, d_attn, colmask, rel_pos, ext, tsw, meta: BlockMeta,
                           seed: int = 0, d_y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the third stage (and of the f32 route's dkv stage):
    d_y with its d_v and d_k columns written."""
    b, n, _ = y.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    hdv = h * dv
    q, _, v, a, deriv, keep = _pointwise_maps(y, colmask, rel_pos, ext, tsw, meta, seed)
    d_attn = d_attn.float().reshape(b, n, h, dv)
    d_a = torch.einsum("bnhd,bmhd->bhnm", d_attn, v)
    if keep is not None:
        d_a = d_a * keep
    d_s = d_a * deriv
    d_v = torch.einsum("bhnm,bnhd->bmhd", a, d_attn) * meta.inv_n
    d_k = torch.einsum("bhnm,bnhd->bmhd", d_s.to(y.dtype).float(), q)
    d_y = _stage_d_y(y, d_y)
    d_y[..., hdv : 2 * hdv] = d_v.reshape(b, n, hdv)
    d_y[..., 2 * hdv + h * dqk :] = d_k.reshape(b, n, h * dqk)
    return d_y


_BWD_STAGES = {"rows": 0, "dq": 1, "dkv": 2}


def _tc_bwd_launch(stage: str, y, d_o_in, d_attn, colmask, rel_pos, ext, tsw, meta: BlockMeta,
                   seed: int, d_y: Optional[torch.Tensor]):
    """Validate and launch one stage of the tensor-core backward
    (`rails_hstu_tc_train_bwd`); returns (d_y, d_attn, attn, dbias), the
    stage's outputs and None for the others."""
    has_bias = _check_variant(meta, rel_pos, ext, tsw)
    b, n, f = y.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    what = f"attn_bwd_{stage}"
    if meta.softmax:
        raise ValueError(f"{what}: the softmax backward has no tensor-core stages")
    require_tc(y.dtype, 1, h, dqk, dv, what)
    f32, bf16 = torch.float32, torch.bfloat16
    expect = {"y": (y, bf16, (b, n, 2 * h * dv + 2 * h * dqk)),
              "colmask": (colmask, f32, (b, n)), **_bias_expect(has_bias, b, n, rel_pos, ext, tsw)}
    if stage == "rows":
        expect["d_o_in"] = (d_o_in, bf16, (b, n, meta.o_width))
    else:
        expect["d_attn"] = (d_attn, bf16, (b, n, h * dv))
    if d_y is not None:
        expect["d_y"] = (d_y, f32, (b, n, f))
    _check(what, expect)
    lib = _build.load_library()
    code = _BWD_STAGES[stage]
    smem = lib.rails_hstu_tc_train_bwd_smem_bytes(code, n, h, dqk, dv)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{what}: n={n} needs {smem} B of shared memory")
    attn = dbias = d_attn_out = None
    with torch.cuda.device(y.device):
        if d_y is None:
            d_y = torch.zeros(b, n, f, dtype=f32, device=y.device)
        if stage == "rows":
            d_attn_out = torch.empty(b, n, h * dv, dtype=bf16, device=y.device)
            attn = torch.empty(b, n, h * dv, dtype=f32, device=y.device)
        if stage == "dq" and has_bias:
            dbias = torch.empty(b, n, n, dtype=f32, device=y.device)
        adrop = _attn_drop_args(meta)
        err = lib.rails_hstu_tc_train_bwd(
            code, y.data_ptr(), _ptr(d_o_in if stage == "rows" else None),
            _ptr(d_attn if stage != "rows" else None), _ptr(d_attn_out), _ptr(attn),
            d_y.data_ptr(), _ptr(dbias), colmask.data_ptr(), _ptr(rel_pos), _ptr(ext), _ptr(tsw),
            b, n, h, dqk, dv, meta.inv_n, meta.eps, min(meta.num_buckets, 127), int(has_bias),
            int(meta.concat_ua), adrop[0], wrap_i32(seed), *adrop[1:],
            torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, err, what)
    return d_y, d_attn_out, attn, dbias


def attn_bwd_rows(y, d_o_in, colmask, rel_pos, ext, tsw, meta: BlockMeta, seed: int = 0,
                  d_y: Optional[torch.Tensor] = None):
    """The tensor-core backward's first stage; same arguments and results as
    `attn_bwd_rows_reference`. CUDA: `tc_bwd_rows_kernel`
    (csrc/hstu_train_tc.cuh), bf16 at `tc_route`'s widths, else raises."""
    tensors = tuple(t for t in (y, d_o_in, colmask, rel_pos, ext, tsw, d_y) if t is not None)
    if not use_kernel(*tensors):
        return attn_bwd_rows_reference(y, d_o_in, colmask, rel_pos, ext, tsw, meta, seed, d_y)
    d_y, d_attn, attn, _ = _tc_bwd_launch("rows", y, d_o_in, None, colmask, rel_pos, ext, tsw,
                                          meta, seed, d_y)
    attn_bwd_rows.launches += 1
    return d_y, d_attn, attn


def attn_bwd_dq(y, d_attn, colmask, rel_pos, ext, tsw, meta: BlockMeta, seed: int = 0,
                d_y: Optional[torch.Tensor] = None):
    """The second stage; same arguments and results as
    `attn_bwd_dq_reference`. CUDA: `tc_bwd_dq_kernel`."""
    tensors = tuple(t for t in (y, d_attn, colmask, rel_pos, ext, tsw, d_y) if t is not None)
    if not use_kernel(*tensors):
        return attn_bwd_dq_reference(y, d_attn, colmask, rel_pos, ext, tsw, meta, seed, d_y)
    d_y, _, _, dbias = _tc_bwd_launch("dq", y, None, d_attn, colmask, rel_pos, ext, tsw, meta,
                                      seed, d_y)
    attn_bwd_dq.launches += 1
    return d_y, dbias


def attn_bwd_dkv(y, d_attn, colmask, rel_pos, ext, tsw, meta: BlockMeta, seed: int = 0,
                 d_y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The third stage; same arguments and results as
    `attn_bwd_dkv_reference`. CUDA: `tc_bwd_dkv_kernel`."""
    tensors = tuple(t for t in (y, d_attn, colmask, rel_pos, ext, tsw, d_y) if t is not None)
    if not use_kernel(*tensors):
        return attn_bwd_dkv_reference(y, d_attn, colmask, rel_pos, ext, tsw, meta, seed, d_y)
    d_y = _tc_bwd_launch("dkv", y, None, d_attn, colmask, rel_pos, ext, tsw, meta, seed, d_y)[0]
    attn_bwd_dkv.launches += 1
    return d_y


attn_bwd_rows.launches = 0
attn_bwd_dq.launches = 0
attn_bwd_dkv.launches = 0


# ---- K4's f32 route on the tensor cores (3xTF32, csrc/hstu_train_tf32.cuh):
# three forward stages, three backward stages; plain versions beside them.


def tf32_project_reference(x: torch.Tensor, uvqk: torch.Tensor, meta: BlockMeta) -> torch.Tensor:
    """Plain version of the f32 route's projection: y = SiLU(LN(x) @ uvqk),
    (B, n, F) f32."""
    y = ln(x.float(), meta.eps) @ uvqk.float()
    return y * torch.sigmoid(y)


def tf32_attention_reference(y, colmask, rel_pos, ext, tsw, seed: int,
                             meta: BlockMeta) -> torch.Tensor:
    """Plain version of the f32 route's attention: attn (B, n, h*dv) f32 from
    y = [u | v | q | k], v times 1/max_seq_len."""
    hdv, hq = meta.num_heads * meta.dv, meta.num_heads * meta.dqk
    u, v = y[..., :hdv], y[..., hdv:2 * hdv] * meta.inv_n
    q, k = y[..., 2 * hdv:2 * hdv + hq], y[..., 2 * hdv + hq:]
    return train_attention_oinput_reference(u, v, q, k, colmask, rel_pos, ext, tsw, seed, meta)[1]


def tf32_out_gemm_reference(x, y, attn, o_kernel, o_bias, seed: int,
                            meta: BlockMeta) -> torch.Tensor:
    """Plain version of the f32 route's output GEMM: out = o_input @ Wo + bo
    + x, o_input = u * LN(attn) (concat_ua: [u, LN(attn), u * LN(attn)])
    times its keep mask."""
    b, n, _ = x.shape
    u, a_ln = y[..., :meta.num_heads * meta.dv], ln(attn, meta.eps)
    o_in = torch.cat([u, a_ln, u * a_ln], dim=-1) if meta.concat_ua else u * a_ln
    keep, _ = _keep_masks(b, n, seed, meta, x.device)
    if keep is not None:
        o_in = o_in * keep
    return o_in @ o_kernel.float() + o_bias.float() + x.float()


def tf32_bwd_rows_reference(y, d_o_in, attn, meta: BlockMeta,
                            d_y: Optional[torch.Tensor] = None):
    """Plain version of the f32 route's backward rows stage: (d_y with its
    d_u columns written, d_attn (B, n, h*dv) f32), from the forward's attn.
    The dq and dkv stages' plain versions are `attn_bwd_dq_reference` and
    `attn_bwd_dkv_reference`, which take an f32 y as they take a bf16 one."""
    hdv = meta.num_heads * meta.dv
    d_u, d_gln = _d_o_split(d_o_in.float(), ln(attn, meta.eps), y.float()[..., :hdv],
                            meta.concat_ua)
    d_y = _stage_d_y(y, d_y)
    d_y[..., :hdv] = d_u
    return d_y, ln_backward(attn, d_gln, meta.eps)


_TF32_GEMM_SMEM, _TF32_BWD_STAGES = 3, {"rows": 0, "dq": 1, "dkv": 2}


def _tf32_lib(what: str, dtype: torch.dtype, d: int, n: int, meta: BlockMeta,
              kind: Optional[int]):
    """The library, after the route and shared-memory checks of one f32-route
    launch (kind: 0 attention, 1 dq, 2 dkv, 3 the GEMMs, None the rows
    stage, which uses none)."""
    if not tf32_fwd_route(dtype, d, n, meta):
        raise ValueError(f"{what}: no 3xTF32 instance for {dtype}, D={d}, n={n}, "
                         f"h={meta.num_heads}, dqk={meta.dqk}, dv={meta.dv}, "
                         f"{meta.activation}, softmax={meta.softmax} (tf32_fwd_route)")
    lib = _build.load_library()
    if kind is None:
        return lib
    smem = lib.rails_hstu_tf32_smem_bytes(kind, n, meta.dqk, meta.dv)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{what}: n={n} needs {smem} B of shared memory")
    return lib


def tf32_project(x, uvqk, meta: BlockMeta) -> torch.Tensor:
    """The f32 route's projection; same arguments and result as
    `tf32_project_reference`. CUDA: `tc_tf32_proj_kernel`."""
    if not use_kernel(x, uvqk):
        return tf32_project_reference(x, uvqk, meta)
    b, n, d = x.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    f = 2 * h * dv + 2 * h * dqk
    lib = _tf32_lib("tf32_project", x.dtype, d, n, meta, _TF32_GEMM_SMEM)
    f32 = torch.float32
    _check("tf32_project", {"x": (x, f32, (b, n, d)), "uvqk": (uvqk, f32, (d, f))})
    with torch.cuda.device(x.device):
        y = torch.empty(b, n, f, dtype=f32, device=x.device)
        err = lib.rails_hstu_tf32_project(x.data_ptr(), uvqk.data_ptr(), y.data_ptr(), b, n, d, h,
                                          dqk, dv, meta.eps,
                                          torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "tf32_project")
    tf32_project.launches += 1
    return y


def tf32_attention(y, colmask, rel_pos, ext, tsw, seed: int, meta: BlockMeta) -> torch.Tensor:
    """The f32 route's attention; same arguments and result as
    `tf32_attention_reference`. CUDA: `tc_tf32_attn_kernel`."""
    has_bias = _check_variant(meta, rel_pos, ext, tsw)
    tensors = tuple(t for t in (y, colmask, rel_pos, ext, tsw) if t is not None)
    if not use_kernel(*tensors):
        return tf32_attention_reference(y, colmask, rel_pos, ext, tsw, seed, meta)
    b, n, f = y.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    lib = _tf32_lib("tf32_attention", y.dtype, 1, n, meta, 0)
    f32 = torch.float32
    _check("tf32_attention", {"y": (y, f32, (b, n, 2 * h * dv + 2 * h * dqk)),
                              "colmask": (colmask, f32, (b, n)),
                              **_bias_expect(has_bias, b, n, rel_pos, ext, tsw)})
    with torch.cuda.device(y.device):
        attn = torch.empty(b, n, h * dv, dtype=f32, device=y.device)
        err = lib.rails_hstu_tf32_attention(
            y.data_ptr(), colmask.data_ptr(), _ptr(rel_pos), _ptr(ext), _ptr(tsw), attn.data_ptr(),
            b, n, h, dqk, dv, meta.inv_n, min(meta.num_buckets, 127), int(has_bias),
            wrap_i32(seed), *_attn_drop_args(meta), torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, err, "tf32_attention")
    tf32_attention.launches += 1
    return attn


def tf32_out_gemm(x, y, attn, o_kernel, o_bias, seed: int, meta: BlockMeta) -> torch.Tensor:
    """The f32 route's output GEMM; same arguments and result as
    `tf32_out_gemm_reference`. CUDA: `tc_tf32_out_kernel`."""
    if not use_kernel(x, y, attn, o_kernel, o_bias):
        return tf32_out_gemm_reference(x, y, attn, o_kernel, o_bias, seed, meta)
    b, n, d = x.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    lib = _tf32_lib("tf32_out_gemm", x.dtype, d, n, meta, _TF32_GEMM_SMEM)
    f32 = torch.float32
    _check("tf32_out_gemm", {
        "x": (x, f32, (b, n, d)), "y": (y, f32, (b, n, 2 * h * dv + 2 * h * dqk)),
        "attn": (attn, f32, (b, n, h * dv)), "o_kernel": (o_kernel, f32, (meta.o_width, d)),
        "o_bias": (o_bias, f32, (d,))})
    drop = meta.rate > 0.0
    with torch.cuda.device(x.device):
        out = torch.empty(b, n, d, dtype=f32, device=x.device)
        err = lib.rails_hstu_tf32_out(
            attn.data_ptr(), y.data_ptr(), o_kernel.data_ptr(), o_bias.data_ptr(), x.data_ptr(),
            out.data_ptr(), b, n, d, h, dqk, dv, meta.eps, int(meta.concat_ua), int(drop),
            wrap_i32(seed), keep_threshold(meta.rate) if drop else 0,
            1.0 / (1.0 - meta.rate) if drop else 1.0,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "tf32_out_gemm")
    tf32_out_gemm.launches += 1
    return out


def _tf32_bwd_launch(stage: str, y, d_o_in, attn, d_attn, colmask, rel_pos, ext, tsw,
                     meta: BlockMeta, seed: int, d_y: Optional[torch.Tensor]):
    """Validate and launch one stage of the f32 route's backward
    (`rails_hstu_tf32_bwd`); returns (d_y, d_attn, dbias), the stage's
    outputs and None for the others."""
    has_bias = _check_variant(meta, rel_pos, ext, tsw)
    b, n, f = y.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    what = f"tf32_bwd_{stage}"
    code = _TF32_BWD_STAGES[stage]
    lib = _tf32_lib(what, y.dtype, 1, n, meta, None if stage == "rows" else code)
    f32 = torch.float32
    expect = {"y": (y, f32, (b, n, 2 * h * dv + 2 * h * dqk))}
    if stage == "rows":
        expect.update(d_o_in=(d_o_in, f32, (b, n, meta.o_width)), attn=(attn, f32, (b, n, h * dv)))
    else:
        expect.update(d_attn=(d_attn, f32, (b, n, h * dv)), colmask=(colmask, f32, (b, n)),
                      **_bias_expect(has_bias, b, n, rel_pos, ext, tsw))
    if d_y is not None:
        expect["d_y"] = (d_y, f32, (b, n, f))
    _check(what, expect)
    d_attn_out = dbias = None
    with torch.cuda.device(y.device):
        if d_y is None:
            d_y = torch.zeros(b, n, f, dtype=f32, device=y.device)
        if stage == "rows":
            d_attn_out = torch.empty(b, n, h * dv, dtype=f32, device=y.device)
        if stage == "dq" and has_bias:
            dbias = torch.empty(b, n, n, dtype=f32, device=y.device)
        err = lib.rails_hstu_tf32_bwd(
            code, y.data_ptr(), _ptr(d_o_in), _ptr(attn), _ptr(d_attn), _ptr(d_attn_out),
            d_y.data_ptr(), _ptr(dbias), _ptr(colmask), _ptr(rel_pos), _ptr(ext), _ptr(tsw), b, n,
            h, dqk, dv, meta.inv_n, meta.eps, min(meta.num_buckets, 127), int(has_bias),
            int(meta.concat_ua), wrap_i32(seed), *_attn_drop_args(meta),
            torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, err, what)
    return d_y, d_attn_out, dbias


def tf32_bwd_rows(y, d_o_in, attn, meta: BlockMeta, d_y: Optional[torch.Tensor] = None):
    """The f32 route's backward rows stage; same arguments and results as
    `tf32_bwd_rows_reference`. CUDA: `attn_row_bwd_kernel` (csrc/hstu_train.cuh)."""
    if not use_kernel(*(t for t in (y, d_o_in, attn, d_y) if t is not None)):
        return tf32_bwd_rows_reference(y, d_o_in, attn, meta, d_y)
    d_y, d_attn, _ = _tf32_bwd_launch("rows", y, d_o_in, attn, None, None, None, None, None, meta,
                                      0, d_y)
    tf32_bwd_rows.launches += 1
    return d_y, d_attn


def tf32_bwd_dq(y, d_attn, colmask, rel_pos, ext, tsw, meta: BlockMeta, seed: int = 0,
                d_y: Optional[torch.Tensor] = None):
    """The f32 route's dq stage: (d_y with its d_q columns written, dbias or
    None) as `attn_bwd_dq_reference` gives them. CUDA: `tc_tf32_dq_kernel`."""
    tensors = tuple(t for t in (y, d_attn, colmask, rel_pos, ext, tsw, d_y) if t is not None)
    if not use_kernel(*tensors):
        return attn_bwd_dq_reference(y, d_attn, colmask, rel_pos, ext, tsw, meta, seed, d_y)
    d_y, _, dbias = _tf32_bwd_launch("dq", y, None, None, d_attn, colmask, rel_pos, ext, tsw, meta,
                                     seed, d_y)
    tf32_bwd_dq.launches += 1
    return d_y, dbias


def tf32_bwd_dkv(y, d_attn, colmask, rel_pos, ext, tsw, meta: BlockMeta, seed: int = 0,
                 d_y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The f32 route's dkv stage: d_y with its d_v and d_k columns written,
    as `attn_bwd_dkv_reference` gives it. CUDA: `tc_tf32_dkv_kernel`."""
    tensors = tuple(t for t in (y, d_attn, colmask, rel_pos, ext, tsw, d_y) if t is not None)
    if not use_kernel(*tensors):
        return attn_bwd_dkv_reference(y, d_attn, colmask, rel_pos, ext, tsw, meta, seed, d_y)
    d_y = _tf32_bwd_launch("dkv", y, None, None, d_attn, colmask, rel_pos, ext, tsw, meta, seed,
                           d_y)[0]
    tf32_bwd_dkv.launches += 1
    return d_y


for _fn in (tf32_project, tf32_attention, tf32_out_gemm, tf32_bwd_rows, tf32_bwd_dq, tf32_bwd_dkv):
    _fn.launches = 0


def attn_backward(
    y, d_o_in, attn, colmask, rel_pos, ext, tsw, meta: BlockMeta, seed: int = 0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """The attention-core backward; same arguments and results as
    `attn_backward_reference`. The f32 instance takes the forward's attn, the
    bf16 one recomputes it (`attn` None)."""
    if (attn is None) != (y.dtype == torch.bfloat16):
        raise ValueError("attn_backward: pass the forward's attn with f32 operands and None "
                         f"(recomputed) with bf16 ones; got y {y.dtype}, attn "
                         f"{'None' if attn is None else 'given'}")
    has_bias = _check_variant(meta, rel_pos, ext, tsw)
    tensors = tuple(t for t in (y, d_o_in, colmask, rel_pos, ext, tsw, attn) if t is not None)
    if not use_kernel(*tensors):
        return attn_backward_reference(y, d_o_in, attn, colmask, rel_pos, ext, tsw, meta, seed)
    b, n, f = y.shape
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    f32, mm = torch.float32, y.dtype
    if tc_bwd_route(mm, meta):
        with torch.cuda.device(y.device):
            d_y = torch.empty(b, n, f, dtype=f32, device=y.device)
        d_y, d_attn, attn = attn_bwd_rows(y, d_o_in, colmask, rel_pos, ext, tsw, meta, seed, d_y)
        d_y, dbias = attn_bwd_dq(y, d_attn, colmask, rel_pos, ext, tsw, meta, seed, d_y)
        d_y = attn_bwd_dkv(y, d_attn, colmask, rel_pos, ext, tsw, meta, seed, d_y)
        _count(attn_backward, mm, meta, has_bias, tc=True)
        return d_y, dbias, attn
    if tf32_bwd_route(mm, n, meta):
        with torch.cuda.device(y.device):   # the three stages write every column
            d_y = torch.empty(b, n, f, dtype=f32, device=y.device)
        d_y, d_attn = tf32_bwd_rows(y, d_o_in, attn, meta, d_y)
        d_y, dbias = tf32_bwd_dq(y, d_attn, colmask, rel_pos, ext, tsw, meta, seed, d_y)
        d_y = tf32_bwd_dkv(y, d_attn, colmask, rel_pos, ext, tsw, meta, seed, d_y)
        _count(attn_backward, mm, meta, has_bias, tc=True)
        return d_y, dbias, attn
    expect = {
        "y": (y, mm, (b, n, 2 * h * dv + 2 * h * dqk)),
        "d_o_in": (d_o_in, mm, (b, n, meta.o_width)), "colmask": (colmask, f32, (b, n)),
        **_bias_expect(has_bias, b, n, rel_pos, ext, tsw),
    }
    if attn is not None:
        expect["attn"] = (attn, f32, (b, n, h * dv))
    _check("attn_backward", expect)
    lib = _build.load_library()
    if meta.softmax:
        smem = max(lib.rails_hstu_softmax_train_bwd_smem_bytes(n, h, dqk, dv),
                   lib.rails_hstu_softmax_smem_bytes(n, h, dqk, dv) if attn is None else 0)
    else:
        smem = max(lib.rails_hstu_train_bwd_smem_bytes(n, dqk, dv),
                   lib.rails_hstu_attn_smem_bytes(n, dqk, dv) if attn is None else 0)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"attn_backward: n={n} needs {smem} B of shared memory")
    drop = _attn_drop_args(meta)
    with torch.cuda.device(y.device):
        if attn is None:
            attn = torch.empty(b, n, h * dv, dtype=f32, device=y.device)
        d_attn = torch.empty(b, n, h * dv, dtype=f32, device=y.device)
        d_y = torch.empty(b, n, f, dtype=f32, device=y.device)
        stream = torch.cuda.current_stream().cuda_stream
        # One backward instance with and without the bias: zero tables add
        # exactly 0 to s, and the dbias it then writes is dropped (has_bias
        # still picks the forward's instance for the bf16 recompute).
        if not has_bias:
            rel_pos = torch.zeros(n, n, dtype=f32, device=y.device)
            ext = torch.zeros(b, n + 1, dtype=torch.int32, device=y.device)
            tsw = torch.zeros(128, dtype=f32, device=y.device)
        # The softmax backward needs d_s for d_k whether or not the bias takes it.
        dbias = torch.empty(b, n, n, dtype=f32, device=y.device)
        tables = (rel_pos.data_ptr(), ext.data_ptr(), tsw.data_ptr())
        if meta.softmax:
            a = torch.empty(b, n, n, dtype=f32, device=y.device)
            err = lib.rails_hstu_softmax_train_bwd(
                _DTYPE_CODE[mm], y.data_ptr(), d_o_in.data_ptr(), attn.data_ptr(),
                colmask.data_ptr(), *tables, d_attn.data_ptr(), a.data_ptr(), d_y.data_ptr(),
                dbias.data_ptr(), b, n, h, dqk, dv, 1.0 / float(dqk) ** 0.5, meta.eps,
                min(meta.num_buckets, 127), int(meta.concat_ua), int(has_bias), drop[0],
                wrap_i32(seed), *drop[1:], stream,
            )
        else:
            err = lib.rails_hstu_train_bwd(
                _DTYPE_CODE[mm], y.data_ptr(), d_o_in.data_ptr(), attn.data_ptr(),
                colmask.data_ptr(), *tables, d_attn.data_ptr(), d_y.data_ptr(),
                dbias.data_ptr(), b, n, h, dqk, dv, meta.inv_n, meta.eps,
                min(meta.num_buckets, 127), int(meta.activation == "none"), int(meta.concat_ua),
                int(has_bias), drop[0], wrap_i32(seed), *drop[1:], stream,
            )
        dbias = dbias if has_bias else None
    _build.check(lib, err, "attn_backward")
    _count(attn_backward, mm, meta, has_bias)
    return d_y, dbias, attn


attn_backward.launches = 0
attn_backward.bf16_launches = 0
attn_backward.tc_launches = 0
attn_backward.variant_launches = {}


class FusedTrainBlock(torch.autograd.Function):
    """One HSTU block in training, differentiable with respect to x, rel_pos,
    tsw, uvqk, o_kernel and o_bias (the JAX block's custom VJP); rel_pos,
    ext and tsw are None without the relative-attention bias, and so are
    their gradients."""

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
        sig = y = None
        if m.activation == "silu":
            sig = torch.sigmoid(z)
            y = z * sig
        else:
            y = z
        d_o_in = rnd(dy32) @ o_kernel.float().T                       # (B, n, o_width)
        keep = None
        if m.rate > 0.0:
            keep = hash_keep_mask(b, n, m.o_width, ctx.seed, m.rate, x.device)
            d_o_in = d_o_in * keep
        d_y, dbias, attn = attn_backward(y.to(mm), d_o_in.to(mm), attn, colmask, rel_pos, ext,
                                         tsw, m, ctx.seed)
        u, gln = y[..., :hdv], ln(attn, m.eps)
        o_in = torch.cat([u, gln, u * gln], dim=-1) if m.concat_ua else u * gln
        if keep is not None:
            o_in = o_in * keep
        dwo = rnd(o_in).reshape(-1, m.o_width).T @ rnd(dy32).reshape(-1, d)
        dbo = dy32.sum(dim=(0, 1))
        d_z = rnd(d_y * (sig * (1.0 + z * (1.0 - sig))) if sig is not None else d_y)
        dw = rnd(n0).reshape(-1, d).T @ d_z.reshape(-1, d_z.shape[-1])
        dx = (ln_backward(x32, d_z @ uvqk.float().T, m.eps) + dy32).to(x.dtype)
        d_rel_pos = d_tsw = None
        if dbias is not None:
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
