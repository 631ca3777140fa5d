"""One HSTU block forward for serving (K1): CUDA kernel wrapper + plain version.

Replaces the Pallas kernel `fused_hstu_block`
(`rails_tpu/ops/pallas/hstu_block.py:298-455`, body `_kernel` :96-276) with
every variant it takes: LayerNorm -> x @ uvqk -> SiLU (or none,
`activation`) -> attention -> o_input -> @ Wo + bo + x. The attention is the
pointwise SiLU one (`rel_bias`, `hstu_rel_bias`: per head, causal x
column-valid mask, 1/max_seq_len folded into v) or, with
`normalization="softmax_rel_bias"`, one softmax map over the full h*dqk
contraction shared by every value head (the bias added before the
1/sqrt(dqk) scale, the mask after normalisation, v unscaled). Its bias is
built in-kernel from the layer's rel-pos slab and time-bucket table
(`rel_pos`, `ext`, `tsw`: int32 timestamps), read from a precomputed
(B, n, n) `bias` in x's dtype (`mask_in_bias` when it carries the -30000
penalty), or absent. o_input is u * LayerNorm(attn), or [u, LN(attn),
u * LN(attn)] when the output projection has 3*h*dv rows (`concat_ua`, read
from its shape as in JAX).

Kernels: three launches per call (LN + projection GEMM, the attention,
the output GEMM), f32 accumulation. bf16 operands at the widths of
`tc_route` with the SiLU projection (`tc_block`) run the tensor-core kernels
of `csrc/hstu_block_tc.cuh` (mma.sync bf16): the projection stores u in f32
and v, q, k as the bf16 values the JAX kernel rounds them to (`project`), the
attention builds the bias once for all heads and writes o_input in bf16
(`attention_oinput`), and `out_gemm` adds bo and x. f32 operands at the
same widths with n <= 512 and the SiLU projection (`tf32_block`) run the
3xTF32 kernels of `csrc/hstu_serve_tf32.cuh` (mma.sync, every product as lo.hi
+ hi.lo + hi.hi of split f32 operands): `tf32_project` writes y = [u | v | q |
k] in f32, `tf32_attention` attn in f32 (pointwise, or the softmax map), and
`tf32_out_gemm` builds o_input from attn and u and adds bo and x. Every other
instance (bf16 or f32 outside those rules, linear_activation="none") runs the
CUDA-core kernels of `csrc/hstu_block.cuh`. What bounds each and how is in
the headers.

Each stage has a plain version (`project_reference`,
`attention_oinput_reference`, `out_gemm_reference`; `tf32_*_reference`);
composed they give `fused_hstu_block_reference` bit for bit. Every wrapper
follows the port's dispatch rule (`core.device.use_kernel`): CPU tensors run
the plain version, CUDA tensors launch the kernel or raise.
`fused_hstu_block.launches` counts block calls on the card, and each stage
wrapper's `.launches` its own launches (the block's included);
`tf32_attention.softmax_launches` counts the softmax kernel's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rails_tpu_torch.core.device import use_kernel
from rails_tpu_torch.ops import _build

# f32(1/0.301): `_time_bucket` multiplies by the f32 rounding of 1/0.301.
_INV_LOG_BASE = torch.tensor(1.0 / 0.301, dtype=torch.float32)
# Shared memory one Hopper block may use.
MAX_SMEM_BYTES = 232_448
# The widest D of the tensor-core routes (`kMaxD`, csrc/hstu_block_tc.cuh): the
# rated preprocessor's 256 + 8 fits a block's LayerNorm'd x rows.
TC_MAX_D = 272
# The longest sequence of K1's f32 route on the tensor cores (`kTf32MaxN`,
# csrc/hstu_block_tc.cuh), the combined preprocessor's 2 x 211 within it: the
# pointwise attention holds a block's bias rows of every key, 171 KB at 512.
# The softmax one holds its (64, n) scores and takes n only where they fit
# (`tf32_softmax_smem_bytes`).
TF32_MAX_N = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def time_bucket(delta: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """trunc(log(max(|delta|, 1)) * (1/0.301)) clipped to
    [0, min(num_buckets, 127)] (`hstu_block.py:81-93`); int32 in and out."""
    fdelta = torch.clamp(delta.abs(), min=1).float()
    b = (torch.log(fdelta) * _INV_LOG_BASE.to(delta.device)).to(torch.int32)
    return torch.clamp(b, 0, min(num_buckets, 127))


_ACTIVATIONS = ("silu", "none")
_NORMALIZATIONS = ("rel_bias", "hstu_rel_bias", "softmax_rel_bias")
# Bias modes of the kernel (`enum Bias`, csrc/hstu_block.cuh).
_BIAS_INTERNAL, _BIAS_TENSOR, _BIAS_NONE = 0, 1, 2
# Heads a warp of the tensor-core attention holds at most, and the static
# shared memory of its LayerNorm reduction (csrc/hstu_block_tc.cuh).
_TC_HEADS_PER_WARP = 4
_TC_STATIC_SMEM = 2 * 64 * 2 * 4


def tc_route(dtype: torch.dtype, d: int, num_heads: int, dqk: int, dv: int) -> bool:
    """The width rule of K1's tensor-core kernels (`widths_ok` in
    csrc/hstu_block_tc.cuh): bf16 operands, D <= TC_MAX_D = 272 (a block's
    LayerNorm'd x rows fit the projection's A tile; the rated preprocessor's
    264 among them), dqk <= 32 and dv <= 32 (heads padded
    to 16 or 32 and to 8, 16 or 32 columns), and at most 4 heads a head warp
    (h <= 3, or an even h <= 8). f32, and bf16 at any other width, run the
    CUDA-core kernels of csrc/hstu_block.cuh."""
    return dtype == torch.bfloat16 and tc_widths(d, num_heads, dqk, dv)


def tc_widths(d: int, num_heads: int, dqk: int, dv: int) -> bool:
    """`tc_route`'s widths whatever the dtype: D <= 272, dqk and dv <= 32, h
    <= 3 or an even h <= 8 (K4's f32 route takes them too)."""
    warps = 2 if num_heads % 2 == 0 else 1
    return (1 <= d <= TC_MAX_D and 1 <= dqk <= 32 and 1 <= dv <= 32
            and num_heads >= 1 and num_heads // warps <= _TC_HEADS_PER_WARP)


def tc_block(dtype: torch.dtype, d: int, num_heads: int, dqk: int, dv: int,
             activation: str) -> bool:
    """Whether `fused_hstu_block` runs the tensor-core kernels: the widths of
    `tc_route` and the SiLU projection. linear_activation="none" stays on the
    CUDA-core kernels. Its unsquashed projection carries any change in the
    order of the GEMMs' f32 sums through 16 blocks into the served ranking: on
    one ml-20m-hstu-mol batch of 512 the tensor-core block agrees with the
    plain path on 0.945 of the top-120 ids, and a plain path whose GEMMs run
    in f64 on 0.951, below E2E_TOL's 0.96, while the CUDA-core kernels'
    sequential f32 sums agree on 0.973 (`profile_k1_agreement.py`, PERF.md
    §6). The SiLU variants agree on 0.968-0.985 through the tensor cores. The
    rated (D = 264) and combined (n = 422) preprocessors' SiLU blocks take
    the tensor cores in bf16 and f32 (`tf32_block`); activation none stays
    here for them too."""
    return activation == "silu" and tc_route(dtype, d, num_heads, dqk, dv)


def tf32_softmax_smem_bytes(n: int, num_heads: int, dqk: int, dv: int) -> int:
    """Dynamic shared memory of K1's f32 softmax attention at length n
    (`SoftLayout` in csrc/hstu_serve_tf32.cuh): the (64, n) f32 scores, the
    64 q rows, two 32-key ring stages, and the tables (sized for
    TF32_MAX_N). 201 KB at n = 256 and 225 KB at n = 352 for h*dqk = h*dv =
    256; past that it does not fit."""
    def up(x: int, m: int) -> int:
        return -(-x // m) * m

    ldq, ldv = up(num_heads * dqk, 8) + 4, up(num_heads * dv, 8) + 4
    floats = 64 * (up(n, 32) + 8) + 64 * ldq + 2 * 32 * max(ldq, ldv) + TF32_MAX_N + 128
    return 4 * floats + 4 * (TF32_MAX_N + 1 + TF32_MAX_N // 32 + 1)


def tf32_block(dtype: torch.dtype, d: int, n: int, num_heads: int, dqk: int, dv: int,
               activation: str, softmax: bool = False) -> bool:
    """Whether `fused_hstu_block` runs K1's f32 serving route on the tensor
    cores, every product as 3xTF32 (csrc/hstu_serve_tf32.cuh: `tf32_project`,
    `tf32_attention`, `tf32_out_gemm`): f32 operands at `tc_widths` (D <=
    272, dqk and dv <= 32, h <= 3 or an even h <= 8) with 1 <= n <=
    TF32_MAX_N = 512 and the SiLU projection; any bias (in-kernel,
    precomputed raw or with mask_in_bias, none), concat_ua, pointwise or
    softmax attention, the softmax one where its scores fit a block
    (`tf32_softmax_smem_bytes`: n <= 352 at ML-20M's widths). The rated (D =
    264) and combined (n = 422) preprocessors' blocks take it.
    linear_activation="none" stays on the CUDA-core kernels, as `tc_block`
    says for bf16: its unsquashed projection carries the GEMMs' order of f32
    sums into the served ranking. Wider heads, longer sequences and the
    softmax attention past its fit stay there too."""
    return (dtype == torch.float32 and activation == "silu" and 1 <= n <= TF32_MAX_N
            and tc_widths(d, num_heads, dqk, dv)
            and (not softmax or tf32_softmax_smem_bytes(n, num_heads, dqk, dv) <= MAX_SMEM_BYTES))


def require_tf32(dtype: torch.dtype, d: int, n: int, num_heads: int, dqk: int, dv: int,
                 what: str) -> None:
    """Raise ValueError unless `tf32_block`'s widths take these operands: the
    f32 route's stage kernels have no other instance."""
    if not tf32_block(dtype, d, n, num_heads, dqk, dv, "silu"):
        raise ValueError(f"{what}: no 3xTF32 instance for {dtype}, D={d}, n={n}, h={num_heads}, "
                         f"dqk={dqk}, dv={dv} (tf32_block: f32, D <= {TC_MAX_D}, dqk and dv "
                         f"<= 32, h <= 3 or an even h <= 8, n <= {TF32_MAX_N})")


def require_tc(dtype: torch.dtype, d: int, num_heads: int, dqk: int, dv: int, what: str) -> None:
    """Raise ValueError unless `tc_route` takes these widths: the stage
    kernels have no other instance."""
    if not tc_route(dtype, d, num_heads, dqk, dv):
        raise ValueError(f"{what}: no tensor-core instance for {dtype}, D={d}, h={num_heads}, "
                         f"dqk={dqk}, dv={dv} (tc_route: bf16, D <= {TC_MAX_D}, dqk and dv "
                         f"<= 32, h <= 3 or an even h <= 8)")


def vqk_layout(num_heads: int, dqk: int, dv: int) -> Tuple[int, int, int]:
    """(dqk_p, dv_p, width) of the projection's bf16 [v | q | k] rows: each
    head padded with zeros to dqk_p (a multiple of 16) and dv_p (8, or a
    multiple of 16) columns, as `col_map` in csrc/hstu_block_tc.cuh lays
    them out."""
    dqk_p = -(-dqk // 16) * 16
    dv_p = 8 if dv <= 8 else -(-dv // 16) * 16
    return dqk_p, dv_p, num_heads * (dv_p + 2 * dqk_p)


def pack_vqk(v: torch.Tensor, q: torch.Tensor, k: torch.Tensor, *, num_heads: int, dqk: int,
             dv: int) -> torch.Tensor:
    """v (..., h*dv), q and k (..., h*dqk) in the padded layout of
    `vqk_layout`."""
    dqk_p, dv_p, _ = vqk_layout(num_heads, dqk, dv)
    lead = v.shape[:-1]

    def pad(t, w, w_p):
        return F.pad(t.reshape(*lead, num_heads, w), (0, w_p - w)).reshape(*lead, num_heads * w_p)

    return torch.cat([pad(v, dv, dv_p), pad(q, dqk, dqk_p), pad(k, dqk, dqk_p)], dim=-1)


def split_vqk(vqk: torch.Tensor, *, num_heads: int, dqk: int,
              dv: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(v, q, k) without the padding of `pack_vqk`."""
    dqk_p, dv_p, _ = vqk_layout(num_heads, dqk, dv)
    lead = vqk.shape[:-1]
    hv, hq = num_heads * dv_p, num_heads * dqk_p

    def unpad(t, w, w_p):
        return t.reshape(*lead, num_heads, w_p)[..., :w].reshape(*lead, num_heads * w)

    return (unpad(vqk[..., :hv], dv, dv_p), unpad(vqk[..., hv:hv + hq], dqk, dqk_p),
            unpad(vqk[..., hv + hq:], dqk, dqk_p))


def check_tc_smem(lib, n: int, num_heads: int, dqk: int, dv: int, softmax: bool,
                  what: str) -> None:
    """Raise unless the tensor-core attention block fits a block's shared
    memory at length n: its dynamic bytes (`attn_smem_bytes` in
    csrc/hstu_block_tc.cuh: q, a key and a value tile and the bias tile, or
    the (64, n) f32 scores under softmax, and the epilogue's LN(attn) tile)
    plus its static LayerNorm reduction."""
    smem = (lib.rails_hstu_tc_attn_smem_bytes(n, num_heads, dqk, dv, int(softmax))
            + _TC_STATIC_SMEM)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{what}: n={n} needs {smem} B of shared memory in the tensor-core "
                         f"attention; a block has {MAX_SMEM_BYTES}")


def _check_bias_flags(rel_pos, bias, mask_in_bias: bool, softmax: bool) -> None:
    if rel_pos is not None and bias is not None:
        raise ValueError("the in-kernel bias (rel_pos, ext, tsw) and `bias` are exclusive")
    if mask_in_bias and bias is None:
        raise ValueError("mask_in_bias requires a bias")
    if softmax and mask_in_bias:
        raise ValueError("softmax applies the mask after normalization: pass the raw bias "
                         "with mask_in_bias=False")


def _variant(num_heads: int, dv: int, o_kernel: torch.Tensor, rel_pos, bias,
             mask_in_bias: bool, activation: str, softmax: bool) -> bool:
    """Check a variant's arguments as `fused_hstu_block` asserts them; returns
    concat_ua, which the output projection's row count says."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"activation {activation!r}; expected one of {_ACTIVATIONS}")
    _check_bias_flags(rel_pos, bias, mask_in_bias, softmax)
    rows = o_kernel.shape[0]
    if rows not in (num_heads * dv, 3 * num_heads * dv):
        raise ValueError(f"o_kernel has {rows} rows; expected h*dv={num_heads * dv} or "
                         f"3*h*dv (concat_ua)")
    return rows == 3 * num_heads * dv


def ln(y: torch.Tensor, eps: float) -> torch.Tensor:
    """Parameter-free LayerNorm over the last axis, population variance."""
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, unbiased=False)
    return (y - mu) * torch.rsqrt(var + eps)


def fused_hstu_block_reference(
    x: torch.Tensor,          # (B, n, D) f32 or bf16
    colmask: torch.Tensor,    # (B, n) f32 {0, 1} column validity
    uvqk: torch.Tensor,       # (D, 2h*dv + 2h*dqk), x's dtype
    o_kernel: torch.Tensor,   # (h*dv, D) or, with concat_ua, (3*h*dv, D); x's dtype
    o_bias: torch.Tensor,     # (D,) f32
    rel_pos: Optional[torch.Tensor] = None,  # (n, n) f32 layer rel-pos bias
    ext: Optional[torch.Tensor] = None,      # (B, n+1) int32 extended timestamps
    tsw: Optional[torch.Tensor] = None,      # (128,) f32 layer time-bucket table
    *,
    num_heads: int,
    dqk: int,
    dv: int,
    inv_n: float,
    eps: float = 1e-6,
    num_buckets: int = 128,
    bias: Optional[torch.Tensor] = None,     # (B, n, n) x's dtype, precomputed
    mask_in_bias: bool = False,
    activation: str = "silu",
    normalization: str = "rel_bias",
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the Pallas body's math and
    rounding points, batched over users and heads."""
    return block_forward_reference(
        x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, num_heads=num_heads,
        dqk=dqk, dv=dv, inv_n=inv_n, eps=eps, num_buckets=num_buckets, bias=bias,
        mask_in_bias=mask_in_bias, activation=activation,
        softmax=_softmax(normalization),
    )[0]


def _softmax(normalization: str) -> bool:
    if normalization not in _NORMALIZATIONS:
        raise ValueError(f"normalization {normalization!r}; expected one of {_NORMALIZATIONS}")
    return normalization == "softmax_rel_bias"


def block_forward_reference(
    x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, *, num_heads: int, dqk: int,
    dv: int, inv_n: float, eps: float, num_buckets: int, keep: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None, mask_in_bias: bool = False, activation: str = "silu",
    softmax: bool = False, attn_keep: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, attn (B, n, h*dv) f32) of one block; `keep` (B, n, width of
    o_input), the train block's o_input dropout mask, multiplies o_input, and
    `attn_keep` (B, h, n, n; B, 1, n, n under softmax), its attention
    dropout mask, multiplies the attention weights after the mask, before
    they round to the matmul dtype. The in-kernel bias is used when `rel_pos`
    is given; with `mask_in_bias` the penalty in `bias` stands in for the
    mask."""
    concat_ua = _variant(num_heads, dv, o_kernel, rel_pos, bias, mask_in_bias, activation,
                         softmax)
    h = num_heads
    mm = uvqk.dtype

    def rnd(t: torch.Tensor) -> torch.Tensor:   # the kernel's casts to the matmul dtype
        return t.to(mm).float()

    y = rnd(ln(x.float(), eps)) @ uvqk.float()
    if activation == "silu":
        y = y * torch.sigmoid(y)
    u = y[..., : h * dv]
    v = y[..., h * dv : 2 * h * dv]
    v = rnd(v if softmax else v * inv_n)
    q = rnd(y[..., 2 * h * dv : 2 * h * dv + h * dqk])
    k = rnd(y[..., 2 * h * dv + h * dqk :])
    attn = _attention(q, k, v, colmask, rel_pos, ext, tsw, num_heads=h, dqk=dqk, dv=dv,
                      num_buckets=num_buckets, bias=bias, mask_in_bias=mask_in_bias,
                      softmax=softmax, mm=mm, attn_keep=attn_keep)
    a_ln = ln(attn, eps)
    o_in = torch.cat([u, a_ln, u * a_ln], dim=-1) if concat_ua else u * a_ln
    if keep is not None:
        o_in = o_in * keep
    out = rnd(o_in) @ o_kernel.float() + o_bias.float() + x.float()
    return out.to(x.dtype), attn


def _attention(q, k, v, colmask, rel_pos, ext, tsw, *, num_heads: int, dqk: int, dv: int,
               num_buckets: int, bias: Optional[torch.Tensor], mask_in_bias: bool,
               softmax: bool, mm: torch.dtype,
               attn_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """attn (B, n, h*dv) f32 from f32 q, k, v (the matmul dtype's values; v
    already scaled by 1/max_seq_len unless softmax): the bias, the mask and
    the attention of `block_forward_reference`, a rounded to `mm` before a @
    v."""
    b, n, _ = q.shape
    h = num_heads
    if rel_pos is not None:
        delta = ext[:, 1:, None] - ext[:, None, :n]                   # (B, n, n)
        add = rel_pos[None] + tsw[time_bucket(delta, num_buckets).long()]
    else:
        add = None if bias is None else bias.float()
    mask = None
    if not mask_in_bias:
        causal = torch.tril(torch.ones(n, n, dtype=torch.float32, device=q.device))
        mask = causal[None] * colmask[:, None, :]                      # (B, n, n)
    if softmax:
        qk = q @ k.transpose(1, 2)                                      # (B, n, n)
        if add is not None:
            qk = qk + add
        p = qk * (1.0 / float(dqk) ** 0.5)
        e = torch.exp(p - p.amax(dim=-1, keepdim=True))
        a = e / e.sum(dim=-1, keepdim=True)
        if mask is not None:
            a = a * mask
        if attn_keep is not None:
            a = a * attn_keep[:, 0]
        return a.to(mm).float() @ v                                    # (B, n, h*dv)
    qk = torch.einsum("bnhd,bmhd->bhnm", q.reshape(b, n, h, dqk), k.reshape(b, n, h, dqk))
    if add is not None:
        qk = qk + add[:, None]
    a = qk * torch.sigmoid(qk)
    if mask is not None:
        a = a * mask[:, None]
    if attn_keep is not None:
        a = a * attn_keep
    attn = torch.einsum("bhnm,bmhd->bnhd", a.to(mm).float(), v.reshape(b, n, h, dv))
    return attn.reshape(b, n, h * dv)


def project_reference(
    x: torch.Tensor, uvqk: torch.Tensor, *, num_heads: int, dqk: int, dv: int, inv_n: float,
    eps: float = 1e-6, activation: str = "silu", softmax: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the projection stage: (u, v, q, k) with u (B, n,
    h*dv) f32 and v, q, k in the matmul dtype, the values the JAX kernel
    rounds them to before any use (`hstu_block.py:167-176`): v scaled by
    1/max_seq_len before its rounding unless `softmax`."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"activation {activation!r}; expected one of {_ACTIVATIONS}")
    h, mm = num_heads, uvqk.dtype
    y = ln(x.float(), eps).to(mm).float() @ uvqk.float()
    if activation == "silu":
        y = y * torch.sigmoid(y)
    v = y[..., h * dv : 2 * h * dv]
    return (y[..., : h * dv], (v if softmax else v * inv_n).to(mm),
            y[..., 2 * h * dv : 2 * h * dv + h * dqk].to(mm), y[..., 2 * h * dv + h * dqk :].to(mm))


def attention_oinput_reference(
    u: torch.Tensor,          # (B, n, h*dv) f32
    v: torch.Tensor,          # (B, n, h*dv), matmul dtype (1/max_seq_len folded in unless softmax)
    q: torch.Tensor,          # (B, n, h*dqk), matmul dtype
    k: torch.Tensor,          # (B, n, h*dqk), matmul dtype
    colmask: torch.Tensor,
    rel_pos: Optional[torch.Tensor] = None,
    ext: Optional[torch.Tensor] = None,
    tsw: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    dqk: int,
    dv: int,
    eps: float = 1e-6,
    num_buckets: int = 128,
    bias: Optional[torch.Tensor] = None,
    mask_in_bias: bool = False,
    softmax: bool = False,
    concat_ua: bool = False,
) -> torch.Tensor:
    """Plain version of the attention stage: o_input (B, n, h*dv, or 3*h*dv
    with concat_ua) in the matmul dtype, from the projection's outputs; the
    bias, mask and attention as in `block_forward_reference`."""
    attn = _attention(q.float(), k.float(), v.float(), colmask, rel_pos, ext, tsw,
                      num_heads=num_heads, dqk=dqk, dv=dv, num_buckets=num_buckets, bias=bias,
                      mask_in_bias=mask_in_bias, softmax=softmax, mm=q.dtype)
    a_ln = ln(attn, eps)
    return (torch.cat([u, a_ln, u * a_ln], dim=-1) if concat_ua else u * a_ln).to(q.dtype)


def out_gemm_reference(o_input: torch.Tensor, o_kernel: torch.Tensor, o_bias: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain version of the output stage: o_input @ Wo + bo + x in x's dtype."""
    return (o_input.float() @ o_kernel.float() + o_bias.float() + x.float()).to(x.dtype)


def _check(what: str, expect: dict) -> None:
    """Raise unless every named tensor is contiguous with its dtype and shape."""
    for name, (t, dtype, shape) in expect.items():
        if t is None or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            got = "None" if t is None else (f"{t.dtype} {tuple(t.shape)} "
                                            f"contiguous={t.is_contiguous()}")
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} {shape}; got {got}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def project(x: torch.Tensor, uvqk: torch.Tensor, *, num_heads: int, dqk: int, dv: int,
            inv_n: float, eps: float = 1e-6, activation: str = "silu",
            softmax: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The projection stage: (u (B, n, h*dv) f32, vqk (B, n, width)), v, q
    and k in the padded layout of `vqk_layout`. CUDA: `tc_proj_kernel`
    (bf16 at the widths of `tc_route`, else raises)."""
    if not use_kernel(x, uvqk):
        u, v, q, k = project_reference(x, uvqk, num_heads=num_heads, dqk=dqk, dv=dv, inv_n=inv_n,
                                       eps=eps, activation=activation, softmax=softmax)
        return u, pack_vqk(v, q, k, num_heads=num_heads, dqk=dqk, dv=dv)
    b, n, d = x.shape
    h = num_heads
    require_tc(x.dtype, d, h, dqk, dv, "project")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"activation {activation!r}; expected one of {_ACTIVATIONS}")
    _check("project", {"x": (x, x.dtype, (b, n, d)),
                       "uvqk": (uvqk, x.dtype, (d, 2 * h * dv + 2 * h * dqk))})
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        u = torch.empty(b, n, h * dv, dtype=torch.float32, device=x.device)
        vqk = torch.empty(b, n, vqk_layout(h, dqk, dv)[2], dtype=torch.bfloat16, device=x.device)
        err = lib.rails_hstu_tc_project(
            x.data_ptr(), uvqk.data_ptr(), u.data_ptr(), vqk.data_ptr(), b * n, d, h, dqk, dv,
            eps, 1.0 if softmax else inv_n, int(activation == "none"),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "project")
    project.launches += 1
    return u, vqk


def attention_oinput(
    u: torch.Tensor,
    vqk: torch.Tensor,
    colmask: torch.Tensor,
    rel_pos: Optional[torch.Tensor] = None,
    ext: Optional[torch.Tensor] = None,
    tsw: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    dqk: int,
    dv: int,
    eps: float = 1e-6,
    num_buckets: int = 128,
    bias: Optional[torch.Tensor] = None,
    mask_in_bias: bool = False,
    softmax: bool = False,
    concat_ua: bool = False,
) -> torch.Tensor:
    """The attention stage over `project`'s (u, vqk): o_input (B, n, h*dv,
    or 3*h*dv with concat_ua). CUDA: `tc_attn_kernel` or `tc_softmax_kernel`
    (bf16 at the widths of `tc_route`, else raises)."""
    tensors = tuple(t for t in (u, vqk, colmask, rel_pos, ext, tsw, bias) if t is not None)
    kw = dict(num_heads=num_heads, dqk=dqk, dv=dv, eps=eps, num_buckets=num_buckets, bias=bias,
              mask_in_bias=mask_in_bias, softmax=softmax, concat_ua=concat_ua)
    if not use_kernel(*tensors):
        v, q, k = split_vqk(vqk, num_heads=num_heads, dqk=dqk, dv=dv)
        return attention_oinput_reference(u, v, q, k, colmask, rel_pos, ext, tsw, **kw)
    b, n, _ = u.shape
    h = num_heads
    require_tc(vqk.dtype, 1, h, dqk, dv, "attention_oinput")
    _check_bias_flags(rel_pos, bias, mask_in_bias, softmax)
    expect = {"u": (u, torch.float32, (b, n, h * dv)),
              "vqk": (vqk, torch.bfloat16, (b, n, vqk_layout(h, dqk, dv)[2])),
              "colmask": (colmask, torch.float32, (b, n))}
    expect.update(_bias_expect(rel_pos, ext, tsw, bias, b, n, torch.bfloat16))
    _check("attention_oinput", expect)
    lib = _build.load_library()
    check_tc_smem(lib, n, h, dqk, dv, softmax, "attention_oinput")
    with torch.cuda.device(u.device):
        oin = torch.empty(b, n, (3 if concat_ua else 1) * h * dv, dtype=torch.bfloat16,
                          device=u.device)
        err = lib.rails_hstu_tc_attention(
            vqk.data_ptr(), u.data_ptr(), colmask.data_ptr(), _ptr(rel_pos), _ptr(ext),
            _ptr(tsw), _ptr(bias), oin.data_ptr(), b, n, h, dqk, dv, 1.0 / float(dqk) ** 0.5,
            eps, min(num_buckets, 127), _bias_mode(rel_pos, bias), int(softmax), int(concat_ua),
            torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(lib, err, "attention_oinput")
    attention_oinput.launches += 1
    return oin


def out_gemm(o_input: torch.Tensor, o_kernel: torch.Tensor, o_bias: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """The output stage: o_input @ Wo + bo + x in x's dtype. CUDA:
    `tc_out_kernel` (bf16 only, else raises)."""
    if not use_kernel(o_input, o_kernel, o_bias, x):
        return out_gemm_reference(o_input, o_kernel, o_bias, x)
    b, n, d = x.shape
    rows = o_input.shape[-1]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"out_gemm: no tensor-core instance for {x.dtype}")
    _check("out_gemm", {"o_input": (o_input, x.dtype, (b, n, rows)),
                        "o_kernel": (o_kernel, x.dtype, (rows, d)),
                        "o_bias": (o_bias, torch.float32, (d,)), "x": (x, x.dtype, (b, n, d))})
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        err = lib.rails_hstu_tc_out(o_input.data_ptr(), o_kernel.data_ptr(), o_bias.data_ptr(),
                                    x.data_ptr(), out.data_ptr(), b * n, rows, d,
                                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "out_gemm")
    out_gemm.launches += 1
    return out


# ---- K1's f32 route on the tensor cores (3xTF32, csrc/hstu_serve_tf32.cuh):
# three stages over y = [u | v | q | k] (B, n, F) f32 and attn (B, n, h*dv)
# f32; composed, their plain versions give `fused_hstu_block_reference` bit
# for bit.


def tf32_project_reference(x: torch.Tensor, uvqk: torch.Tensor, *, eps: float = 1e-6
                           ) -> torch.Tensor:
    """Plain version of the f32 route's projection: y = SiLU(LN(x) @ uvqk),
    (B, n, F) f32, v not yet scaled."""
    y = ln(x.float(), eps) @ uvqk.float()
    return y * torch.sigmoid(y)


def tf32_attention_reference(
    y: torch.Tensor, colmask: torch.Tensor, rel_pos: Optional[torch.Tensor] = None,
    ext: Optional[torch.Tensor] = None, tsw: Optional[torch.Tensor] = None, *, num_heads: int,
    dqk: int, dv: int, inv_n: float, num_buckets: int = 128, bias: Optional[torch.Tensor] = None,
    mask_in_bias: bool = False, softmax: bool = False,
) -> torch.Tensor:
    """Plain version of the f32 route's attention: attn (B, n, h*dv) f32 from
    y, v times 1/max_seq_len unless softmax."""
    hdv, hq = num_heads * dv, num_heads * dqk
    v = y[..., hdv:2 * hdv]
    return _attention(y[..., 2 * hdv:2 * hdv + hq], y[..., 2 * hdv + hq:],
                      v if softmax else v * inv_n, colmask, rel_pos, ext, tsw,
                      num_heads=num_heads, dqk=dqk, dv=dv, num_buckets=num_buckets, bias=bias,
                      mask_in_bias=mask_in_bias, softmax=softmax, mm=torch.float32)


def tf32_out_gemm_reference(x: torch.Tensor, y: torch.Tensor, attn: torch.Tensor,
                            o_kernel: torch.Tensor, o_bias: torch.Tensor, *, num_heads: int,
                            dv: int, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of the f32 route's output GEMM: o_input @ Wo + bo + x,
    o_input = u * LN(attn) or, when Wo has 3*h*dv rows, [u, LN(attn), u *
    LN(attn)]; u the first h*dv columns of y."""
    u, a_ln = y[..., :num_heads * dv], ln(attn, eps)
    o_in = (torch.cat([u, a_ln, u * a_ln], dim=-1) if o_kernel.shape[0] == 3 * num_heads * dv
            else u * a_ln)
    return (o_in @ o_kernel.float() + o_bias.float() + x.float()).to(x.dtype)


# Shared-memory kinds of `rails_hstu_serve_tf32_smem_bytes`.
_TF32_POINT, _TF32_SOFTMAX, _TF32_PROJ, _TF32_OUT = 0, 1, 2, 3


def _tf32_lib(what: str, kind: int, n: int, num_heads: int, dqk: int, dv: int):
    """The library, after the shared-memory check of one f32-route launch."""
    lib = _build.load_library()
    smem = lib.rails_hstu_serve_tf32_smem_bytes(kind, n, num_heads, dqk, dv)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{what}: n={n} needs {smem} B of shared memory")
    return lib


def tf32_project(x: torch.Tensor, uvqk: torch.Tensor, *, num_heads: int, dqk: int, dv: int,
                 eps: float = 1e-6) -> torch.Tensor:
    """The f32 route's projection; same result as `tf32_project_reference`.
    CUDA: `serve_proj_kernel` (f32 at the widths of `tf32_block`, else
    raises)."""
    if not use_kernel(x, uvqk):
        return tf32_project_reference(x, uvqk, eps=eps)
    b, n, d = x.shape
    h, f32 = num_heads, torch.float32
    require_tf32(x.dtype, d, n, h, dqk, dv, "tf32_project")
    f = 2 * h * dv + 2 * h * dqk
    _check("tf32_project", {"x": (x, f32, (b, n, d)), "uvqk": (uvqk, f32, (d, f))})
    lib = _tf32_lib("tf32_project", _TF32_PROJ, n, h, dqk, dv)
    with torch.cuda.device(x.device):
        y = torch.empty(b, n, f, dtype=f32, device=x.device)
        err = lib.rails_hstu_serve_tf32_project(
            x.data_ptr(), uvqk.data_ptr(), y.data_ptr(), b, n, d, h, dqk, dv, eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "tf32_project")
    tf32_project.launches += 1
    return y


def tf32_attention(
    y: torch.Tensor, colmask: torch.Tensor, rel_pos: Optional[torch.Tensor] = None,
    ext: Optional[torch.Tensor] = None, tsw: Optional[torch.Tensor] = None, *, num_heads: int,
    dqk: int, dv: int, inv_n: float, num_buckets: int = 128, bias: Optional[torch.Tensor] = None,
    mask_in_bias: bool = False, softmax: bool = False,
) -> torch.Tensor:
    """The f32 route's attention; same result as `tf32_attention_reference`.
    CUDA: `serve_attn_kernel` or, with softmax, `serve_softmax_kernel` (f32 at
    the widths of `tf32_block`, else raises); `.softmax_launches` counts the
    latter's."""
    kw = dict(num_heads=num_heads, dqk=dqk, dv=dv, num_buckets=num_buckets, bias=bias,
              mask_in_bias=mask_in_bias, softmax=softmax)
    tensors = tuple(t for t in (y, colmask, rel_pos, ext, tsw, bias) if t is not None)
    if not use_kernel(*tensors):
        return tf32_attention_reference(y, colmask, rel_pos, ext, tsw, inv_n=inv_n, **kw)
    b, n, _ = y.shape
    h, f32 = num_heads, torch.float32
    require_tf32(y.dtype, 1, n, h, dqk, dv, "tf32_attention")
    _check_bias_flags(rel_pos, bias, mask_in_bias, softmax)
    expect = {"y": (y, f32, (b, n, 2 * h * dv + 2 * h * dqk)),
              "colmask": (colmask, f32, (b, n))}
    expect.update(_bias_expect(rel_pos, ext, tsw, bias, b, n, f32))
    _check("tf32_attention", expect)
    lib = _tf32_lib("tf32_attention", _TF32_SOFTMAX if softmax else _TF32_POINT, n, h, dqk, dv)
    with torch.cuda.device(y.device):
        attn = torch.empty(b, n, h * dv, dtype=f32, device=y.device)
        err = lib.rails_hstu_serve_tf32_attention(
            y.data_ptr(), colmask.data_ptr(), _ptr(rel_pos), _ptr(ext), _ptr(tsw), _ptr(bias),
            attn.data_ptr(), b, n, h, dqk, dv, inv_n, 1.0 / float(dqk) ** 0.5,
            min(num_buckets, 127), _bias_mode(rel_pos, bias), int(softmax),
            torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, err, "tf32_attention")
    tf32_attention.launches += 1
    tf32_attention.softmax_launches += int(softmax)
    return attn


def tf32_out_gemm(x: torch.Tensor, y: torch.Tensor, attn: torch.Tensor, o_kernel: torch.Tensor,
                  o_bias: torch.Tensor, *, num_heads: int, dqk: int, dv: int,
                  eps: float = 1e-6) -> torch.Tensor:
    """The f32 route's output GEMM; same result as `tf32_out_gemm_reference`
    (concat_ua when Wo has 3*h*dv rows). CUDA: `serve_out_kernel` (f32 at the
    widths of `tf32_block`, else raises)."""
    if not use_kernel(x, y, attn, o_kernel, o_bias):
        return tf32_out_gemm_reference(x, y, attn, o_kernel, o_bias, num_heads=num_heads, dv=dv,
                                       eps=eps)
    b, n, d = x.shape
    h, f32 = num_heads, torch.float32
    require_tf32(x.dtype, d, n, h, dqk, dv, "tf32_out_gemm")
    rows = o_kernel.shape[0]
    if rows not in (h * dv, 3 * h * dv):
        raise ValueError(f"tf32_out_gemm: o_kernel has {rows} rows; expected h*dv={h * dv} or "
                         f"3*h*dv (concat_ua)")
    _check("tf32_out_gemm", {"x": (x, f32, (b, n, d)),
                             "y": (y, f32, (b, n, 2 * h * dv + 2 * h * dqk)),
                             "attn": (attn, f32, (b, n, h * dv)),
                             "o_kernel": (o_kernel, f32, (rows, d)), "o_bias": (o_bias, f32, (d,))})
    lib = _tf32_lib("tf32_out_gemm", _TF32_OUT, n, h, dqk, dv)
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        err = lib.rails_hstu_serve_tf32_out(
            attn.data_ptr(), y.data_ptr(), o_kernel.data_ptr(), o_bias.data_ptr(), x.data_ptr(),
            out.data_ptr(), b, n, d, h, dqk, dv, eps, int(rows == 3 * h * dv),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "tf32_out_gemm")
    tf32_out_gemm.launches += 1
    return out


def _bias_mode(rel_pos, bias) -> int:
    if rel_pos is not None:
        return _BIAS_INTERNAL
    return _BIAS_TENSOR if bias is not None else _BIAS_NONE


def _bias_expect(rel_pos, ext, tsw, bias, b: int, n: int, dtype: torch.dtype) -> dict:
    """The bias operands a kernel reads: the in-kernel tables, or the
    precomputed (B, n, n) bias in the compute dtype, or none."""
    if rel_pos is not None:
        return dict(rel_pos=(rel_pos, torch.float32, (n, n)), ext=(ext, torch.int32, (b, n + 1)),
                    tsw=(tsw, torch.float32, (128,)))
    if bias is not None:
        return dict(bias=(bias, dtype, (b, n, n)))
    return {}


def fused_hstu_block(
    x: torch.Tensor,
    colmask: torch.Tensor,
    uvqk: torch.Tensor,
    o_kernel: torch.Tensor,
    o_bias: torch.Tensor,
    rel_pos: Optional[torch.Tensor] = None,
    ext: Optional[torch.Tensor] = None,
    tsw: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    dqk: int,
    dv: int,
    inv_n: float,
    eps: float = 1e-6,
    num_buckets: int = 128,
    bias: Optional[torch.Tensor] = None,
    mask_in_bias: bool = False,
    activation: str = "silu",
    normalization: str = "rel_bias",
) -> torch.Tensor:
    """One HSTU block forward, eval (`HSTUBlock.__call__` semantics); same
    arguments as `fused_hstu_block_reference`."""
    tensors = tuple(t for t in (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, bias)
                    if t is not None)
    kw = dict(num_heads=num_heads, dqk=dqk, dv=dv, inv_n=inv_n, eps=eps,
              num_buckets=num_buckets, bias=bias, mask_in_bias=mask_in_bias,
              activation=activation, normalization=normalization)
    if not use_kernel(*tensors):
        return fused_hstu_block_reference(x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw,
                                          **kw)
    softmax = _softmax(normalization)
    concat_ua = _variant(num_heads, dv, o_kernel, rel_pos, bias, mask_in_bias, activation,
                         softmax)
    b, n, d = x.shape
    h = num_heads
    f = 2 * h * dv + 2 * h * dqk
    rows = (3 if concat_ua else 1) * h * dv
    expect = {
        "x": (x, x.dtype, (b, n, d)),
        "colmask": (colmask, torch.float32, (b, n)),
        "uvqk": (uvqk, x.dtype, (d, f)),
        "o_kernel": (o_kernel, x.dtype, (rows, d)),
        "o_bias": (o_bias, torch.float32, (d,)),
    }
    expect.update(_bias_expect(rel_pos, ext, tsw, bias, b, n, x.dtype))
    _check("fused_hstu_block", expect)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_hstu_block: unsupported dtype {x.dtype}")
    if tf32_block(x.dtype, d, n, h, dqk, dv, activation, softmax):
        y = tf32_project(x, uvqk, num_heads=h, dqk=dqk, dv=dv, eps=eps)
        attn = tf32_attention(y, colmask, rel_pos, ext, tsw, num_heads=h, dqk=dqk, dv=dv,
                              inv_n=inv_n, num_buckets=num_buckets, bias=bias,
                              mask_in_bias=mask_in_bias, softmax=softmax)
        out = tf32_out_gemm(x, y, attn, o_kernel, o_bias, num_heads=h, dqk=dqk, dv=dv, eps=eps)
        fused_hstu_block.launches += 1
        return out
    if tc_block(x.dtype, d, h, dqk, dv, activation):
        u, vqk = project(x, uvqk, num_heads=h, dqk=dqk, dv=dv, inv_n=inv_n, eps=eps,
                         activation=activation, softmax=softmax)
        o_input = attention_oinput(u, vqk, colmask, rel_pos, ext, tsw, num_heads=h, dqk=dqk,
                                   dv=dv, eps=eps, num_buckets=num_buckets, bias=bias,
                                   mask_in_bias=mask_in_bias, softmax=softmax,
                                   concat_ua=concat_ua)
        out = out_gemm(o_input, o_kernel, o_bias, x)
        fused_hstu_block.launches += 1
        return out
    lib = _build.load_library()
    smem = (lib.rails_hstu_softmax_smem_bytes(n, h, dqk, dv) if softmax
            else lib.rails_hstu_attn_smem_bytes(n, dqk, dv))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"fused_hstu_block: n={n} needs {smem} B of shared memory")
    with torch.cuda.device(x.device):
        y = torch.empty(b * n, f, dtype=torch.float32, device=x.device)
        attn = torch.empty(b * n, h * dv, dtype=torch.float32, device=x.device)
        out = torch.empty_like(x)
        err = lib.rails_hstu_block_fwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), colmask.data_ptr(), uvqk.data_ptr(),
            o_kernel.data_ptr(), o_bias.data_ptr(), _ptr(rel_pos), _ptr(ext), _ptr(tsw),
            _ptr(bias), y.data_ptr(), attn.data_ptr(), out.data_ptr(), b, n, d, h, dqk, dv, inv_n,
            1.0 / float(dqk) ** 0.5, eps, min(num_buckets, 127), int(activation == "none"),
            int(concat_ua), _bias_mode(rel_pos, bias), int(softmax),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "fused_hstu_block")
    fused_hstu_block.launches += 1
    return out


fused_hstu_block.launches = 0
project.launches = 0
attention_oinput.launches = 0
out_gemm.launches = 0
tf32_project.launches = 0
tf32_attention.launches = 0
tf32_attention.softmax_launches = 0
tf32_out_gemm.launches = 0
