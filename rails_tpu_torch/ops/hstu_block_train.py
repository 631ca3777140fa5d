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
  because that attn differs from the forward's (v rounds twice).
- `attn_backward`: the attention-core backward, a row kernel (LN backward of
  attn) then, pointwise, a per-user kernel over the heads (d_q, d_k, d_v and
  the dense d(bias); `csrc/hstu_block_train.cu`) or, softmax, a kernel per
  (user, 32 query rows) and one per (user, 32 key columns)
  (`csrc/hstu_softmax_train.cu`); the bf16 instances first recompute attn.
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
well, and `.variant_launches[variant_name(...)]` those of each variant other
than the default (SiLU, rel_bias, the bias, no attention dropout, head dims
<= 32).
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
    ln,
    time_bucket,
)

# The causal / column-validity penalty folded into the pointwise kernels' bias.
PENALTY = 30000.0
# Head dims the backward kernel holds in registers at a time; wider heads
# run its WIDE instances in chunks of this many.
HEAD_DIM_CHUNK = 32
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
    keep = attn_keep = None
    if meta.rate > 0.0:
        keep = hash_keep_mask_reference(b, n, meta.o_width, seed, meta.rate, x.device)
    if meta.attn_rate > 0.0:
        attn_keep = attn_keep_mask_reference(b, n, 1 if meta.softmax else meta.num_heads, seed,
                                             meta.attn_rate, x.device)
    return block_forward_reference(
        x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, num_heads=meta.num_heads,
        dqk=meta.dqk, dv=meta.dv, inv_n=meta.inv_n, eps=meta.eps,
        num_buckets=meta.num_buckets, keep=keep, activation=meta.activation,
        softmax=meta.softmax, attn_keep=attn_keep,
    )


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


def _count(fn, dtype: torch.dtype, meta: BlockMeta, has_bias: bool) -> None:
    fn.launches += 1
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


def fused_train_block_forward(
    x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, seed: int, meta: BlockMeta,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train block's forward; same arguments as
    `fused_train_block_forward_reference`."""
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
