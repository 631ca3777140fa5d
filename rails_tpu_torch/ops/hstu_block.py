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

Kernel: `csrc/hstu_block.cu`, three launches per call (LN+projection GEMM,
the attention, LN+output GEMM), f32 accumulation for f32 or bf16 operands.
What bounds it on an H100 and how the softmax attention streams k and v
through shared memory is in `csrc/hstu_block.cuh`.

`fused_hstu_block` follows the port's dispatch rule (`core.device.use_kernel`):
CPU tensors run `fused_hstu_block_reference`, CUDA tensors launch the kernel
or raise. `fused_hstu_block.launches` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rails_tpu_torch.core.device import use_kernel
from rails_tpu_torch.ops import _build

# f32(1/0.301): `_time_bucket` multiplies by the f32 rounding of 1/0.301.
_INV_LOG_BASE = torch.tensor(1.0 / 0.301, dtype=torch.float32)
# Shared memory one Hopper block may use.
MAX_SMEM_BYTES = 232_448
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


def _variant(num_heads: int, dv: int, o_kernel: torch.Tensor, rel_pos, bias,
             mask_in_bias: bool, activation: str, softmax: bool) -> bool:
    """Check a variant's arguments as `fused_hstu_block` asserts them; returns
    concat_ua, which the output projection's row count says."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"activation {activation!r}; expected one of {_ACTIVATIONS}")
    if rel_pos is not None and bias is not None:
        raise ValueError("the in-kernel bias (rel_pos, ext, tsw) and `bias` are exclusive")
    if mask_in_bias and bias is None:
        raise ValueError("mask_in_bias requires a bias")
    if softmax and mask_in_bias:
        raise ValueError("softmax applies the mask after normalization: pass the raw bias "
                         "with mask_in_bias=False")
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
    b, n, _ = x.shape
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
    if rel_pos is not None:
        delta = ext[:, 1:, None] - ext[:, None, :n]                   # (B, n, n)
        add = rel_pos[None] + tsw[time_bucket(delta, num_buckets).long()]
    else:
        add = None if bias is None else bias.float()
    mask = None
    if not mask_in_bias:
        causal = torch.tril(torch.ones(n, n, dtype=torch.float32, device=x.device))
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
        attn = rnd(a) @ v                                              # (B, n, h*dv)
    else:
        qk = torch.einsum("bnhd,bmhd->bhnm", q.reshape(b, n, h, dqk), k.reshape(b, n, h, dqk))
        if add is not None:
            qk = qk + add[:, None]
        a = qk * torch.sigmoid(qk)
        if mask is not None:
            a = a * mask[:, None]
        if attn_keep is not None:
            a = a * attn_keep
        attn = torch.einsum("bhnm,bmhd->bnhd", rnd(a), v.reshape(b, n, h, dv))
        attn = attn.reshape(b, n, h * dv)
    a_ln = ln(attn, eps)
    o_in = torch.cat([u, a_ln, u * a_ln], dim=-1) if concat_ua else u * a_ln
    if keep is not None:
        o_in = o_in * keep
    out = rnd(o_in) @ o_kernel.float() + o_bias.float() + x.float()
    return out.to(x.dtype), attn


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
    internal = rel_pos is not None
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
    expect = {
        "x": (x, x.dtype, (b, n, d)),
        "colmask": (colmask, torch.float32, (b, n)),
        "uvqk": (uvqk, x.dtype, (d, f)),
        "o_kernel": (o_kernel, x.dtype, ((3 if concat_ua else 1) * h * dv, d)),
        "o_bias": (o_bias, torch.float32, (d,)),
    }
    if internal:
        expect.update(rel_pos=(rel_pos, torch.float32, (n, n)),
                      ext=(ext, torch.int32, (b, n + 1)), tsw=(tsw, torch.float32, (128,)))
    elif bias is not None:
        expect.update(bias=(bias, x.dtype, (b, n, n)))
    for name, (t, dtype, shape) in expect.items():
        if t is None or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            got = "None" if t is None else (f"{t.dtype} {tuple(t.shape)} "
                                            f"contiguous={t.is_contiguous()}")
            raise ValueError(f"fused_hstu_block: {name} must be a contiguous {dtype} {shape}; "
                             f"got {got}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_hstu_block: unsupported dtype {x.dtype}")
    lib = _build.load_library()
    smem = (lib.rails_hstu_softmax_smem_bytes(n, h, dqk, dv) if softmax
            else lib.rails_hstu_attn_smem_bytes(n, dqk, dv))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"fused_hstu_block: n={n} needs {smem} B of shared memory")
    mode = _BIAS_INTERNAL if internal else _BIAS_TENSOR if bias is not None else _BIAS_NONE

    def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        y = torch.empty(b * n, f, dtype=torch.float32, device=x.device)
        attn = torch.empty(b * n, h * dv, dtype=torch.float32, device=x.device)
        out = torch.empty_like(x)
        err = lib.rails_hstu_block_fwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), colmask.data_ptr(), uvqk.data_ptr(),
            o_kernel.data_ptr(), o_bias.data_ptr(), ptr(rel_pos), ptr(ext), ptr(tsw), ptr(bias),
            y.data_ptr(), attn.data_ptr(), out.data_ptr(), b, n, d, h, dqk, dv, inv_n,
            1.0 / float(dqk) ** 0.5, eps, min(num_buckets, 127), int(activation == "none"),
            int(concat_ua), mode, int(softmax), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "fused_hstu_block")
    fused_hstu_block.launches += 1
    return out


fused_hstu_block.launches = 0
