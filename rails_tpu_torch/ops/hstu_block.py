"""One HSTU block forward for serving (K1): CUDA kernel wrapper + plain version.

Replaces the Pallas kernel `fused_hstu_block`
(`rails_tpu/ops/pallas/hstu_block.py:298-455`, body `_kernel` :96-276) in
its internal-bias mode with SiLU activation and `rel_bias` normalisation:
LayerNorm -> x @ uvqk -> SiLU -> per-head pointwise-SiLU attention with the
rel-pos + time-bucket bias built in-kernel, causal x column-valid mask and
1/max_seq_len folded into v -> u * LayerNorm(attn) -> @ Wo + bo + x.

Kernel: `csrc/hstu_block.cu`, three launches per call (LN+projection GEMM,
per-(head, user) attention, LN+output GEMM), f32 accumulation for f32 or
bf16 operands. What bounds it on an H100 and what the design does about
shared memory is in the source's header. The other variants of the TPU kernel
(precomputed bias, `mask_in_bias`, no bias, no activation,
`softmax_rel_bias`, `concat_ua`) are not ported: `models.hstu.HSTUStack`
refuses their configurations, and a `concat_ua`-shaped output projection
raises NotImplementedError here.

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


def _check_variant(num_heads: int, dv: int, o_kernel: torch.Tensor) -> None:
    # The activation and normalisation variants are refused by `HSTUStack`;
    # concat_ua shows in the output projection's shape.
    if o_kernel.shape[0] != num_heads * dv:
        raise NotImplementedError(
            "concat_ua output projections are not ported (ROADMAP.md, Queue 1: K1 variants)"
        )


def ln(y: torch.Tensor, eps: float) -> torch.Tensor:
    """Parameter-free LayerNorm over the last axis, population variance."""
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, unbiased=False)
    return (y - mu) * torch.rsqrt(var + eps)


def fused_hstu_block_reference(
    x: torch.Tensor,          # (B, n, D) f32 or bf16
    colmask: torch.Tensor,    # (B, n) f32 {0, 1} column validity
    uvqk: torch.Tensor,       # (D, 2h*dv + 2h*dqk), x's dtype
    o_kernel: torch.Tensor,   # (h*dv, D), x's dtype
    o_bias: torch.Tensor,     # (D,) f32
    rel_pos: torch.Tensor,    # (n, n) f32 layer rel-pos bias
    ext: torch.Tensor,        # (B, n+1) int32 extended timestamps
    tsw: torch.Tensor,        # (128,) f32 layer time-bucket table
    *,
    num_heads: int,
    dqk: int,
    dv: int,
    inv_n: float,
    eps: float = 1e-6,
    num_buckets: int = 128,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the Pallas body's math and
    rounding points, batched over users and heads."""
    return block_forward_reference(
        x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, num_heads=num_heads,
        dqk=dqk, dv=dv, inv_n=inv_n, eps=eps, num_buckets=num_buckets,
    )[0]


def block_forward_reference(
    x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, *, num_heads: int, dqk: int,
    dv: int, inv_n: float, eps: float, num_buckets: int, keep: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, attn (B, n, h*dv) f32) of one block; `keep` (B, n, h*dv), the
    train block's o_input dropout mask, multiplies u * LN(attn)."""
    _check_variant(num_heads, dv, o_kernel)
    b, n, _ = x.shape
    h = num_heads
    mm = uvqk.dtype

    def rnd(t: torch.Tensor) -> torch.Tensor:   # the kernel's casts to the matmul dtype
        return t.to(mm).float()

    y = rnd(ln(x.float(), eps)) @ uvqk.float()
    y = y * torch.sigmoid(y)
    u = y[..., : h * dv]
    v = rnd(y[..., h * dv : 2 * h * dv] * inv_n).reshape(b, n, h, dv)
    q = rnd(y[..., 2 * h * dv : 2 * h * dv + h * dqk]).reshape(b, n, h, dqk)
    k = rnd(y[..., 2 * h * dv + h * dqk :]).reshape(b, n, h, dqk)
    delta = ext[:, 1:, None] - ext[:, None, :n]                       # (B, n, n)
    bias = rel_pos[None] + tsw[time_bucket(delta, num_buckets).long()]
    causal = torch.tril(torch.ones(n, n, dtype=torch.float32, device=x.device))
    mask = causal[None] * colmask[:, None, :]                          # (B, n, n)
    qk = torch.einsum("bnhd,bmhd->bhnm", q, k) + bias[:, None]
    a = rnd(qk * torch.sigmoid(qk) * mask[:, None])
    attn = torch.einsum("bhnm,bmhd->bnhd", a, v).reshape(b, n, h * dv)
    o_in = u * ln(attn, eps)
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
    rel_pos: torch.Tensor,
    ext: torch.Tensor,
    tsw: torch.Tensor,
    *,
    num_heads: int,
    dqk: int,
    dv: int,
    inv_n: float,
    eps: float = 1e-6,
    num_buckets: int = 128,
) -> torch.Tensor:
    """One HSTU block forward, eval (`HSTUBlock.__call__` semantics); same
    arguments as `fused_hstu_block_reference`."""
    tensors = (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw)
    kw = dict(num_heads=num_heads, dqk=dqk, dv=dv, inv_n=inv_n, eps=eps,
              num_buckets=num_buckets)
    if not use_kernel(*tensors):
        return fused_hstu_block_reference(*tensors, **kw)
    _check_variant(num_heads, dv, o_kernel)
    b, n, d = x.shape
    h = num_heads
    f = 2 * h * dv + 2 * h * dqk
    expect = {
        "x": (x, x.dtype, (b, n, d)),
        "colmask": (colmask, torch.float32, (b, n)),
        "uvqk": (uvqk, x.dtype, (d, f)),
        "o_kernel": (o_kernel, x.dtype, (h * dv, d)),
        "o_bias": (o_bias, torch.float32, (d,)),
        "rel_pos": (rel_pos, torch.float32, (n, n)),
        "ext": (ext, torch.int32, (b, n + 1)),
        "tsw": (tsw, torch.float32, (128,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"fused_hstu_block: {name} must be a contiguous {dtype} {shape}; got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_hstu_block: unsupported dtype {x.dtype}")
    lib = _build.load_library()
    smem = lib.rails_hstu_attn_smem_bytes(n, dqk, dv)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"fused_hstu_block: n={n} needs {smem} B of shared memory")
    with torch.cuda.device(x.device):
        y = torch.empty(b * n, f, dtype=torch.float32, device=x.device)
        attn = torch.empty(b * n, h * dv, dtype=torch.float32, device=x.device)
        out = torch.empty_like(x)
        err = lib.rails_hstu_block_fwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), colmask.data_ptr(), uvqk.data_ptr(),
            o_kernel.data_ptr(), o_bias.data_ptr(), rel_pos.data_ptr(), ext.data_ptr(),
            tsw.data_ptr(), y.data_ptr(), attn.data_ptr(), out.data_ptr(),
            b, n, d, h, dqk, dv, inv_n, eps, min(num_buckets, 127),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "fused_hstu_block")
    fused_hstu_block.launches += 1
    return out


fused_hstu_block.launches = 0
