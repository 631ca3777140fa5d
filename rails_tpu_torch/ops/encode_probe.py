"""The encode cost probe (P1): CUDA kernel wrapper + plain version.

Replaces the Pallas kernel of `rails_tpu/cli/encode_probe.py` (`make_block`
:122-161, body `_variant_kernel` :42-119): one HSTU block forward with the
in-kernel time bias, SiLU, pointwise attention (the mask a multiply) and the
concat_ua output projection, o_kernel (3*h*dv, D), in one of `MODES`, each
dropping one cost term so that its device time, subtracted from `full`'s,
prices the term:

    full     everything
    noact    no SiLU on the (n, F) projection
    linattn  linear attention gate, a = qk (+ bias), mask kept
    nottb    bias = rel_pos only (no time buckets)
    noattn   attn := round(v / n) to the matmul dtype, no attention
    ident    out = (LN(x) @ uvqk)[:, :D] + x: LayerNorm and the whole
             projection GEMM, its other columns dropped

Kernel: `csrc/encode_probe.cu`, K1's kernels with the probe's switches: at
the widths of `hstu_block.tc_route` (bf16) the tensor-core kernels of
`csrc/hstu_block_tc.cuh` (`rails_encode_probe_tc`), otherwise the CUDA-core
kernels of `csrc/hstu_block.cuh`; what bounds them is in those headers.
`encode_probe_block` follows the port's dispatch rule (CPU tensors run
`encode_probe_block_reference`, CUDA tensors launch the kernel or raise) and
counts its kernel launches in `.launches`.
"""

from __future__ import annotations

import torch

from rails_tpu_torch.core.device import use_kernel
from rails_tpu_torch.ops import _build
from rails_tpu_torch.ops.hstu_block import (
    MAX_SMEM_BYTES,
    check_tc_smem,
    ln,
    tc_route,
    time_bucket,
    vqk_layout,
)

MODES = ("full", "noact", "linattn", "nottb", "noattn", "ident")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def encode_probe_block_reference(
    mode: str,
    x: torch.Tensor,          # (B, n, D) f32 or bf16
    colmask: torch.Tensor,    # (B, n) f32 {0, 1}
    uvqk: torch.Tensor,       # (D, 2h*dv + 2h*dqk), x's dtype
    o_kernel: torch.Tensor,   # (3*h*dv, D), x's dtype
    o_bias: torch.Tensor,     # (D,) f32
    rel_pos: torch.Tensor,    # (n, n) f32
    ext: torch.Tensor,        # (B, n+1) int32 extended timestamps
    tsw: torch.Tensor,        # (128,) f32 time-bucket table
    *,
    num_heads: int,
    dqk: int,
    dv: int,
    inv_n: float,
    eps: float = 1e-6,
    num_buckets: int = 128,
) -> torch.Tensor:
    """Plain PyTorch version of the probe's block in `mode`, with
    `_variant_kernel`'s rounding points."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; expected one of {MODES}")
    b, n, d = x.shape
    h = num_heads
    mm = uvqk.dtype

    def rnd(t: torch.Tensor) -> torch.Tensor:
        return t.to(mm).float()

    y = rnd(ln(x.float(), eps)) @ uvqk.float()
    if mode == "ident":
        return (y[..., :d] + x.float()).to(x.dtype)
    if mode != "noact":
        y = y * torch.sigmoid(y)
    u = y[..., : h * dv]
    v = rnd(y[..., h * dv : 2 * h * dv] * inv_n)
    if mode == "noattn":
        attn = v
    else:
        q = rnd(y[..., 2 * h * dv : 2 * h * dv + h * dqk]).reshape(b, n, h, dqk)
        k = rnd(y[..., 2 * h * dv + h * dqk :]).reshape(b, n, h, dqk)
        add = rel_pos[None]
        if mode != "nottb":
            delta = ext[:, 1:, None] - ext[:, None, :n]
            add = add + tsw[time_bucket(delta, num_buckets).long()]
        causal = torch.tril(torch.ones(n, n, dtype=torch.float32, device=x.device))
        mask = causal[None] * colmask[:, None, :]
        qk = torch.einsum("bnhd,bmhd->bhnm", q, k) + add[:, None]
        a = qk if mode == "linattn" else qk * torch.sigmoid(qk)
        a = rnd(a * mask[:, None])
        attn = torch.einsum("bhnm,bmhd->bnhd", a, v.reshape(b, n, h, dv)).reshape(b, n, h * dv)
    a_ln = ln(attn, eps)
    o_in = torch.cat([u, a_ln, u * a_ln], dim=-1)
    out = rnd(o_in) @ o_kernel.float() + o_bias.float() + x.float()
    return out.to(x.dtype)


def encode_probe_block(
    mode: str,
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
    """The probe's block in `mode`; same arguments as
    `encode_probe_block_reference`."""
    tensors = (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw)
    kw = dict(num_heads=num_heads, dqk=dqk, dv=dv, inv_n=inv_n, eps=eps,
              num_buckets=num_buckets)
    if not use_kernel(*tensors):
        return encode_probe_block_reference(mode, *tensors, **kw)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; expected one of {MODES}")
    b, n, d = x.shape
    h = num_heads
    f = 2 * h * dv + 2 * h * dqk
    expect = {
        "x": (x, x.dtype, (b, n, d)),
        "colmask": (colmask, torch.float32, (b, n)),
        "uvqk": (uvqk, x.dtype, (d, f)),
        "o_kernel": (o_kernel, x.dtype, (3 * h * dv, d)),
        "o_bias": (o_bias, torch.float32, (d,)),
        "rel_pos": (rel_pos, torch.float32, (n, n)),
        "ext": (ext, torch.int32, (b, n + 1)),
        "tsw": (tsw, torch.float32, (128,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"encode_probe_block: {name} must be a contiguous {dtype} {shape}; got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"encode_probe_block: unsupported dtype {x.dtype}")
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if tc_route(x.dtype, d, h, dqk, dv):
        check_tc_smem(lib, n, h, dqk, dv, False, "encode_probe_block")
        with torch.cuda.device(x.device):
            u = torch.empty(b * n, h * dv, dtype=torch.float32, device=x.device)
            vqk = torch.empty(b * n, vqk_layout(h, dqk, dv)[2], dtype=torch.bfloat16,
                              device=x.device)
            oin = torch.empty(b * n, 3 * h * dv, dtype=torch.bfloat16, device=x.device)
            out = torch.empty_like(x)
            err = lib.rails_encode_probe_tc(
                MODES.index(mode), x.data_ptr(), colmask.data_ptr(), uvqk.data_ptr(),
                o_kernel.data_ptr(), o_bias.data_ptr(), rel_pos.data_ptr(), ext.data_ptr(),
                tsw.data_ptr(), u.data_ptr(), vqk.data_ptr(), oin.data_ptr(), out.data_ptr(), b,
                n, d, h, dqk, dv, inv_n, eps, min(num_buckets, 127), stream)
        _build.check(lib, err, "encode_probe_block")
        encode_probe_block.launches += 1
        return out
    if lib.rails_hstu_attn_smem_bytes(n, dqk, dv) > MAX_SMEM_BYTES:
        raise ValueError(f"encode_probe_block: n={n} does not fit the attention's shared memory")
    with torch.cuda.device(x.device):
        y = torch.empty(b * n, f, dtype=torch.float32, device=x.device)
        attn = torch.empty(b * n, h * dv, dtype=torch.float32, device=x.device)
        out = torch.empty_like(x)
        err = lib.rails_encode_probe(
            _DTYPE_CODE[x.dtype], MODES.index(mode), x.data_ptr(), colmask.data_ptr(),
            uvqk.data_ptr(), o_kernel.data_ptr(), o_bias.data_ptr(), rel_pos.data_ptr(),
            ext.data_ptr(), tsw.data_ptr(), y.data_ptr(), attn.data_ptr(), out.data_ptr(),
            b, n, d, h, dqk, dv, inv_n, eps, min(num_buckets, 127), stream,
        )
    _build.check(lib, err, "encode_probe_block")
    encode_probe_block.launches += 1
    return out


encode_probe_block.launches = 0
