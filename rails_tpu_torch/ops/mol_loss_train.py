"""Fused MoL training loss over shared negatives (K5): CUDA kernels + plain versions.

Replaces `make_fused_mol_loss` (`rails_tpu/ops/pallas/mol_loss_train.py`): the
forward `pallas_call` (:317 via `_core_call`, body `_fwd_kernel` :143 and
`_forward_core` :75-140), the backward (`_bwd_kernel` :159-290) and the
layout glue of its `fused` function (:440-462), for f32 and bf16 operands:

    t      = <q_comp[m, n], item_comp[r, mx]> / T         (M, R, L), l = n*P_X + mx
    t_in   = t * qi_mask                                   (qi-MLP input only)
    gi     = qp[m] * ip[r] + W2' silu(W1' t_in + b1) + b2
    p      = softmax_l(silu(gi)) ;  q_w = p * pi_mask ;  s = max(sum_l q_w, eps)
    out    = sum_l q_w * t / s                             (s = 1 exactly at pi rate 0)

The masks are the JAX kernel's counter-hash streams (`hash_dropout.
hash_keep_global_reference`, salts `QI_SALT` and `PI_SALT`): the flat index
uses the kernel's m-major row l' = mx*P_Q + n (`lprime`) and its padded extents
(M to a multiple of min(8, M), R to a multiple of 128; `padded_extents`), so
the bits equal the JAX package's although the port keeps the model's n-major
logit order and pads nothing. The arguments are in the JAX function's layout:
q_comp (M, P_Q, d_P), qp (M, L), item_comp (R, P_X, d_P), ip (R, L), w1 (L, H),
b1 (1, H), w2 (H, L), b2 (1, L), all n-major.

bf16 operands (q_comp, qp, item_comp, ip; `amzn-books-hstu-mol-fast`) run the
qi MLP in bf16 as JAX does (`mlp_dtype`, :362-364, :388-390): t and its
products sum in f32; t_in, W1, W2 and h round to bf16 before their products
(:107-115); the backward rounds d_qi = d_gi, d_z and d_t / T to bf16 before
their products (:212, :228, :255-257) and keeps d_gi for d_qp, d_ip and db2
and d_z for db1 in f32; the gradients come back in each operand's dtype
(:428-434): bf16 for the four operands, f32 for the f32 weights. Both plain
versions write these rounding points out (the backward as JAX's `_bwd_kernel`
does, not by autograd, which would round at the casts' transposes instead).

Kernels, two routes chosen by `tc_route` from the geometry and the operand
dtype alone (no flag, no fallback; each set of C entry points refuses the
other's geometries):
  - the tensor-core route (`csrc/mol_loss_tc.cuh`, entry points in
    `csrc/mol_loss_tc.cu`): P_Q = 8 with P_X = 4 (f32 or bf16) or 8 (bf16),
    d_P <= 128, H a multiple of 16 up to 128 -- ML-1M's 8x4x64 and ML-20M's
    8x4x128 in f32, Amazon Books' 8x8x32 in bf16. Every product of the loss
    is a GEMM over tiles of 8 queries x 16 negatives on mma.sync: bf16
    m16n8k16 at JAX's rounding points for bf16 operands, 3xTF32 (hi/lo
    splits, three m16n8k8 TF32 products added in f32) for f32 ones; SiLU,
    sigmoid and exp in the fast forms `__expf`/`__fdividef`. Its header says
    what bounds it and how the backward's cross-block sums stay free of
    atomics. Launches also count on `.tc_launches`.
  - the CUDA-core route (`csrc/mol_loss_train.cu`): every other geometry in
    `SUPPORTED_GROUPS` (synthetic-small's 4x2, H not a multiple of 16, f32 at
    8x8), every product a scalar FMA loop.
Both replace the TPU kernel's carried VMEM sums with per-block slots and a
fixed-order reduction, so two calls give the same bits.
`fused_mol_loss_forward` and `fused_mol_loss_backward` follow the port's
dispatch rule (`core.device.use_kernel`): CPU tensors run `*_reference`,
CUDA tensors launch the route's kernel or raise. Each has `.launches`;
launches of the bf16 instances also count on `.bf16_launches`.
`fused_mol_loss` is the differentiable function (`FusedMolLoss`), whose
backward is the backward kernel. Kernel instances: (P_Q, P_X) in
`SUPPORTED_GROUPS`, d_P <= 128, f32 and bf16 operands.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rails_tpu_torch.core.device import use_kernel
from rails_tpu_torch.ops import _build
from rails_tpu_torch.ops.hash_dropout import (
    PI_SALT,
    QI_SALT,
    hash_keep_global_reference,
    stream_offset,
    keep_threshold,
    wrap_i32,
)
from rails_tpu_torch.ops.hstu_block import MAX_SMEM_BYTES

SUPPORTED_GROUPS = ((8, 4), (4, 2), (8, 8))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_DOT_PRODUCT_DIM = 128
_BLOCK_Q = 8          # the JAX kernel's query block (`make_fused_mol_loss(block_q=8)`)
_LANE = 128           # its R padding


def lprime(p_q: int, p_x: int) -> torch.Tensor:
    """(L,) the JAX kernel's m-major row l' = mx*P_Q + n of each n-major logit
    l = n*P_X + mx (`m_major_perm`, inverted)."""
    l = torch.arange(p_q * p_x)
    return (l % p_x) * p_q + l // p_x


def m_major_order(p_q: int, p_x: int) -> torch.Tensor:
    """(L,) the n-major logit at each m-major row l' (`m_major_perm`)."""
    return torch.argsort(lprime(p_q, p_x))


def padded_extents(m: int, r: int) -> Tuple[int, int]:
    """The JAX kernel's padded (M, R): M to a multiple of min(8, M), R to a
    multiple of 128 (`mol_loss_train.py:444-446`)."""
    g = min(_BLOCK_Q, m)
    return m + (-m) % g, r + (-r) % _LANE


def loss_mask(seed: int, salt: int, m: int, r: int, p_q: int, p_x: int, rate: float,
              device) -> torch.Tensor:
    """(M, R, L) n-major scaled keep mask of one K5 stream."""
    mp, rp = padded_extents(m, r)
    g = hash_keep_global_reference(seed, salt, p_q * p_x, mp, rp, rate, device)
    return g[lprime(p_q, p_x).to(g.device), :m, :r].permute(1, 2, 0)


def _rows_mask(seed: int, salt: int, m: int, r: int, p_q: int, p_x: int, rate: float,
               device, rows: Optional[Tuple[int, int]]) -> torch.Tensor:
    """`loss_mask` of the M rows, or with `rows` = (offset, total) rows
    [offset, offset + M) of the stream over `total` rows: a data-parallel
    rank's share of the global batch's."""
    if rows is None:
        return loss_mask(seed, salt, m, r, p_q, p_x, rate, device)
    off, total = rows
    return loss_mask(seed, salt, total, r, p_q, p_x, rate, device)[off : off + m]


def _mlp_dtype(item_comp: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if item_comp.dtype == torch.bfloat16 else torch.float32


def _forward_parts(q_comp, qp, item_comp, ip, w1, b1, w2, b2, seed: int, *, p_q: int,
                   p_x: int, temperature: float, qi_rate: float, pi_rate: float,
                   eps: float, rows: Optional[Tuple[int, int]] = None) -> dict:
    """The forward's intermediates (`_forward_core`), with its rounding points."""
    mlp = _mlp_dtype(item_comp)

    def rnd(x):
        return x.to(mlp).float()

    m, r = q_comp.shape[0], item_comp.shape[0]
    l = p_q * p_x
    dev = q_comp.device
    t = (torch.einsum("mnd,rxd->mrnx", q_comp.float(), item_comp.float()).reshape(m, r, l)
         * (1.0 / temperature))
    qi_mask = (_rows_mask(seed, QI_SALT, m, r, p_q, p_x, qi_rate, dev, rows)
               if qi_rate > 0.0 else None)
    t_in = rnd(t if qi_mask is None else t * qi_mask)
    # The qi MLP's input sums in the JAX kernel's m-major row order: through
    # the sharp softmax, f32 rounding of another order shows at 2e-4.
    perm = m_major_order(p_q, p_x).to(dev)
    w1r, w2r = rnd(w1.float()), rnd(w2.float())
    z = t_in[..., perm] @ w1r[perm] + b1.float()
    h = rnd(F.silu(z))
    gi = qp.float()[:, None, :] * ip.float()[None, :, :] + (h @ w2r + b2.float())
    p = torch.softmax(F.silu(gi), dim=-1)
    pi_mask = (_rows_mask(seed, PI_SALT, m, r, p_q, p_x, pi_rate, dev, rows)
               if pi_rate > 0.0 else None)
    q_w = p if pi_mask is None else p * pi_mask
    s = (torch.ones(m, r, device=dev) if pi_mask is None
         else torch.clamp(q_w.sum(dim=-1), min=eps))
    return dict(rnd=rnd, t=t, qi_mask=qi_mask, t_in=t_in, w1r=w1r, w2r=w2r, z=z, h=h, gi=gi, p=p,
                pi_mask=pi_mask, q_w=q_w, s=s)


def fused_mol_loss_forward_reference(
    q_comp, qp, item_comp, ip, w1, b1, w2, b2, seed: int, *, p_q: int, p_x: int,
    temperature: float, qi_rate: float, pi_rate: float, eps: float,
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the forward: (M, R) f32 scores."""
    f = _forward_parts(q_comp, qp, item_comp, ip, w1, b1, w2, b2, seed, p_q=p_q, p_x=p_x,
                       temperature=temperature, qi_rate=qi_rate, pi_rate=pi_rate, eps=eps,
                       rows=rows)
    return (f["q_w"] * f["t"]).sum(dim=-1) / f["s"]


def fused_mol_loss_backward_reference(
    q_comp, qp, item_comp, ip, w1, b1, w2, b2, seed: int, d_out, *, p_q: int, p_x: int,
    temperature: float, qi_rate: float, pi_rate: float, eps: float,
    rows: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward: the gradients of sum(out * d_out) with
    respect to the 8 array inputs, in their dtypes, as `_bwd_kernel`
    (:182-274) computes them."""
    f = _forward_parts(q_comp, qp, item_comp, ip, w1, b1, w2, b2, seed, p_q=p_q, p_x=p_x,
                       temperature=temperature, qi_rate=qi_rate, pi_rate=pi_rate, eps=eps,
                       rows=rows)
    rnd, t, p, gi, z = f["rnd"], f["t"], f["p"], f["gi"], f["z"]
    m, r, l = t.shape
    d_out = d_out.float()
    inv_s = 1.0 / f["s"]
    a = (d_out * inv_s)[..., None]
    d_t = a * f["q_w"]                                    # the direct term
    d_p = a * t
    if f["pi_mask"] is not None:
        out_v = (f["q_w"] * t).sum(dim=-1) * inv_s
        live = (f["s"] > eps).float()
        d_p = (d_p - (d_out * out_v * inv_s * live)[..., None]) * f["pi_mask"]
    d_gw = p * (d_p - (d_p * p).sum(dim=-1, keepdim=True))
    sig = torch.sigmoid(gi)
    d_gi = d_gw * (sig * (1.0 + gi * (1.0 - sig)))
    dqp = torch.einsum("mrl,rl->ml", d_gi, ip.float())
    dip = torch.einsum("mrl,ml->rl", d_gi, qp.float())
    d_qi = rnd(d_gi)
    sig_z = torch.sigmoid(z)
    d_z = (d_qi @ f["w2r"].T) * (sig_z * (1.0 + z * (1.0 - sig_z)))
    d_zr = rnd(d_z)
    dw1 = torch.einsum("mrl,mrh->lh", f["t_in"], d_zr)
    dw2 = torch.einsum("mrh,mrl->hl", f["h"], d_qi)
    d_t_mlp = d_zr @ f["w1r"].T
    if f["qi_mask"] is not None:
        d_t_mlp = d_t_mlp * f["qi_mask"]
    d_tm = rnd((d_t + d_t_mlp) * (1.0 / temperature)).reshape(m, r, p_q, p_x)
    dq = torch.einsum("mrnx,rxd->mnd", d_tm, item_comp.float())
    ditem = torch.einsum("mrnx,mnd->rxd", d_tm, q_comp.float())
    grads = (dq, dqp, ditem, dip, dw1, d_z.sum(dim=(0, 1))[None], dw2, d_gi.sum(dim=(0, 1))[None])
    return tuple(g.to(x.dtype) for g, x in zip(grads, (q_comp, qp, item_comp, ip, w1, b1, w2, b2)))


def tc_route(dtype: torch.dtype, p_q: int, p_x: int, d_p: int, hd: int) -> bool:
    """The width rule of K5's tensor-core route (`losstc::tc_ok` in
    csrc/mol_loss_tc.cuh; the CUDA-core entry points refuse what it takes):
    P_Q = 8 (a query's components are one n8 tile of the logits' product);
    P_X = 4, or 8 with bf16 operands (L = 32 or 64 logits, whole k16 steps;
    f32 at P_X = 8 would need at least 243,456 B of shared memory at H =
    128); d_P <= 128, a multiple of 16 for bf16 (whole k16 steps) or of 8
    for f32 (staged with zeros to a multiple of 16); H a multiple of 16 up to
    128 (one 16-unit hidden chunk per warp, its dW1 and dW2 sums in
    registers). ML-1M's 8x4x64 and ML-20M's 8x4x128 in f32 and Amazon Books'
    8x8x32 in bf16, H = 128, take it; the (4, 2) instances (synthetic-small)
    and H = 24 stay on the CUDA cores."""
    bf16 = dtype == torch.bfloat16
    mult = 16 if bf16 else 8
    return (dtype in _DTYPE_CODE and p_q == 8 and (p_x == 4 or (bf16 and p_x == 8))
            and 0 < d_p <= MAX_DOT_PRODUCT_DIM and d_p % mult == 0 and 16 <= hd <= 128
            and hd % 16 == 0)


def _prepare(q_comp, qp, item_comp, ip, w1, b1, w2, b2, p_q: int, p_x: int, backward: bool,
             what: str):
    """Validate the operands of the forward or backward kernel; returns
    (m, r, d_p, h, dtype code, tc route, lib)."""
    m, pq_, d_p = q_comp.shape
    r = item_comp.shape[0]
    l = p_q * p_x
    h = w1.shape[-1]
    if (p_q, p_x) not in SUPPORTED_GROUPS or d_p > MAX_DOT_PRODUCT_DIM:
        raise NotImplementedError(
            f"{what}: (P_Q, P_X)=({p_q}, {p_x}), d_P={d_p} has no kernel instance; supported: "
            f"{SUPPORTED_GROUPS}, d_P <= {MAX_DOT_PRODUCT_DIM} (ROADMAP.md, Queue 1: K5 variants)"
        )
    tensors = (q_comp, qp, item_comp, ip, w1, b1, w2, b2)
    dtype = item_comp.dtype
    if (dtype not in _DTYPE_CODE or any(x.dtype != dtype for x in tensors[:4])
            or any(x.dtype != torch.float32 for x in tensors[4:])):
        raise NotImplementedError(
            f"{what}: the kernel takes q_comp, qp, item_comp and ip all f32 or all bf16, "
            f"with f32 weights; got {[x.dtype for x in tensors]}"
        )
    want = {"q_comp": (m, p_q, d_p), "qp": (m, l), "item_comp": (r, p_x, d_p), "ip": (r, l),
            "w1": (l, h), "b1": (1, h), "w2": (h, l), "b2": (1, l)}
    got = dict(zip(want, (tuple(x.shape) for x in tensors)))
    if got != want or pq_ != p_q:
        raise ValueError(f"{what}: shapes {got}, want {want}")
    lib = _build.load_library()
    code, tc = _DTYPE_CODE[dtype], tc_route(dtype, p_q, p_x, d_p, h)
    smem = (lib.rails_mol_loss_tc_smem_bytes(int(backward), code, p_x, d_p, h) if tc
            else lib.rails_mol_loss_smem_bytes(int(backward), p_q, p_x, d_p, h))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{what}: d_P={d_p}, H={h} need {smem} B of shared memory")
    return m, r, d_p, h, code, tc, lib


def _kernel_layout(q_comp, qp, item_comp, ip, w1, b1, w2, b2, tc: bool) -> dict:
    """Contiguous operands in the kernels' layouts, W1 and W2 rounded to the
    MLP's dtype (the dict keeps every temporary alive until the launch has
    been enqueued). The tensor-core route reads item and ip as they are; the
    CUDA-core route reads their transposes."""
    mlp = _mlp_dtype(item_comp)
    ops = {"q": q_comp.contiguous(), "qp": qp.contiguous(), "item": item_comp.contiguous(),
           "ip": ip.contiguous(),
           "w1t": w1.to(mlp).float().T.contiguous(),               # (H, L)
           "b1": b1.contiguous(),
           "w2": w2.to(mlp).float().contiguous(), "b2": b2.contiguous()}
    if not tc:
        ops.update(item_t=item_comp.permute(1, 2, 0).contiguous(),  # (P_X, d_P, R)
                   ip_t=ip.T.contiguous())                          # (L, R)
    return ops


def _stream_extents(m: int, r: int, rows: Optional[Tuple[int, int]]) -> Tuple[int, int, int]:
    """(M padded, R padded, seed shift) of the streams: a rank's rows
    [offset, offset + M) of `rows` = (offset, total) index the global batch's
    stream, whose padded M the kernel takes, and the seed carries the row
    offset (the hash adds the seed to idx * M1, so idx + offset * R_pad is
    the seed shifted by `stream_offset`)."""
    off, total = (0, m) if rows is None else rows
    mp, rp = padded_extents(total, r)
    return mp, rp, stream_offset(off * rp)


def _drop_args(seed: int, qi_rate: float, pi_rate: float, shift: int = 0) -> list:
    """The dropout arguments of both entry points: use, seed + salt, threshold
    and scale of the qi stream, then of the pi stream."""
    out = []
    for salt, rate in ((QI_SALT, qi_rate), (PI_SALT, pi_rate)):
        use = rate > 0.0
        out += [int(use), wrap_i32(seed + salt + shift) & 0xFFFFFFFF, keep_threshold(rate) if use else 0,
                1.0 / (1.0 - rate) if use else 1.0]
    return out


def fused_mol_loss_forward(
    q_comp, qp, item_comp, ip, w1, b1, w2, b2, seed: int, *, p_q: int, p_x: int,
    temperature: float, qi_rate: float, pi_rate: float, eps: float,
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """The forward; same arguments as `fused_mol_loss_forward_reference`."""
    kw = dict(p_q=p_q, p_x=p_x, temperature=temperature, qi_rate=qi_rate, pi_rate=pi_rate,
              eps=eps, rows=rows)
    tensors = (q_comp, qp, item_comp, ip, w1, b1, w2, b2)
    if not use_kernel(*tensors):
        return fused_mol_loss_forward_reference(*tensors, seed, **kw)
    m, r, d_p, h, code, tc, lib = _prepare(*tensors, p_q, p_x, False, "fused_mol_loss_forward")
    mp, rp, shift = _stream_extents(m, r, rows)
    with torch.cuda.device(q_comp.device):
        ops = _kernel_layout(*tensors, tc)
        out = torch.empty(m, r, dtype=torch.float32, device=q_comp.device)
        if tc:
            err = lib.rails_mol_loss_tc_fwd(
                code, p_x, *(ops[k].data_ptr() for k in ("q", "qp", "item", "ip", "w1t", "b1",
                                                       "w2", "b2")),
                out.data_ptr(), m, r, d_p, h, mp, rp, 1.0 / temperature, eps,
                *_drop_args(seed, qi_rate, pi_rate, shift), torch.cuda.current_stream().cuda_stream,
            )
        else:
            err = lib.rails_mol_loss_fwd(
                code, p_q, p_x, *(ops[k].data_ptr() for k in ("q", "qp", "item_t", "ip_t", "w1t",
                                                        "b1", "w2", "b2")),
                out.data_ptr(), m, r, d_p, h, mp, rp, 1.0 / temperature, eps,
                *_drop_args(seed, qi_rate, pi_rate, shift), torch.cuda.current_stream().cuda_stream,
            )
    _build.check(lib, err, "fused_mol_loss_forward")
    fused_mol_loss_forward.launches += 1
    fused_mol_loss_forward.bf16_launches += code == 1
    fused_mol_loss_forward.tc_launches += tc
    return out


fused_mol_loss_forward.launches = 0
fused_mol_loss_forward.bf16_launches = 0
fused_mol_loss_forward.tc_launches = 0


def fused_mol_loss_backward(
    q_comp, qp, item_comp, ip, w1, b1, w2, b2, seed: int, d_out, *, p_q: int, p_x: int,
    temperature: float, qi_rate: float, pi_rate: float, eps: float,
    rows: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, ...]:
    """The backward: gradients of sum(out * d_out) with respect to q_comp, qp,
    item_comp, ip, w1, b1, w2 and b2; same arguments as
    `fused_mol_loss_backward_reference`."""
    kw = dict(p_q=p_q, p_x=p_x, temperature=temperature, qi_rate=qi_rate, pi_rate=pi_rate,
              eps=eps, rows=rows)
    tensors = (q_comp, qp, item_comp, ip, w1, b1, w2, b2)
    if not use_kernel(*tensors, d_out):
        return fused_mol_loss_backward_reference(*tensors, seed, d_out, **kw)
    m, r, d_p, h, code, tc, lib = _prepare(*tensors, p_q, p_x, True, "fused_mol_loss_backward")
    if tuple(d_out.shape) != (m, r) or d_out.dtype != torch.float32:
        raise ValueError(f"fused_mol_loss_backward: d_out must be f32 {(m, r)}; got "
                         f"{d_out.dtype} {tuple(d_out.shape)}")
    l = p_q * p_x
    mp, rp, shift = _stream_extents(m, r, rows)
    dev = q_comp.device
    stride = 2 * h * l + h + l + r * l + r * p_x * d_p
    # One slot per persistent block: one block per SM, fewer when M is small.
    nb = min(-(-m // _BLOCK_Q), torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(dev):
        ops = _kernel_layout(*tensors, tc)
        d_out = d_out.contiguous()
        dq = torch.zeros(m, p_q, d_p, dtype=torch.float32, device=dev)
        dqp = torch.zeros(m, l, dtype=torch.float32, device=dev)
        part = torch.zeros(nb, stride, dtype=torch.float32, device=dev)
        red = torch.empty(stride, dtype=torch.float32, device=dev)
        tail = (d_out.data_ptr(), dq.data_ptr(), dqp.data_ptr(), part.data_ptr(), red.data_ptr(),
                nb, m, r, d_p, h, mp, rp, 1.0 / temperature, eps,
                *_drop_args(seed, qi_rate, pi_rate, shift), torch.cuda.current_stream().cuda_stream)
        if tc:
            err = lib.rails_mol_loss_tc_bwd(
                code, p_x, *(ops[k].data_ptr() for k in ("q", "qp", "item", "ip", "w1t", "b1",
                                                       "w2", "b2")), *tail)
        else:
            err = lib.rails_mol_loss_bwd(
                code, p_q, p_x, *(ops[k].data_ptr() for k in ("q", "qp", "item", "item_t", "ip",
                                                        "ip_t", "w1t", "b1", "w2", "b2")), *tail)
    _build.check(lib, err, "fused_mol_loss_backward")
    fused_mol_loss_backward.launches += 1
    fused_mol_loss_backward.bf16_launches += code == 1
    fused_mol_loss_backward.tc_launches += tc
    dw1, dw2, db1, db2, dip, ditem = torch.split(red, [h * l, h * l, h, l, r * l, r * p_x * d_p])
    grads = (dq, dqp, ditem.reshape(r, p_x, d_p), dip.reshape(r, l), dw1.reshape(h, l).T,
             db1.reshape(1, h), dw2.reshape(h, l), db2.reshape(1, l))
    return tuple(g.to(x.dtype) for g, x in zip(grads, tensors))


fused_mol_loss_backward.launches = 0
fused_mol_loss_backward.bf16_launches = 0
fused_mol_loss_backward.tc_launches = 0


class FusedMolLoss(torch.autograd.Function):
    """(M, R) shared-negative MoL scores, differentiable in the 8 array inputs
    (the JAX function's custom VJP); the backward regenerates the masks."""

    @staticmethod
    def forward(ctx, q_comp, qp, item_comp, ip, w1, b1, w2, b2, seed: int, kw: dict):
        out = fused_mol_loss_forward(q_comp, qp, item_comp, ip, w1, b1, w2, b2, seed, **kw)
        ctx.save_for_backward(q_comp, qp, item_comp, ip, w1, b1, w2, b2)
        ctx.seed, ctx.kw = seed, kw
        return out

    @staticmethod
    def backward(ctx, d_out):
        grads = fused_mol_loss_backward(*ctx.saved_tensors, ctx.seed, d_out.contiguous(),
                                        **ctx.kw)
        return (*grads, None, None)


def fused_mol_loss(
    q_comp, qp, item_comp, ip, w1, b1, w2, b2, seed: int, *, p_q: int, p_x: int,
    temperature: float, qi_rate: float, pi_rate: float, eps: float,
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """`make_fused_mol_loss(p_q, p_x, temperature, pi_rate, qi_rate, eps)` applied
    to (q_comp, qp, item_comp, ip, MoLKernelWeights(w1, b1, w2, b2), seed).
    `rows` = (offset, total): the M rows are rows [offset, offset + M) of a
    data-parallel global batch of `total` rows, and draw those rows' masks
    of its streams."""
    kw = dict(p_q=p_q, p_x=p_x, temperature=temperature, qi_rate=qi_rate, pi_rate=pi_rate,
              eps=eps, rows=rows)
    return FusedMolLoss.apply(q_comp, qp, item_comp, ip, w1, b1, w2, b2, wrap_i32(seed), kw)
