"""The MoL scoring cost probe (P2): CUDA kernel wrapper + plain version.

Replaces the Pallas kernel of `rails_tpu/cli/mol_probe.py` (`make_scorer`
:132-170, body `_variant_kernel` :39-93): K2's scoring chain at the probe's
geometry, MoL 8x4x128 with H=128, bf16 item tables, the qi MLP in bf16 and
1/temperature = 20, in one of `MODES`, each dropping one stage so that its
device time, subtracted from `full`'s, prices the stage:

    full       logits, qi MLP, gating combine, (B, X) write
    nosilu     gw = gi (no SiLU on the gating)
    noexp      e = gw (no exp)
    nomlp      qi = b2 (no MLP)
    nocombine  out = mean over l of the logits
    writeonly  out = logit 0 (every logit computed)

The probe lays its logits, qp and ip rows, W1 rows, W2 columns and b2 out
m-major (l = m * P_Q + n, `mol_probe.py:55-58`); K2 is n-major. The kernel
is K2's own (its tensor-core kernel `csrc/mol_scoring_tc.cuh` at the widths
of `tc_route`, the probe's among them, else `csrc/mol_scoring.cuh`;
instantiated per mode in `csrc/mol_probe.cu`), so `probe_operands` puts the
probe's arrays into K2's order once at set-up, and both functions here take
the result: q_comp
(B, P_Q, d_P) bf16, qp (B, L) f32, item (P_X, d_P, X) and ip (L, X) bf16,
and the qi MLP as `MoLKernelWeights`. `mol_probe_scores` follows the port's
dispatch rule (CPU tensors run `mol_probe_scores_reference`, CUDA tensors
launch the kernel or raise) and counts its launches in `.launches`, those on
the tensor cores in `.tc_launches`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rails_tpu_torch.core.device import use_kernel
from rails_tpu_torch.ops import _build
from rails_tpu_torch.ops.hstu_block import MAX_SMEM_BYTES
from rails_tpu_torch.ops.mol_scoring import MoLKernelWeights, tc_route

MODES = ("full", "nosilu", "noexp", "nomlp", "nocombine", "writeonly")
GEOMETRY = (8, 4)          # (P_Q, P_X) of the kernel's one instance
INV_TEMPERATURE = 20.0     # the probe's 1 / temperature
_TILE_X = 32               # items per block (`kTileX` in csrc/mol_scoring.cuh)
_REF_COLS = 8192           # corpus columns per step of the plain version


def probe_operands(
    q: torch.Tensor,       # (P_Q, B, d_P) f32
    qp: torch.Tensor,      # (B, L) f32, m-major
    item: torch.Tensor,    # (P_X, d_P, X) bf16
    ip: torch.Tensor,      # (L, X) bf16, m-major rows
    w1: torch.Tensor,      # (L, H) f32, m-major rows
    b1: torch.Tensor,      # (H,) or (1, H) f32
    w2: torch.Tensor,      # (H, L) f32, m-major columns
    b2: torch.Tensor,      # (L,) or (1, L) f32, m-major
) -> tuple:
    """The JAX probe's arrays as K2's operands, once at set-up: q rounded to
    bf16 as the probe rounds it and laid out (B, P_Q, d_P), and every
    L-indexed array permuted from m-major to K2's n-major order (l = n * P_X
    + m). Returns (q_comp, qp, item, ip, MoLKernelWeights)."""
    p_q, p_x = q.shape[0], item.shape[0]
    perm = torch.tensor([m * p_q + n for n in range(p_q) for m in range(p_x)],
                        device=q.device)
    weights = MoLKernelWeights(w1[perm].contiguous(), b1.reshape(-1).contiguous(),
                               w2[:, perm].contiguous(), b2.reshape(-1)[perm].contiguous())
    return (q.to(torch.bfloat16).permute(1, 0, 2).contiguous(), qp[:, perm].contiguous(), item,
            ip[perm].contiguous(), weights)


class _Chunk(NamedTuple):
    """One step of the plain version: the first corpus column, the logits
    (B, C, L), and where the mode has them the bf16-rounded hidden units
    (B, C, H), the gating inputs gi and weights gw (B, C, L) and the mixture
    weights e (B, C, L)."""

    col: int
    logits: torch.Tensor
    hidden: Optional[torch.Tensor] = None
    gi: Optional[torch.Tensor] = None
    gw: Optional[torch.Tensor] = None
    e: Optional[torch.Tensor] = None


def _mixture_chunks(mode, q_comp, qp, item, ip, weights, inv_temperature):
    """The plain version's steps over `_REF_COLS` corpus columns at a time
    (`_Chunk`), with the probe's bf16 rounding points (the MLP's inputs)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; expected one of {MODES}")
    b, p_q, _ = q_comp.shape
    p_x, _, x = item.shape
    l = p_q * p_x
    qf = q_comp.float()
    w1f = weights.w1.to(torch.bfloat16).float()
    w2f = weights.w2.to(torch.bfloat16).float()
    b1f, b2f = weights.b1.float(), weights.b2.float()
    for c in range(0, x, _REF_COLS):
        items = item[:, :, c : c + _REF_COLS].float()
        # logits[b, x, n * P_X + m] = <q_n, item_m> * inv_temperature
        logits = torch.einsum("bnd,mdx->bxnm", qf, items).reshape(b, -1, l) * inv_temperature
        if mode in ("writeonly", "nocombine"):
            yield _Chunk(c, logits)
            continue
        hidden = None
        if mode == "nomlp":
            qi = b2f.expand_as(logits)
        else:
            h = logits.to(torch.bfloat16).float() @ w1f + b1f
            h = h * torch.sigmoid(h)
            hidden = h.to(torch.bfloat16).float()
            qi = hidden @ w2f + b2f
        gi = qp.float()[:, None, :] * ip[:, c : c + _REF_COLS].float().T[None] + qi
        gw = gi if mode == "nosilu" else gi * torch.sigmoid(gi)
        e = gw if mode == "noexp" else torch.exp(gw - gw.amax(dim=-1, keepdim=True))
        yield _Chunk(c, logits, hidden, gi, gw, e)


def mol_probe_scores_reference(
    mode: str,
    q_comp: torch.Tensor,      # (B, P_Q, d_P) bf16
    qp: torch.Tensor,          # (B, L) f32
    item: torch.Tensor,        # (P_X, d_P, X) bf16
    ip: torch.Tensor,          # (L, X) bf16
    weights: MoLKernelWeights,
    inv_temperature: float = INV_TEMPERATURE,
) -> torch.Tensor:
    """Plain PyTorch version of the probe's scorer in `mode`: (B, X) f32,
    `_REF_COLS` corpus columns at a time, with the probe's bf16 rounding
    points (the MLP's inputs)."""
    b, x = q_comp.shape[0], item.shape[2]
    out = torch.empty(b, x, dtype=torch.float32, device=q_comp.device)
    for t in _mixture_chunks(mode, q_comp, qp, item, ip, weights, inv_temperature):
        cols = slice(t.col, t.col + _REF_COLS)
        if t.e is not None:
            out[:, cols] = (t.e * t.logits).sum(dim=-1) / t.e.sum(dim=-1)
        elif mode == "writeonly":
            out[:, cols] = t.logits[..., 0]
        else:
            out[:, cols] = t.logits.mean(dim=-1)
    return out


# The rounding model of `mol_probe_error_bound`: the f32 unit roundoff, the
# largest slope of SiLU (|d silu(v) / dv| peaks at 1.0998, v = 2.3994), and
# the accuracy of the kernel's `__expf` (2 + 1.16 |x| ulp) and `__fdividef`
# (2 ulp; CUDA C++ Programming Guide, intrinsic functions).
F32_UNIT = 2.0 ** -24
SILU_SLOPE = 1.0998
_EXPF_ULPS = (2.0, 1.16)
_FDIV_ULPS = 2.0


def _gamma(n: int) -> float:
    """Relative error bound of an f32 sum of n terms, any order:
    n u / (1 - n u)."""
    return n * F32_UNIT / (1.0 - n * F32_UNIT)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |t|: the spacing of bf16 values just above |t|'s bf16
    rounding (the wider one where that value is a power of two)."""
    mag = t.abs().to(torch.bfloat16).float() * (1.0 + 2.0 ** -8)
    _, exp = torch.frexp(mag.clamp_min(torch.finfo(torch.float32).tiny))
    return torch.ldexp(torch.ones_like(mag), exp - 8)


def mol_probe_error_bound(
    mode: str,
    q_comp: torch.Tensor,
    qp: torch.Tensor,
    item: torch.Tensor,
    ip: torch.Tensor,
    weights: MoLKernelWeights,
    inv_temperature: float = INV_TEMPERATURE,
) -> torch.Tensor:
    """How far (B, X) a kernel's score may lie from the plain version's, per
    score, under the rounding model both share: they round the MLP's inputs
    (the L logits and the H hidden units) to bf16 at the same points and sum
    in other f32 orders, so a rare (query, item) pair rounds ONE of those
    inputs one bf16 ulp (`bf16_ulp`, 2^-8 to 2^-7 of it) apart. The bound is
    the largest effect of any one such flip, carried through the MLP with
    absolute weights, plus every f32 term (`_gamma` of each sum's length, the
    kernel's `__expf` and `__fdividef`):

      a logit l0 moves by d0 = ulp(logit l0): each hidden unit by at most
        SILU_SLOPE |W1[l0, k]| d0, and by one ulp of its own more where that
        crosses a rounding boundary (every unit is counted as crossing); each
        gating input gi_l then by SILU_SLOPE d0 (|W1| @ |W2|)[l0, l] +
        (ulp(hidden) @ |W2|)_l;
      a hidden unit k0 moves by ulp(hidden k0): gi_l by that times |W2[k0, l]|;
      the gating SiLU multiplies a move by at most SILU_SLOPE (nosilu: 1).

    With moves delta_l of the gating weights (|delta_l| <= D), a softmax
    mixture's score sum_l pi_l logit_l moves by at most
    e^(2D) sum_l pi_l |logit_l - score| |delta_l|. noexp's weights e = silu(gi)
    are signed and sum(e) can cancel, so its bound is per score:
    (sum_l |logit_l - score| |delta_l| + the logits' f32 terms) /
    (|sum(e)| - sum_l |delta_l|), infinite where that is not positive. nomlp flips
    nothing (no bf16 input), and writeonly and nocombine score logits only:
    their bounds are the f32 terms alone."""
    b, x = q_comp.shape[0], item.shape[2]
    d_p, hd = item.shape[1], weights.w1.shape[1]
    l = q_comp.shape[1] * item.shape[0]
    w1a = weights.w1.to(torch.bfloat16).float().abs()
    w2a = weights.w2.to(torch.bfloat16).float().abs()
    through = w1a @ w2a                                   # (L, L) logit l0 -> gating input l
    slope = 1.0 if mode == "nosilu" else SILU_SLOPE
    qa = q_comp.float().abs()
    u = F32_UNIT
    out = torch.empty(b, x, dtype=torch.float32, device=q_comp.device)
    for t in _mixture_chunks(mode, q_comp, qp, item, ip, weights, inv_temperature):
        cols = slice(t.col, t.col + _REF_COLS)
        lg = t.logits
        # Each side's f32 logit lies within gamma(d_P) sum |q||item| / T of the exact one.
        d32 = 2.0 * _gamma(d_p) * inv_temperature * torch.einsum(
            "bnd,mdx->bxnm", qa, item[:, :, cols].float().abs()).reshape(lg.shape)
        if mode == "writeonly":
            out[:, cols] = d32[..., 0]
            continue
        if mode == "nocombine":
            out[:, cols] = d32.mean(dim=-1) + 2.0 * _gamma(l) * lg.abs().mean(dim=-1)
            continue
        # The gating inputs' f32 terms: qp * ip + (hidden @ W2 + b2), both sides.
        gate_sum = (qp.float().abs()[:, None, :] * ip[:, cols].float().abs().T[None]
                    + weights.b2.float().abs())
        if t.hidden is not None:
            gate_sum = gate_sum + t.hidden.abs() @ w2a
        dg = slope * 2.0 * _gamma(2 if t.hidden is None else hd + 2) * gate_sum
        if mode != "nosilu":      # the kernel's SiLU: __expf and __fdividef
            dg = dg + (_EXPF_ULPS[0] + _FDIV_ULPS + _EXPF_ULPS[1] * t.gi.abs()) * u * t.gw.abs()
        if mode != "noexp":       # its softmax exp, a relative error: an exponent shift
            dg = dg + (_EXPF_ULPS[0] + _EXPF_ULPS[1]
                       * (t.gw - t.gw.amax(dim=-1, keepdim=True)).abs()) * u
        if t.e is not None and mode != "noexp":
            pi = t.e / t.e.sum(dim=-1, keepdim=True)
            score = (pi * lg).sum(dim=-1)
        else:
            s0 = t.e.sum(dim=-1)
            score = (t.e * lg).sum(dim=-1) / s0
        dev = (lg - score[..., None]).abs()
        wgt = dev if mode == "noexp" else pi * dev
        d, shift = dg.amax(dim=-1), dg.sum(dim=-1)
        flip = torch.zeros_like(score)
        if t.hidden is not None:
            d0, uh = bf16_ulp(lg), bf16_ulp(t.hidden)
            reround = uh @ w2a                                       # (B, C, L)

            def worst(weight):
                """The largest sum_l weight_l |delta_l| of one flip."""
                by_logit = ((SILU_SLOPE * d0 * (weight @ through.T)).amax(dim=-1)
                            + (weight * reround).sum(dim=-1))
                return slope * torch.maximum(by_logit, (uh * (weight @ w2a.T)).amax(dim=-1))

            flip = worst(wgt)
            shift = shift + worst(torch.ones_like(wgt))
            moves = torch.maximum(SILU_SLOPE * d0.amax(dim=-1, keepdim=True) * through.amax(dim=0)
                                  + reround, uh.amax(dim=-1, keepdim=True) * w2a.amax(dim=0))
            d = d + slope * moves.amax(dim=-1)
        gate = flip + (wgt * dg).sum(dim=-1)
        if mode == "noexp":
            ea = t.e.abs()
            den = s0.abs() - shift
            num = gate + ((ea + d[..., None]) * d32).sum(dim=-1)
            f32_mix = 2.0 * (_gamma(l) * ((ea * lg.abs()).sum(-1) + score.abs() * ea.sum(-1))
                             / s0.abs() + u * score.abs())
            out[:, cols] = torch.where(den > 0, num / den.clamp_min(torch.finfo(torch.float32).tiny)
                                       + f32_mix, torch.full_like(den, float("inf")))
        else:
            f32_mix = 2.0 * (_gamma(l) * ((pi * lg.abs()).sum(-1) + score.abs()) + u * score.abs())
            out[:, cols] = torch.exp(2.0 * d) * gate + (pi * d32).sum(dim=-1) + f32_mix
    return out


def mol_probe_scores(
    mode: str,
    q_comp: torch.Tensor,
    qp: torch.Tensor,
    item: torch.Tensor,
    ip: torch.Tensor,
    weights: MoLKernelWeights,
    inv_temperature: float = INV_TEMPERATURE,
) -> torch.Tensor:
    """The probe's scorer in `mode`; same arguments as
    `mol_probe_scores_reference`. X must be a multiple of 32."""
    tensors = (q_comp, qp, item, ip, *weights)
    if not use_kernel(*tensors):
        return mol_probe_scores_reference(mode, q_comp, qp, item, ip, weights, inv_temperature)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; expected one of {MODES}")
    b, p_q, d_p = q_comp.shape
    p_x, _, x = item.shape
    l, hd = p_q * p_x, weights.w1.shape[1]
    if (p_q, p_x) != GEOMETRY:
        raise NotImplementedError(f"mol_probe_scores: (P_Q, P_X)=({p_q}, {p_x}) has no "
                                  f"instance; the probe's is {GEOMETRY}")
    if (q_comp.dtype != torch.bfloat16 or item.dtype != torch.bfloat16
            or ip.dtype != torch.bfloat16 or item.shape[1] != d_p
            or tuple(ip.shape) != (l, x) or tuple(qp.shape) != (b, l) or x % _TILE_X
            or tuple(weights.w1.shape) != (l, hd) or tuple(weights.w2.shape) != (hd, l)
            or weights.b1.numel() != hd or weights.b2.numel() != l
            or not (q_comp.is_contiguous() and item.is_contiguous() and ip.is_contiguous())):
        raise ValueError(
            f"mol_probe_scores: expected contiguous bf16 q_comp (B, P_Q, d_P), item (P_X, d_P, "
            f"X) and ip (L, X) with X a multiple of {_TILE_X}; got q_comp {q_comp.dtype} "
            f"{tuple(q_comp.shape)}, qp {tuple(qp.shape)}, item {item.dtype} "
            f"{tuple(item.shape)}, ip {ip.dtype} {tuple(ip.shape)}, w1 "
            f"{tuple(weights.w1.shape)}, w2 {tuple(weights.w2.shape)}"
        )
    tc = tc_route(torch.bfloat16, p_q, p_x, d_p, hd)
    lib = _build.load_library()
    if lib.rails_mol_probe_smem_bytes(int(tc), d_p, hd) > MAX_SMEM_BYTES:
        raise ValueError(f"mol_probe_scores: d_P={d_p}, H={hd} do not fit shared memory")
    with torch.cuda.device(q_comp.device):
        w1t = weights.w1.to(torch.bfloat16).float().T.contiguous()        # (H, L)
        w2f = weights.w2.to(torch.bfloat16).float().contiguous()          # (H, L)
        b1f = weights.b1.reshape(-1).float().contiguous()
        b2f = weights.b2.reshape(-1).float().contiguous()
        qpf = qp.float().contiguous()
        out = torch.empty(b, x, dtype=torch.float32, device=q_comp.device)
        err = lib.rails_mol_probe(
            int(tc), MODES.index(mode), q_comp.data_ptr(), qpf.data_ptr(), item.data_ptr(),
            ip.data_ptr(), w1t.data_ptr(), b1f.data_ptr(), w2f.data_ptr(), b2f.data_ptr(),
            out.data_ptr(), b, x, d_p, hd, inv_temperature,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "mol_probe_scores")
    mol_probe_scores.launches += 1
    mol_probe_scores.tc_launches += tc
    return out


mol_probe_scores.launches = 0
mol_probe_scores.tc_launches = 0
