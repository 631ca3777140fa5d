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


def _mixture_chunks(mode, q_comp, qp, item, ip, weights, inv_temperature):
    """Per `_REF_COLS` corpus columns: (first column, logits (B, C, L), the
    mixture weights e (B, C, L), or None in the modes that do not combine),
    with the probe's bf16 rounding points (the MLP's inputs)."""
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
            yield c, logits, None
            continue
        if mode == "nomlp":
            qi = b2f.expand_as(logits)
        else:
            h = logits.to(torch.bfloat16).float() @ w1f + b1f
            h = h * torch.sigmoid(h)
            qi = h.to(torch.bfloat16).float() @ w2f + b2f
        gi = qp.float()[:, None, :] * ip[:, c : c + _REF_COLS].float().T[None] + qi
        gw = gi if mode == "nosilu" else gi * torch.sigmoid(gi)
        yield c, logits, gw if mode == "noexp" else torch.exp(gw - gw.amax(dim=-1, keepdim=True))


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
    for c, logits, e in _mixture_chunks(mode, q_comp, qp, item, ip, weights, inv_temperature):
        if e is not None:
            out[:, c : c + _REF_COLS] = (e * logits).sum(dim=-1) / e.sum(dim=-1)
        elif mode == "writeonly":
            out[:, c : c + _REF_COLS] = logits[..., 0]
        else:
            out[:, c : c + _REF_COLS] = logits.mean(dim=-1)
    return out


def mol_probe_error_bound(
    mode: str,
    q_comp: torch.Tensor,
    qp: torch.Tensor,
    item: torch.Tensor,
    ip: torch.Tensor,
    weights: MoLKernelWeights,
    tol: float,
    inv_temperature: float = INV_TEMPERATURE,
) -> torch.Tensor:
    """How far (B, X) a kernel's score may lie from the plain version's,
    for a relative perturbation `tol` of the terms each score sums: both
    round the MLP's inputs to bf16 at the same points but sum in other f32
    orders, so a rare (query, item) pair rounds a logit or hidden unit one
    bf16 ulp apart and its gating terms move.

    Every mode but noexp scores a mean or a convex combination of its
    logits: tol * max |score|, the same for every score. noexp's weights
    e = silu(gi) are signed, so sum(e) can cancel and the score
    sum(e * logit) / sum(e) has no such scale; its bound is per score,
    tol * sum_l |e_l| * (max_l |logit_l| + |score|) / |sum(e)|, which for
    weights that are all positive is at most tol * 2 max |logit|."""
    if mode != "noexp":
        ref = mol_probe_scores_reference(mode, q_comp, qp, item, ip, weights, inv_temperature)
        return torch.full_like(ref, tol * ref.abs().max().item())
    b, x = q_comp.shape[0], item.shape[2]
    out = torch.empty(b, x, dtype=torch.float32, device=q_comp.device)
    for c, logits, e in _mixture_chunks(mode, q_comp, qp, item, ip, weights, inv_temperature):
        s0 = e.sum(dim=-1)
        score = (e * logits).sum(dim=-1) / s0
        out[:, c : c + _REF_COLS] = (tol * e.abs().sum(dim=-1)
                                     * (logits.abs().amax(dim=-1) + score.abs()) / s0.abs())
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
