"""Fused MoL corpus scoring (K2): CUDA kernel wrapper + plain version.

Replaces the Pallas kernel `fused_mol_scores_t`
(`rails_tpu/ops/pallas/mol_scoring.py:588-759`, body `_kernel` :53-182) for
bf16 and f32 tables:

    logits[l = n*P_X + m] = <q_n, x_m> / T
    qi  = W2' silu(W1' logits + b1) + b2
    gi  = qp * ip + qi ;  gw = silu(gi)
    out = sum_l softmax_l(gw) * logits

Kernel: `csrc/mol_scoring.cu`, one block per (32 items x 32 queries); the
source's header says what bounds it on an H100 and how the design keeps the
qi MLP in registers. The logits stay in the model's n-major order (the TPU
kernel's m-major permutation is a VMEM layout choice), so the tables are the
model's tables transposed to (P_X, d_P, X) and (L, X) and padded to a multiple
of the kernel's 32-item tile (`prepare_fused_tables`). Not ported: `emit_blockmax` and int8
tables (ROADMAP.md, Queue 1: K2 options).

`fused_mol_scores_t` follows the port's dispatch rule: CPU tensors run
`fused_mol_scores_t_reference`, CUDA tensors launch the kernel or raise.
`fused_mol_scores_t.launches` counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from rails_tpu_torch.core.device import use_kernel
from rails_tpu_torch.ops import _build
from rails_tpu_torch.ops.hstu_block import MAX_SMEM_BYTES

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (P_Q, P_X) geometries the kernel is instantiated for: ML-1M/ML-20M and
# the synthetic-small test config.
SUPPORTED_GROUPS = ((8, 4), (4, 2))
_TILE_X = 32          # items per kernel block (`kTileX` in csrc/mol_scoring.cu)
_REF_CHUNK = 64       # queries per step of the plain version (bounds its hidden layer)


class MoLKernelWeights(NamedTuple):
    """The qi gating MLP, in the flax layout of `mol_scoring.py:463-469`."""

    w1: torch.Tensor   # (L, H)
    b1: torch.Tensor   # (H,)
    w2: torch.Tensor   # (H, L)
    b2: torch.Tensor   # (L,)


def extract_gating_qi_weights(mol) -> MoLKernelWeights:
    """The qi MLP of a `MoLSimilarity` (torch Linear weights are (out, in))."""
    g = mol.gating_qi
    if g.hidden is None:
        raise NotImplementedError(
            "the fused scorer needs the hidden qi layer (gating_qi_hidden_dim > 0)"
        )
    return MoLKernelWeights(g.hidden.weight.T, g.hidden.bias, g.out.weight.T, g.out.bias)


class FusedCorpusTables(NamedTuple):
    """Kernel-layout corpus tables, padded to a multiple of the item tile."""

    item_comp_t: torch.Tensor      # (P_X, d_P, X_padded)
    item_partial_t: torch.Tensor   # (L, X_padded), n-major logit order
    num_items: int                 # unpadded X


def prepare_fused_tables(
    item_comp: torch.Tensor,      # (X, P_X, d_P)
    item_partial: torch.Tensor,   # (X, L)
) -> FusedCorpusTables:
    """One-time per-corpus transpose into the kernel layout, zero-padded to a
    multiple of the kernel's item tile (`pad_corpus_tables`, `mol_scoring.py:916-926`)."""
    x = item_comp.shape[0]
    pad = (-x) % _TILE_X
    if pad:
        item_comp = F.pad(item_comp, (0, 0, 0, 0, 0, pad))
        item_partial = F.pad(item_partial, (0, 0, 0, pad))
    return FusedCorpusTables(
        item_comp_t=item_comp.permute(1, 2, 0).contiguous(),
        item_partial_t=item_partial.T.contiguous(),
        num_items=x,
    )


def _mlp_dtype(item_comp_t: torch.Tensor) -> torch.dtype:
    # The gating MLP runs on bf16 inputs with bf16 tables (`mol_scoring.py:634-642`).
    return torch.bfloat16 if item_comp_t.dtype == torch.bfloat16 else torch.float32


def fused_mol_scores_t_reference(
    q_comp: torch.Tensor,          # (B, P_Q, d_P), the table dtype
    query_partial: torch.Tensor,   # (B, L)
    item_comp_t: torch.Tensor,     # (P_X, d_P, X) kernel layout, X padded
    item_partial_t: torch.Tensor,  # (L, X)
    weights: MoLKernelWeights,
    temperature: float,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, X) f32 scores, with the
    kernel's bf16 rounding points, `_REF_CHUNK` queries at a time."""
    mlp = _mlp_dtype(item_comp_t)
    b, p_q, _ = q_comp.shape
    p_x, _, x = item_comp_t.shape
    items = item_comp_t.float()
    ip = item_partial_t.float().T                         # (X, L)
    w1 = weights.w1.to(mlp).float()
    w2 = weights.w2.to(mlp).float()
    b1, b2 = weights.b1.float(), weights.b2.float()
    out = torch.empty(b, x, dtype=torch.float32, device=q_comp.device)
    for s in range(0, b, _REF_CHUNK):
        q = q_comp[s : s + _REF_CHUNK].float()
        logits = torch.einsum("bnd,mdx->bxnm", q, items).reshape(q.shape[0], x, p_q * p_x)
        logits = logits * (1.0 / temperature)
        h = logits.to(mlp).float() @ w1 + b1
        h = h * torch.sigmoid(h)
        qi = h.to(mlp).float() @ w2 + b2
        gi = query_partial[s : s + _REF_CHUNK, None, :].float() * ip[None] + qi
        gw = gi * torch.sigmoid(gi)
        e = torch.exp(gw - gw.amax(dim=-1, keepdim=True))
        out[s : s + _REF_CHUNK] = (e * logits).sum(dim=-1) / e.sum(dim=-1)
    return out


def fused_mol_scores_t(
    q_comp: torch.Tensor,
    query_partial: torch.Tensor,
    item_comp_t: torch.Tensor,
    item_partial_t: torch.Tensor,
    weights: MoLKernelWeights,
    temperature: float,
) -> torch.Tensor:
    """(B, X_padded) MoL scores against kernel-layout tables; callers slice
    the pad columns off (`top_k.py:695`)."""
    tensors = (q_comp, query_partial, item_comp_t, item_partial_t, *weights)
    if not use_kernel(*tensors):
        return fused_mol_scores_t_reference(
            q_comp, query_partial, item_comp_t, item_partial_t, weights, temperature
        )
    b, p_q, d_p = q_comp.shape
    p_x, _, x = item_comp_t.shape
    l = p_q * p_x
    hd = weights.w1.shape[1]
    if (p_q, p_x) not in SUPPORTED_GROUPS:
        raise NotImplementedError(
            f"fused_mol_scores_t: (P_Q, P_X)=({p_q}, {p_x}) has no kernel instance; "
            f"supported: {SUPPORTED_GROUPS}"
        )
    dtype = item_comp_t.dtype
    if dtype not in _DTYPE_CODE or q_comp.dtype != dtype or item_partial_t.dtype != dtype:
        raise ValueError(
            "fused_mol_scores_t: q_comp, item_comp_t and item_partial_t must share "
            f"float32 or bfloat16; got {q_comp.dtype}, {dtype}, {item_partial_t.dtype}"
        )
    if (item_comp_t.shape[1] != d_p or tuple(item_partial_t.shape) != (l, x)
            or tuple(query_partial.shape) != (b, l) or x % _TILE_X
            or tuple(weights.w1.shape) != (l, hd) or tuple(weights.w2.shape) != (hd, l)
            or tuple(weights.b1.shape) != (hd,) or tuple(weights.b2.shape) != (l,)):
        raise ValueError(
            "fused_mol_scores_t: shapes disagree: q_comp "
            f"{tuple(q_comp.shape)}, query_partial {tuple(query_partial.shape)}, "
            f"item_comp_t {tuple(item_comp_t.shape)}, item_partial_t "
            f"{tuple(item_partial_t.shape)}, w1 {tuple(weights.w1.shape)}, w2 "
            f"{tuple(weights.w2.shape)} (X must be a multiple of {_TILE_X})"
        )
    if not (q_comp.is_contiguous() and item_comp_t.is_contiguous()
            and item_partial_t.is_contiguous()):
        raise ValueError("fused_mol_scores_t: q_comp and the tables must be contiguous")
    lib = _build.load_library()
    code = _DTYPE_CODE[dtype]
    smem = lib.rails_mol_scores_smem_bytes(code, p_q, p_x, d_p, hd)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"fused_mol_scores_t: d_P={d_p}, H={hd} need {smem} B of shared memory")
    mlp = _mlp_dtype(item_comp_t)
    with torch.cuda.device(q_comp.device):
        w1t = weights.w1.to(mlp).float().T.contiguous()          # (H, L)
        w2 = weights.w2.to(mlp).float().contiguous()             # (H, L)
        b1 = weights.b1.float().contiguous()
        b2 = weights.b2.float().contiguous()
        qp = query_partial.float().contiguous()
        out = torch.empty(b, x, dtype=torch.float32, device=q_comp.device)
        err = lib.rails_mol_scores(
            code, p_q, p_x, q_comp.data_ptr(), qp.data_ptr(), item_comp_t.data_ptr(),
            item_partial_t.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), b, x, d_p, hd, 1.0 / temperature,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "fused_mol_scores_t")
    fused_mol_scores_t.launches += 1
    return out


fused_mol_scores_t.launches = 0
