"""Fused MoL corpus scoring (K2), its score bounds (K8, K9) and tile scoring
(K10): CUDA kernel wrappers + plain versions.

K2 replaces the Pallas kernel `fused_mol_scores_t`
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
model's tables transposed to (P_X, d_P, X) and (L, X) and zero-padded to a
multiple of `BLOCK_X` = 256 items, the JAX build's `fused_block_x`
(`prepare_fused_tables`): a "tile" of K9, K10 and the tile methods is 256
contiguous corpus columns, the same columns as in the JAX package.

The approximate-retrieval kernels read the same tables:
  - K8 `fused_mol_ub_t` (`mol_scoring.py:375-448`, `_ub_kernel` :185-219):
    UB[b, x] = max_l logit_l(b, x), a sound upper bound on the MoL score (a
    softmax mixture of the logits); `csrc/mol_bounds.cu`.
  - K9 `fused_mol_group_block_max` (:263-368, `_group_block_max_kernel`
    :222-256): gmax[b, l, t] = max over 256-item tile t of logit_l, rows in
    the port's n-major order (the JAX rows are m-major); `csrc/mol_bounds.cu`.
    Pad columns count as logit 0 in the last tile, as in JAX.
  - K10 `fused_mol_scores_tiles` (:766-893): K2 over a list of tile ids (T,)
    int32 read on the device; output column s*256 + j is corpus column
    tile_ids[s]*256 + j. The kernel is K2's code with one indirection on the
    item tile, so its columns equal K2's bit for bit.
Not ported: `emit_blockmax` and int8 tables (`comp_scale`/`partial_scale`) of
K2 and K8-K10 (ROADMAP.md, Queue 1: K2 options).

Every wrapper follows the port's dispatch rule: CPU tensors run its
`*_reference` plain version, CUDA tensors launch the kernel or raise. Each
counts its kernel launches in `.launches`. The plain versions walk the corpus
in column chunks, so they stay within memory at a million columns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from rails_tpu_torch.core.device import use_kernel
from rails_tpu_torch.ops import _build
from rails_tpu_torch.ops.hstu_block import MAX_SMEM_BYTES

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (P_Q, P_X) geometries the kernels are instantiated for: ML-1M/ML-20M and
# the synthetic-small test config.
SUPPORTED_GROUPS = ((8, 4), (4, 2))
BLOCK_X = 256         # corpus padding multiple; the tile of K9 and K10
_TILE_X = 32          # items per K2 block (`kTileX` in csrc/mol_scoring.cu)
_REF_CHUNK = 64       # queries per step of the K2/K10 plain version
_REF_COLS = 8192      # corpus columns per step of the K2/K10 plain version
_REF_BOUND_COLS = 65_536   # corpus columns per step of the K8/K9 plain versions


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
    """Kernel-layout corpus tables, padded to a multiple of `BLOCK_X` items."""

    item_comp_t: torch.Tensor      # (P_X, d_P, X_padded)
    item_partial_t: torch.Tensor   # (L, X_padded), n-major logit order
    num_items: int                 # unpadded X


def prepare_fused_tables(
    item_comp: torch.Tensor,      # (X, P_X, d_P)
    item_partial: torch.Tensor,   # (X, L)
) -> FusedCorpusTables:
    """One-time per-corpus transpose into the kernel layout, zero-padded to a
    multiple of `BLOCK_X` (`pad_corpus_tables`, `mol_scoring.py:916-926`)."""
    x = item_comp.shape[0]
    pad = (-x) % BLOCK_X
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
    kernel's bf16 rounding points, `_REF_CHUNK` queries by `_REF_COLS`
    columns at a time."""
    mlp = _mlp_dtype(item_comp_t)
    b, p_q, _ = q_comp.shape
    p_x, _, x = item_comp_t.shape
    w1 = weights.w1.to(mlp).float()
    w2 = weights.w2.to(mlp).float()
    b1, b2 = weights.b1.float(), weights.b2.float()
    out = torch.empty(b, x, dtype=torch.float32, device=q_comp.device)
    for c in range(0, x, _REF_COLS):
        items = item_comp_t[:, :, c : c + _REF_COLS].float()
        ip = item_partial_t[:, c : c + _REF_COLS].float().T              # (C, L)
        for s in range(0, b, _REF_CHUNK):
            q = q_comp[s : s + _REF_CHUNK].float()
            logits = torch.einsum("bnd,mdx->bxnm", q, items)
            logits = logits.reshape(q.shape[0], ip.shape[0], p_q * p_x) * (1.0 / temperature)
            h = logits.to(mlp).float() @ w1 + b1
            h = h * torch.sigmoid(h)
            qi = h.to(mlp).float() @ w2 + b2
            gi = query_partial[s : s + _REF_CHUNK, None, :].float() * ip[None] + qi
            gw = gi * torch.sigmoid(gi)
            e = torch.exp(gw - gw.amax(dim=-1, keepdim=True))
            out[s : s + _REF_CHUNK, c : c + _REF_COLS] = (e * logits).sum(dim=-1) / e.sum(dim=-1)
    return out


def _check_instance(name: str, q_comp: torch.Tensor, item_comp_t: torch.Tensor) -> int:
    """The table dtypes every kernel of this module takes (not int8, whose
    scales are not ported), shared by the query. Returns the dtype code."""
    dtype = item_comp_t.dtype
    if dtype not in _DTYPE_CODE:
        raise NotImplementedError(
            f"{name}: {dtype} tables are not ported (int8 tables with their scales: "
            "ROADMAP.md, Queue 1: K2 options)"
        )
    if q_comp.dtype != dtype:
        raise ValueError(f"{name}: q_comp is {q_comp.dtype}, the tables {dtype}")
    return _DTYPE_CODE[dtype]


def _check_groups(name: str, p_q: int, p_x: int) -> None:
    if (p_q, p_x) not in SUPPORTED_GROUPS:
        raise NotImplementedError(
            f"{name}: (P_Q, P_X)=({p_q}, {p_x}) has no kernel instance; "
            f"supported: {SUPPORTED_GROUPS} (ROADMAP.md, Queue 1: K2 options)"
        )


def _launch_scores(name, q_comp, query_partial, item_comp_t, item_partial_t, weights,
                   temperature, tile_ids=None) -> torch.Tensor:
    """Validate and launch K2 (tile_ids None) or K10 on CUDA tensors."""
    b, p_q, d_p = q_comp.shape
    p_x, _, x = item_comp_t.shape
    l = p_q * p_x
    hd = weights.w1.shape[1]
    _check_groups(name, p_q, p_x)
    code = _check_instance(name, q_comp, item_comp_t)
    if item_partial_t.dtype != item_comp_t.dtype:
        raise ValueError(
            f"{name}: item_partial_t is {item_partial_t.dtype}, item_comp_t {item_comp_t.dtype}"
        )
    multiple = _TILE_X if tile_ids is None else BLOCK_X
    if (item_comp_t.shape[1] != d_p or tuple(item_partial_t.shape) != (l, x)
            or tuple(query_partial.shape) != (b, l) or x % multiple
            or tuple(weights.w1.shape) != (l, hd) or tuple(weights.w2.shape) != (hd, l)
            or tuple(weights.b1.shape) != (hd,) or tuple(weights.b2.shape) != (l,)):
        raise ValueError(
            f"{name}: shapes disagree: q_comp "
            f"{tuple(q_comp.shape)}, query_partial {tuple(query_partial.shape)}, "
            f"item_comp_t {tuple(item_comp_t.shape)}, item_partial_t "
            f"{tuple(item_partial_t.shape)}, w1 {tuple(weights.w1.shape)}, w2 "
            f"{tuple(weights.w2.shape)} (X must be a multiple of {multiple})"
        )
    if not (q_comp.is_contiguous() and item_comp_t.is_contiguous()
            and item_partial_t.is_contiguous()):
        raise ValueError(f"{name}: q_comp and the tables must be contiguous")
    if tile_ids is not None and (tile_ids.dtype != torch.int32 or tile_ids.dim() != 1
                                 or not tile_ids.is_contiguous()):
        raise ValueError(f"{name}: tile_ids must be a contiguous (T,) int32 tensor")
    lib = _build.load_library()
    smem = lib.rails_mol_scores_smem_bytes(code, p_q, p_x, d_p, hd)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: d_P={d_p}, H={hd} need {smem} B of shared memory")
    mlp = _mlp_dtype(item_comp_t)
    stream = torch.cuda.current_stream(q_comp.device).cuda_stream
    with torch.cuda.device(q_comp.device):
        w1t = weights.w1.to(mlp).float().T.contiguous()          # (H, L)
        w2 = weights.w2.to(mlp).float().contiguous()             # (H, L)
        b1 = weights.b1.float().contiguous()
        b2 = weights.b2.float().contiguous()
        qp = query_partial.float().contiguous()
        common = (w1t.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr())
        if tile_ids is None:
            out = torch.empty(b, x, dtype=torch.float32, device=q_comp.device)
            err = lib.rails_mol_scores(
                code, p_q, p_x, q_comp.data_ptr(), qp.data_ptr(), item_comp_t.data_ptr(),
                item_partial_t.data_ptr(), *common, out.data_ptr(), b, x, d_p, hd,
                1.0 / temperature, stream,
            )
        else:
            nt = tile_ids.shape[0]
            out = torch.empty(b, nt * BLOCK_X, dtype=torch.float32, device=q_comp.device)
            err = lib.rails_mol_scores_tiles(
                code, p_q, p_x, q_comp.data_ptr(), qp.data_ptr(), tile_ids.data_ptr(),
                item_comp_t.data_ptr(), item_partial_t.data_ptr(), *common, out.data_ptr(),
                b, x, nt, d_p, hd, 1.0 / temperature, stream,
            )
    _build.check(lib, err, name)
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
    out = _launch_scores("fused_mol_scores_t", q_comp, query_partial, item_comp_t,
                         item_partial_t, weights, temperature)
    fused_mol_scores_t.launches += 1
    return out


fused_mol_scores_t.launches = 0


def fused_mol_scores_tiles_reference(
    q_comp: torch.Tensor,          # (B, P_Q, d_P)
    query_partial: torch.Tensor,   # (B, L)
    tile_ids: torch.Tensor,        # (T,) int32 tile indices into X / BLOCK_X
    item_comp_t: torch.Tensor,     # (P_X, d_P, X), X a multiple of BLOCK_X
    item_partial_t: torch.Tensor,  # (L, X)
    weights: MoLKernelWeights,
    temperature: float,
) -> torch.Tensor:
    """Plain version of K10: K2's plain version over the listed tiles'
    columns; an out-of-range tile id gives NaN columns, as in the kernel."""
    x = item_comp_t.shape[2]
    if x % BLOCK_X:
        raise ValueError(f"fused_mol_scores_tiles: X={x} is not a multiple of {BLOCK_X}")
    tiles = tile_ids.long()
    valid = (tiles >= 0) & (tiles < x // BLOCK_X)
    cols = (tiles.clamp(0, x // BLOCK_X - 1)[:, None] * BLOCK_X
            + torch.arange(BLOCK_X, device=tiles.device)).reshape(-1)
    out = fused_mol_scores_t_reference(
        q_comp, query_partial, item_comp_t[:, :, cols], item_partial_t[:, cols], weights,
        temperature,
    )
    return torch.where(valid.repeat_interleave(BLOCK_X)[None, :], out, torch.nan)


def fused_mol_scores_tiles(
    q_comp: torch.Tensor,
    query_partial: torch.Tensor,
    tile_ids: torch.Tensor,
    item_comp_t: torch.Tensor,
    item_partial_t: torch.Tensor,
    weights: MoLKernelWeights,
    temperature: float,
) -> torch.Tensor:
    """(B, T * BLOCK_X) MoL scores of the listed corpus tiles only: output
    column s*256 + j is corpus column tile_ids[s]*256 + j. Duplicate ids are
    allowed. The kernel reads `tile_ids` on the device (no host sync); its
    grid is sized by T."""
    tensors = (q_comp, query_partial, tile_ids, item_comp_t, item_partial_t, *weights)
    if not use_kernel(*tensors):
        return fused_mol_scores_tiles_reference(
            q_comp, query_partial, tile_ids, item_comp_t, item_partial_t, weights, temperature
        )
    if tile_ids.numel() == 0 or q_comp.shape[0] == 0:
        return torch.empty(q_comp.shape[0], tile_ids.numel() * BLOCK_X, dtype=torch.float32,
                           device=q_comp.device)
    out = _launch_scores("fused_mol_scores_tiles", q_comp, query_partial, item_comp_t,
                         item_partial_t, weights, temperature, tile_ids=tile_ids)
    fused_mol_scores_tiles.launches += 1
    return out


fused_mol_scores_tiles.launches = 0


def _require_positive(temperature: float) -> None:
    if not temperature > 0:
        raise ValueError(f"the MoL score bounds need a positive temperature, got {temperature}")


def fused_mol_ub_t_reference(
    q_comp: torch.Tensor,          # (B, P_Q, d_P)
    item_comp_t: torch.Tensor,     # (P_X, d_P, X)
    temperature: float,
) -> torch.Tensor:
    """Plain version of K8: (B, X) max_l logit_l / T in f32."""
    _require_positive(temperature)
    q = q_comp.float()
    x = item_comp_t.shape[2]
    out = torch.empty(q.shape[0], x, dtype=torch.float32, device=q.device)
    for c in range(0, x, _REF_BOUND_COLS):
        lg = torch.einsum("bnd,mdx->bnmx", q, item_comp_t[:, :, c : c + _REF_BOUND_COLS].float())
        out[:, c : c + _REF_BOUND_COLS] = lg.amax(dim=(1, 2)) * (1.0 / temperature)
    return out


def fused_mol_group_block_max_reference(
    q_comp: torch.Tensor,          # (B, P_Q, d_P)
    item_comp_t: torch.Tensor,     # (P_X, d_P, X), X a multiple of BLOCK_X
    temperature: float,
) -> torch.Tensor:
    """Plain version of K9: (B, L, X / BLOCK_X) per-(group, tile) max
    logit / T in f32, rows l = n*P_X + m."""
    _require_positive(temperature)
    q = q_comp.float()
    b, p_q, _ = q.shape
    p_x, _, x = item_comp_t.shape
    if x % BLOCK_X:
        raise ValueError(f"fused_mol_group_block_max: X={x} is not a multiple of {BLOCK_X}")
    out = torch.empty(b, p_q * p_x, x // BLOCK_X, dtype=torch.float32, device=q.device)
    for c in range(0, x, _REF_BOUND_COLS):
        lg = torch.einsum("bnd,mdx->bnmx", q, item_comp_t[:, :, c : c + _REF_BOUND_COLS].float())
        nt = lg.shape[-1] // BLOCK_X
        t0 = c // BLOCK_X
        out[:, :, t0 : t0 + nt] = (
            lg.reshape(b, p_q * p_x, nt, BLOCK_X).amax(dim=-1) * (1.0 / temperature)
        )
    return out


def _launch_bounds(name: str, entry: str, q_comp: torch.Tensor, item_comp_t: torch.Tensor,
                   temperature: float, out_shape: tuple) -> torch.Tensor:
    """Validate and launch K8 or K9 on CUDA tensors."""
    b, p_q, d_p = q_comp.shape
    p_x, _, x = item_comp_t.shape
    _check_groups(name, p_q, p_x)
    code = _check_instance(name, q_comp, item_comp_t)
    if item_comp_t.shape[1] != d_p or x % BLOCK_X or d_p % 4:
        raise ValueError(
            f"{name}: shapes disagree: q_comp {tuple(q_comp.shape)}, item_comp_t "
            f"{tuple(item_comp_t.shape)} (X a multiple of {BLOCK_X}, d_P of 4)"
        )
    if not (q_comp.is_contiguous() and item_comp_t.is_contiguous()):
        raise ValueError(f"{name}: q_comp and item_comp_t must be contiguous")
    lib = _build.load_library()
    smem = lib.rails_mol_bounds_smem_bytes(p_q, p_x, d_p)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: d_P={d_p} needs {smem} B of shared memory")
    out = torch.empty(out_shape, dtype=torch.float32, device=q_comp.device)
    with torch.cuda.device(q_comp.device):
        err = getattr(lib, entry)(
            code, p_q, p_x, q_comp.data_ptr(), item_comp_t.data_ptr(), out.data_ptr(), b, x,
            d_p, 1.0 / temperature, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, name)
    return out


def fused_mol_ub_t(
    q_comp: torch.Tensor,
    item_comp_t: torch.Tensor,
    temperature: float,
) -> torch.Tensor:
    """(B, X_padded) upper bounds max_l logit_l / T of the MoL score against
    kernel-layout tables (K8); requires T > 0."""
    _require_positive(temperature)
    if not use_kernel(q_comp, item_comp_t):
        return fused_mol_ub_t_reference(q_comp, item_comp_t, temperature)
    b, x = q_comp.shape[0], item_comp_t.shape[2]
    if b == 0:
        return torch.empty(0, x, dtype=torch.float32, device=q_comp.device)
    out = _launch_bounds("fused_mol_ub_t", "rails_mol_ub", q_comp, item_comp_t, temperature,
                         (b, x))
    fused_mol_ub_t.launches += 1
    return out


fused_mol_ub_t.launches = 0


def fused_mol_group_block_max(
    q_comp: torch.Tensor,
    item_comp_t: torch.Tensor,
    temperature: float,
) -> torch.Tensor:
    """(B, L, X_padded / 256) per-group, per-tile logit maxima / T (K9), rows
    in the n-major order l = n*P_X + m; requires T > 0."""
    _require_positive(temperature)
    if not use_kernel(q_comp, item_comp_t):
        return fused_mol_group_block_max_reference(q_comp, item_comp_t, temperature)
    b, p_q, _ = q_comp.shape
    p_x, _, x = item_comp_t.shape
    if b == 0:
        return torch.empty(0, p_q * p_x, x // BLOCK_X, dtype=torch.float32,
                           device=q_comp.device)
    out = _launch_bounds("fused_mol_group_block_max", "rails_mol_group_block_max", q_comp,
                         item_comp_t, temperature, (b, p_q * p_x, x // BLOCK_X))
    fused_mol_group_block_max.launches += 1
    return out


fused_mol_group_block_max.launches = 0
