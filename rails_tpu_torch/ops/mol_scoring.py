"""Fused MoL corpus scoring (K2), its score bounds (K8, K9) and tile scoring
(K10): CUDA kernel wrappers + plain versions.

K2 replaces the Pallas kernel `fused_mol_scores_t`
(`rails_tpu/ops/pallas/mol_scoring.py:588-759`, body `_kernel` :53-182) for
f32, bf16 and int8 tables:

    logits[l = n*P_X + m] = <q_n, x_m> / T
    qi  = W2' silu(W1' logits + b1) + b2
    gi  = qp * ip + qi ;  gw = silu(gi)
    out = sum_l softmax_l(gw) * logits

Kernels (`csrc/mol_scoring.cu` launches both; no fallback between them):
bf16 and int8 tables at the geometries of `tc_route` run on the tensor cores
(`csrc/mol_scoring_tc.cuh`: mma.sync for the logits and both products of the
qi MLP, whose hidden layer never leaves registers; bound by the MUFU results
of its SiLUs and exps), f32 tables and synthetic-small's 4x2x16 on the CUDA
cores (`csrc/mol_scoring.cuh`, one block per (32 items x 32 queries)); each
source's header says what bounds it on an H100. The tensor-core logits are
one routine (`csrc/mol_tc_logits.cuh`) that K8 and K9 share. The logits stay in the
model's n-major order (the TPU kernel's m-major permutation is a VMEM layout
choice), so the tables are the model's tables transposed to (P_X, d_P, X)
and (L, X) and zero-padded to a multiple of `BLOCK_X` = 256 items, the JAX
build's `fused_block_x`
(`prepare_fused_tables`): a "tile" of K9, K10 and the tile methods is 256
contiguous corpus columns, the same columns as in the JAX package.

int8 tables (`quantize_fused_tables`, `mol_scoring.py:516-537`) hold
symmetric codes with a scale per (component, item), `comp_scale` (P_X, X),
and per item, `partial_scale` (1, X). Every kernel reads them as the JAX
kernels do: bf16 queries, raw = <q_n, code_m> in f32, then raw * cs[m, x],
then * 1/T; the gating partial is code * ps[x]; the MLP rounds to bf16, as
with bf16 tables. `emit_blockmax` (`:152-180,692-723`) makes K2 also return
the (B, X/256) per-tile maxima of its scores, with the columns whose `valid`
entry is 0 (mid-corpus id-0 rows, the pad tail) at -1e30 in both.

The approximate-retrieval kernels read the same tables:
  - K8 `fused_mol_ub_t` (`mol_scoring.py:375-448`, `_ub_kernel` :185-219):
    UB[b, x] = max_l logit_l(b, x), a sound upper bound on the MoL score (a
    softmax mixture of the logits); `csrc/mol_bounds.cu`.
  - K9 `fused_mol_group_block_max` (:263-368, `_group_block_max_kernel`
    :222-256): gmax[b, l, t] = max over 256-item tile t of logit_l, rows in
    the port's n-major order (the JAX rows are m-major); `csrc/mol_bounds.cu`.
    Pad columns count as logit 0 in the last tile, as in JAX.
    K8 and K9 on bf16 and int8 tables at the widths of `bounds_tc_route` run
    on the tensor cores with K2's logits routine, so where K2 takes its
    tensor-core route too, K8 is the max of K2's logits and K9's max over l
    is K8's per-tile max, bit for bit; f32 tables and 4x2x16 run the
    CUDA-core kernels, whose logits are those of K2's CUDA-core kernel.
  - K10 `fused_mol_scores_tiles` (:766-893): K2 over a list of tile ids (T,)
    int32 read on the device; output column s*256 + j is corpus column
    tile_ids[s]*256 + j. The kernel is K2's code with one indirection on the
    item tile, so its columns equal K2's bit for bit.

Every wrapper follows the port's dispatch rule: CPU tensors run its
`*_reference` plain version, CUDA tensors launch the kernel or raise. Each
counts its kernel launches in `.launches`, and the int8 (and K2's blockmax)
launches among them in `.int8_launches` (`.blockmax_launches`); K2, K8, K9
and K10 count their tensor-core launches in `.tc_launches`. The plain
versions walk the corpus in column chunks, so they stay within memory at a
million columns.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from rails_tpu_torch.core.device import use_kernel
from rails_tpu_torch.ops import _build
from rails_tpu_torch.ops.hstu_block import MAX_SMEM_BYTES

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# (P_Q, P_X) geometries the kernels are instantiated for: ML-1M/ML-20M, the
# synthetic-small test config and Amazon Books (8x8x32).
SUPPORTED_GROUPS = ((8, 4), (4, 2), (8, 8))
BLOCK_X = 256         # corpus padding multiple; the tile of K9, K10 and blockmax
_TILE_X = 32          # items per K2 block (`kTileX` in csrc/mol_scoring.cu)
_REF_CHUNK = 64       # queries per step of the K2/K10 plain version
_REF_COLS = 8192      # corpus columns per step of the K2/K10 plain version
_REF_BOUND_COLS = 65_536   # corpus columns per step of the K8/K9 plain versions
_QUANT_COLS = 262_144      # corpus columns per step of `quantize_fused_tables`
MASKED_SCORE = -1.0e30     # K2's score of a column with valid == 0 (emit_blockmax)


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
    """Kernel-layout corpus tables, padded to a multiple of `BLOCK_X` items;
    int8 tables carry their f32 scales (`quantize_fused_tables`)."""

    item_comp_t: torch.Tensor      # (P_X, d_P, X_padded) f32, bf16 or int8
    item_partial_t: torch.Tensor   # (L, X_padded), n-major logit order
    num_items: int                 # unpadded X
    comp_scale: Optional[torch.Tensor] = None      # (P_X, X_padded) f32, int8 tables
    partial_scale: Optional[torch.Tensor] = None   # (1, X_padded) f32, int8 tables


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


def quantize_columns(
    comp_t: torch.Tensor,      # (P_X, d_P, C) kernel-layout component columns
    partial_t: torch.Tensor,   # (L, C) gating-partial columns
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes and f32 scales of some corpus columns
    (`quantize_fused_tables`, `mol_scoring.py:516-537`): cs = max(max |comp|
    over d_P, 1e-12) / 127 per (component, item), ps = max(max |partial| over
    L, 1e-12) / 127 per item, codes round(v / scale) half to even, clipped to
    +-127. Every scale belongs to one column, so quantizing a corpus chunk by
    chunk gives the same bytes as quantizing it whole; a zero column keeps
    codes 0 and the scale 1e-12 / 127."""
    comp = comp_t.float()
    part = partial_t.float()
    cs = comp.abs().amax(dim=1).clamp_min(1e-12) / 127.0               # (P_X, C)
    ps = part.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) / 127.0  # (1, C)
    comp_q = torch.round(comp / cs[:, None, :]).clamp_(-127, 127).to(torch.int8)
    part_q = torch.round(part / ps).clamp_(-127, 127).to(torch.int8)
    return comp_q, part_q, cs, ps


def quantize_fused_tables(tables: FusedCorpusTables) -> FusedCorpusTables:
    """int8 kernel-layout tables with their scales (`quantize_columns`),
    `_QUANT_COLS` columns at a time so that no full-size f32 copy exists."""
    p_x, d_p, x = tables.item_comp_t.shape
    dev = tables.item_comp_t.device
    comp_q = torch.empty(p_x, d_p, x, dtype=torch.int8, device=dev)
    part_q = torch.empty(tables.item_partial_t.shape, dtype=torch.int8, device=dev)
    cs = torch.empty(p_x, x, dtype=torch.float32, device=dev)
    ps = torch.empty(1, x, dtype=torch.float32, device=dev)
    for c in range(0, x, _QUANT_COLS):
        cols = slice(c, c + _QUANT_COLS)
        comp_q[:, :, cols], part_q[:, cols], cs[:, cols], ps[:, cols] = quantize_columns(
            tables.item_comp_t[:, :, cols], tables.item_partial_t[:, cols])
    return FusedCorpusTables(comp_q, part_q, tables.num_items, cs, ps)


def query_dtype(table_dtype: torch.dtype) -> torch.dtype:
    """The dtype of the query components the kernels take against tables of
    `table_dtype`: bf16 for int8 tables (`top_k.py:675-680`), else the same."""
    return torch.bfloat16 if table_dtype == torch.int8 else table_dtype


def _mlp_dtype(item_comp_t: torch.Tensor) -> torch.dtype:
    # The gating MLP runs on bf16 inputs with bf16 and int8 tables
    # (`mol_scoring.py:634-642`).
    return torch.float32 if item_comp_t.dtype == torch.float32 else torch.bfloat16


def _quantized(name: str, item_comp_t: torch.Tensor, comp_scale, partial_scale=None,
               need_partial: bool = True) -> bool:
    """Whether the tables are int8; raises when an int8 table's scale is
    missing (the JAX wrappers assert, `mol_scoring.py:629-633`)."""
    if item_comp_t.dtype != torch.int8:
        return False
    if comp_scale is None or (need_partial and partial_scale is None):
        raise ValueError(f"{name}: int8 tables need comp_scale"
                         + (" and partial_scale" if need_partial else "")
                         + " (quantize_fused_tables)")
    return True


def _valid_columns(valid: torch.Tensor, x: int) -> torch.Tensor:
    """`valid` as a contiguous f32 (x,) vector, zero-padded past its length."""
    v = valid.reshape(-1).float()
    if v.shape[0] > x:
        raise ValueError(f"valid has {v.shape[0]} entries for {x} corpus columns")
    return F.pad(v, (0, x - v.shape[0])).contiguous()


def fused_mol_scores_t_reference(
    q_comp: torch.Tensor,          # (B, P_Q, d_P), `query_dtype` of the tables
    query_partial: torch.Tensor,   # (B, L)
    item_comp_t: torch.Tensor,     # (P_X, d_P, X) kernel layout, X padded
    item_partial_t: torch.Tensor,  # (L, X)
    weights: MoLKernelWeights,
    temperature: float,
    comp_scale: Optional[torch.Tensor] = None,     # (P_X, X) f32, int8 tables
    partial_scale: Optional[torch.Tensor] = None,  # (1, X) f32, int8 tables
    emit_blockmax: bool = False,
    valid: Optional[torch.Tensor] = None,          # (<= X,) nonzero = real column
):
    """Plain PyTorch version of the kernel: (B, X) f32 scores, with the
    kernel's bf16 rounding points and int8 scaling order, `_REF_CHUNK`
    queries by `_REF_COLS` columns at a time; with `emit_blockmax`, the
    scores with invalid columns at -1e30 and their (B, X / 256) tile maxima."""
    quant = _quantized("fused_mol_scores_t", item_comp_t, comp_scale, partial_scale)
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
        if quant:
            cs = comp_scale[:, c : c + _REF_COLS].T                        # (C, P_X)
            ip = ip * partial_scale[0, c : c + _REF_COLS, None]
        for s in range(0, b, _REF_CHUNK):
            q = q_comp[s : s + _REF_CHUNK].float()
            logits = torch.einsum("bnd,mdx->bxnm", q, items)
            if quant:
                logits = logits * cs[None, :, None, :]
            logits = logits.reshape(q.shape[0], ip.shape[0], p_q * p_x) * (1.0 / temperature)
            h = logits.to(mlp).float() @ w1 + b1
            h = h * torch.sigmoid(h)
            qi = h.to(mlp).float() @ w2 + b2
            gi = query_partial[s : s + _REF_CHUNK, None, :].float() * ip[None] + qi
            gw = gi * torch.sigmoid(gi)
            e = torch.exp(gw - gw.amax(dim=-1, keepdim=True))
            out[s : s + _REF_CHUNK, c : c + _REF_COLS] = (e * logits).sum(dim=-1) / e.sum(dim=-1)
    if not emit_blockmax:
        return out
    _check_blockmax(valid, x)
    out = torch.where(_valid_columns(valid, x) != 0, out, MASKED_SCORE)
    return out, out.reshape(b, x // BLOCK_X, BLOCK_X).amax(dim=2)


def _check_blockmax(valid, x: int) -> None:
    if valid is None:
        raise ValueError("emit_blockmax requires the valid vector")
    if x % BLOCK_X:
        raise ValueError(f"emit_blockmax: X={x} is not a multiple of {BLOCK_X}")


def _check_instance(name: str, q_comp: torch.Tensor, item_comp_t: torch.Tensor,
                    scales: tuple) -> int:
    """The table dtypes every kernel of this module takes, the query dtype
    that goes with them, and an int8 table's scales. Returns the dtype code."""
    dtype = item_comp_t.dtype
    if dtype not in _DTYPE_CODE:
        raise NotImplementedError(
            f"{name}: {dtype} tables have no kernel instance (float32, bfloat16, int8)"
        )
    if q_comp.dtype != query_dtype(dtype):
        raise ValueError(f"{name}: q_comp is {q_comp.dtype}; {dtype} tables take "
                         f"{query_dtype(dtype)} queries")
    x = item_comp_t.shape[2]
    if dtype == torch.int8:
        for scale, rows in scales:
            if (scale.dtype != torch.float32 or tuple(scale.shape) != (rows, x)
                    or not scale.is_contiguous()):
                raise ValueError(f"{name}: an int8 table's scales are contiguous f32 "
                                 f"({rows}, {x}); got {scale.dtype} {tuple(scale.shape)}")
    return _DTYPE_CODE[dtype]


def _check_groups(name: str, p_q: int, p_x: int) -> None:
    if (p_q, p_x) not in SUPPORTED_GROUPS:
        raise NotImplementedError(
            f"{name}: (P_Q, P_X)=({p_q}, {p_x}) has no kernel instance; "
            f"supported: {SUPPORTED_GROUPS} (ROADMAP.md, Queue 1: other geometries)"
        )


def bounds_tc_route(dtype: torch.dtype, p_q: int, p_x: int, d_p: int) -> bool:
    """The width rule of the tensor-core logits routine
    (`csrc/mol_tc_logits.cuh`, `logits_ok`), which K8 and K9 take
    (`mol_bounds_tc_kernel` in csrc/mol_bounds.cu): bf16 and int8 tables
    (int8 codes convert exactly to bf16), P_Q = 8 (a query's components are
    one n8 tile of the logits' product), P_X 4 or 8, d_P a multiple of 16
    (whole k16 steps) with P_X * d_P <= 512 (the staged item tiles and the
    queries fit shared memory). ML-20M's 8x4x128, ML-1M's 8x4x64 and Amazon
    Books' 8x8x32 take it. f32 tables stay on the CUDA-core kernels: K2's f32
    logits are CUDA-core f32 sums, and a tensor-core f32 product rounds its
    operands to TF32. synthetic-small's 4x2x16 stays as well (P_Q = 4 fills
    half an n8 tile)."""
    return (dtype in (torch.bfloat16, torch.int8) and p_q == 8 and p_x in (4, 8)
            and d_p >= 16 and d_p % 16 == 0 and p_x * d_p <= 512)


def tc_route(dtype: torch.dtype, p_q: int, p_x: int, d_p: int, hd: int) -> bool:
    """The width rule of K2's tensor-core kernel (`tc_ok` in
    csrc/mol_scoring_tc.cuh), which K10 and the probe P2 share:
    `bounds_tc_route`'s tables and widths, whose logits routine it runs (so
    K8's and K9's bounds are maxima of its logits bit for bit), and H a
    multiple of 16 up to 256 (whole k16 and n8 steps of the qi MLP; the
    staged weights fit shared memory). ML-20M's 8x4x128, ML-1M's 8x4x64 and
    Amazon Books' 8x8x32 at H = 128 take it, with bf16 or int8 tables. f32
    tables stay on the CUDA-core kernel: K2_TOL_F32 holds it to the plain f32
    path. Where H alone keeps K2 off the tensor cores, K8 and K9 still take
    them, and K8 bounds K2's scores within the certificate's margin
    (`index/top_k.py`, `_CERT_REL_MARGIN`) rather than bit for bit."""
    return bounds_tc_route(dtype, p_q, p_x, d_p) and 16 <= hd <= 256 and hd % 16 == 0


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch_scores(name, q_comp, query_partial, item_comp_t, item_partial_t, weights,
                   temperature, comp_scale, partial_scale, tile_ids=None, valid=None):
    """Validate and launch K2 (tile_ids None; with `valid`, emit_blockmax) or
    K10 on CUDA tensors. Returns (the scores, or (scores, tile maxima); 1 if
    the tensor-core kernel ran, else 0)."""
    b, p_q, d_p = q_comp.shape
    p_x, _, x = item_comp_t.shape
    l = p_q * p_x
    hd = weights.w1.shape[1]
    _check_groups(name, p_q, p_x)
    quant = item_comp_t.dtype == torch.int8
    code = _check_instance(name, q_comp, item_comp_t,
                           ((comp_scale, p_x), (partial_scale, 1)) if quant else ())
    if item_partial_t.dtype != item_comp_t.dtype:
        raise ValueError(
            f"{name}: item_partial_t is {item_partial_t.dtype}, item_comp_t {item_comp_t.dtype}"
        )
    multiple = _TILE_X if tile_ids is None and valid is None else BLOCK_X
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
    tc = int(tc_route(item_comp_t.dtype, p_q, p_x, d_p, hd))
    lib = _build.load_library()
    smem = lib.rails_mol_scores_smem_bytes(tc, code, p_q, p_x, d_p, hd)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: d_P={d_p}, H={hd} need {smem} B of shared memory")
    mlp = _mlp_dtype(item_comp_t)
    cs, ps = (comp_scale, partial_scale) if quant else (None, None)
    stream = torch.cuda.current_stream(q_comp.device).cuda_stream
    with torch.cuda.device(q_comp.device):
        w1t = weights.w1.to(mlp).float().T.contiguous()          # (H, L)
        w2 = weights.w2.to(mlp).float().contiguous()             # (H, L)
        b1 = weights.b1.float().contiguous()
        b2 = weights.b2.float().contiguous()
        qp = query_partial.float().contiguous()
        common = (_ptr(cs), _ptr(ps), w1t.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                  b2.data_ptr())
        tile_max = None
        if tile_ids is None:
            out = torch.empty(b, x, dtype=torch.float32, device=q_comp.device)
            if valid is not None:
                valid = _valid_columns(valid, x)
                tile_max = torch.full((b, x // BLOCK_X), MASKED_SCORE, dtype=torch.float32,
                                      device=q_comp.device)
            err = lib.rails_mol_scores(
                tc, code, p_q, p_x, q_comp.data_ptr(), qp.data_ptr(), item_comp_t.data_ptr(),
                item_partial_t.data_ptr(), *common, _ptr(valid), out.data_ptr(),
                _ptr(tile_max), b, x, d_p, hd, 1.0 / temperature, stream,
            )
        else:
            nt = tile_ids.shape[0]
            out = torch.empty(b, nt * BLOCK_X, dtype=torch.float32, device=q_comp.device)
            err = lib.rails_mol_scores_tiles(
                tc, code, p_q, p_x, q_comp.data_ptr(), qp.data_ptr(), tile_ids.data_ptr(),
                item_comp_t.data_ptr(), item_partial_t.data_ptr(), *common, out.data_ptr(),
                b, x, nt, d_p, hd, 1.0 / temperature, stream,
            )
    _build.check(lib, err, name)
    return (out if tile_max is None else (out, tile_max)), tc


def fused_mol_scores_t(
    q_comp: torch.Tensor,
    query_partial: torch.Tensor,
    item_comp_t: torch.Tensor,
    item_partial_t: torch.Tensor,
    weights: MoLKernelWeights,
    temperature: float,
    comp_scale: Optional[torch.Tensor] = None,
    partial_scale: Optional[torch.Tensor] = None,
    emit_blockmax: bool = False,
    valid: Optional[torch.Tensor] = None,
):
    """(B, X_padded) MoL scores against kernel-layout tables; callers slice
    the pad columns off (`top_k.py:695`). With `emit_blockmax`, returns
    (scores, tile_max): columns whose `valid` entry is 0 (a shorter `valid`
    counts as 0 past its end) score -1e30, and tile_max (B, X_padded / 256)
    holds the maxima of those scores, computed while the scores are live."""
    scales = (comp_scale, partial_scale)
    tensors = (q_comp, query_partial, item_comp_t, item_partial_t, *weights,
               *(t for t in (*scales, valid) if t is not None))
    quant = _quantized("fused_mol_scores_t", item_comp_t, *scales)
    if emit_blockmax:
        _check_blockmax(valid, item_comp_t.shape[2])
    if not use_kernel(*tensors):
        return fused_mol_scores_t_reference(
            q_comp, query_partial, item_comp_t, item_partial_t, weights, temperature,
            *scales, emit_blockmax, valid,
        )
    out, tc = _launch_scores("fused_mol_scores_t", q_comp, query_partial, item_comp_t,
                             item_partial_t, weights, temperature, *scales,
                             valid=valid if emit_blockmax else None)
    fused_mol_scores_t.launches += 1
    fused_mol_scores_t.int8_launches += quant
    fused_mol_scores_t.blockmax_launches += emit_blockmax
    fused_mol_scores_t.tc_launches += tc
    return out


fused_mol_scores_t.launches = 0
fused_mol_scores_t.int8_launches = 0
fused_mol_scores_t.blockmax_launches = 0
fused_mol_scores_t.tc_launches = 0


def fused_mol_scores_tiles_reference(
    q_comp: torch.Tensor,          # (B, P_Q, d_P)
    query_partial: torch.Tensor,   # (B, L)
    tile_ids: torch.Tensor,        # (T,) int32 tile indices into X / BLOCK_X
    item_comp_t: torch.Tensor,     # (P_X, d_P, X), X a multiple of BLOCK_X
    item_partial_t: torch.Tensor,  # (L, X)
    weights: MoLKernelWeights,
    temperature: float,
    comp_scale: Optional[torch.Tensor] = None,
    partial_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of K10: K2's plain version over the listed tiles'
    columns; an out-of-range tile id gives NaN columns, as in the kernel."""
    x = item_comp_t.shape[2]
    if x % BLOCK_X:
        raise ValueError(f"fused_mol_scores_tiles: X={x} is not a multiple of {BLOCK_X}")
    quant = _quantized("fused_mol_scores_tiles", item_comp_t, comp_scale, partial_scale)
    tiles = tile_ids.long()
    valid = (tiles >= 0) & (tiles < x // BLOCK_X)
    cols = (tiles.clamp(0, x // BLOCK_X - 1)[:, None] * BLOCK_X
            + torch.arange(BLOCK_X, device=tiles.device)).reshape(-1)
    scales = (comp_scale[:, cols], partial_scale[:, cols]) if quant else (None, None)
    out = fused_mol_scores_t_reference(
        q_comp, query_partial, item_comp_t[:, :, cols], item_partial_t[:, cols], weights,
        temperature, *scales,
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
    comp_scale: Optional[torch.Tensor] = None,
    partial_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, T * BLOCK_X) MoL scores of the listed corpus tiles only: output
    column s*256 + j is corpus column tile_ids[s]*256 + j. Duplicate ids are
    allowed. The kernel reads `tile_ids` on the device (no host sync); its
    grid is sized by T."""
    scales = (comp_scale, partial_scale)
    tensors = (q_comp, query_partial, tile_ids, item_comp_t, item_partial_t, *weights,
               *(t for t in scales if t is not None))
    quant = _quantized("fused_mol_scores_tiles", item_comp_t, *scales)
    if not use_kernel(*tensors):
        return fused_mol_scores_tiles_reference(
            q_comp, query_partial, tile_ids, item_comp_t, item_partial_t, weights, temperature,
            *scales,
        )
    if tile_ids.numel() == 0 or q_comp.shape[0] == 0:
        return torch.empty(q_comp.shape[0], tile_ids.numel() * BLOCK_X, dtype=torch.float32,
                           device=q_comp.device)
    out, tc = _launch_scores("fused_mol_scores_tiles", q_comp, query_partial, item_comp_t,
                             item_partial_t, weights, temperature, *scales, tile_ids=tile_ids)
    fused_mol_scores_tiles.launches += 1
    fused_mol_scores_tiles.int8_launches += quant
    fused_mol_scores_tiles.tc_launches += tc
    return out


fused_mol_scores_tiles.launches = 0
fused_mol_scores_tiles.int8_launches = 0
fused_mol_scores_tiles.tc_launches = 0


def _require_positive(temperature: float) -> None:
    if not temperature > 0:
        raise ValueError(f"the MoL score bounds need a positive temperature, got {temperature}")


def _chunk_logits(q: torch.Tensor, item_comp_t: torch.Tensor, comp_scale, c: int) -> torch.Tensor:
    """(B, P_Q, P_X, C) raw logits of corpus columns [c, c + C), times an
    int8 table's component scales."""
    cols = slice(c, c + _REF_BOUND_COLS)
    lg = torch.einsum("bnd,mdx->bnmx", q, item_comp_t[:, :, cols].float())
    return lg if comp_scale is None else lg * comp_scale[None, None, :, cols]


def fused_mol_ub_t_reference(
    q_comp: torch.Tensor,          # (B, P_Q, d_P)
    item_comp_t: torch.Tensor,     # (P_X, d_P, X)
    temperature: float,
    comp_scale: Optional[torch.Tensor] = None,   # (P_X, X) f32, int8 tables
) -> torch.Tensor:
    """Plain version of K8: (B, X) max_l logit_l / T in f32."""
    _require_positive(temperature)
    if not _quantized("fused_mol_ub_t", item_comp_t, comp_scale, need_partial=False):
        comp_scale = None
    q = q_comp.float()
    x = item_comp_t.shape[2]
    out = torch.empty(q.shape[0], x, dtype=torch.float32, device=q.device)
    for c in range(0, x, _REF_BOUND_COLS):
        lg = _chunk_logits(q, item_comp_t, comp_scale, c)
        out[:, c : c + _REF_BOUND_COLS] = lg.amax(dim=(1, 2)) * (1.0 / temperature)
    return out


def fused_mol_group_block_max_reference(
    q_comp: torch.Tensor,          # (B, P_Q, d_P)
    item_comp_t: torch.Tensor,     # (P_X, d_P, X), X a multiple of BLOCK_X
    temperature: float,
    comp_scale: Optional[torch.Tensor] = None,   # (P_X, X) f32, int8 tables
) -> torch.Tensor:
    """Plain version of K9: (B, L, X / BLOCK_X) per-(group, tile) max
    logit / T in f32, rows l = n*P_X + m."""
    _require_positive(temperature)
    if not _quantized("fused_mol_group_block_max", item_comp_t, comp_scale,
                      need_partial=False):
        comp_scale = None
    q = q_comp.float()
    b, p_q, _ = q.shape
    p_x, _, x = item_comp_t.shape
    if x % BLOCK_X:
        raise ValueError(f"fused_mol_group_block_max: X={x} is not a multiple of {BLOCK_X}")
    out = torch.empty(b, p_q * p_x, x // BLOCK_X, dtype=torch.float32, device=q.device)
    for c in range(0, x, _REF_BOUND_COLS):
        lg = _chunk_logits(q, item_comp_t, comp_scale, c)
        nt = lg.shape[-1] // BLOCK_X
        t0 = c // BLOCK_X
        out[:, :, t0 : t0 + nt] = (
            lg.reshape(b, p_q * p_x, nt, BLOCK_X).amax(dim=-1) * (1.0 / temperature)
        )
    return out


def _launch_bounds(name: str, entry: str, q_comp: torch.Tensor, item_comp_t: torch.Tensor,
                   comp_scale, temperature: float, out_shape: tuple):
    """Validate and launch K8 or K9 on CUDA tensors. Returns (the output; 1 if
    the tensor-core kernel ran, else 0)."""
    b, p_q, d_p = q_comp.shape
    p_x, _, x = item_comp_t.shape
    _check_groups(name, p_q, p_x)
    quant = item_comp_t.dtype == torch.int8
    code = _check_instance(name, q_comp, item_comp_t, ((comp_scale, p_x),) if quant else ())
    if item_comp_t.shape[1] != d_p or x % BLOCK_X or d_p % 4:
        raise ValueError(
            f"{name}: shapes disagree: q_comp {tuple(q_comp.shape)}, item_comp_t "
            f"{tuple(item_comp_t.shape)} (X a multiple of {BLOCK_X}, d_P of 4)"
        )
    if not (q_comp.is_contiguous() and item_comp_t.is_contiguous()):
        raise ValueError(f"{name}: q_comp and item_comp_t must be contiguous")
    tc = int(bounds_tc_route(item_comp_t.dtype, p_q, p_x, d_p))
    lib = _build.load_library()
    smem = lib.rails_mol_bounds_smem_bytes(tc, p_q, p_x, d_p)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: d_P={d_p} needs {smem} B of shared memory")
    out = torch.empty(out_shape, dtype=torch.float32, device=q_comp.device)
    with torch.cuda.device(q_comp.device):
        err = getattr(lib, entry)(
            tc, code, p_q, p_x, q_comp.data_ptr(), item_comp_t.data_ptr(),
            _ptr(comp_scale if quant else None), out.data_ptr(), b, x, d_p, 1.0 / temperature,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, name)
    return out, tc


def fused_mol_ub_t(
    q_comp: torch.Tensor,
    item_comp_t: torch.Tensor,
    temperature: float,
    comp_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, X_padded) upper bounds max_l logit_l / T of the MoL score against
    kernel-layout tables (K8); requires T > 0."""
    _require_positive(temperature)
    quant = _quantized("fused_mol_ub_t", item_comp_t, comp_scale, need_partial=False)
    scale = (comp_scale,) if comp_scale is not None else ()
    if not use_kernel(q_comp, item_comp_t, *scale):
        return fused_mol_ub_t_reference(q_comp, item_comp_t, temperature, comp_scale)
    b, x = q_comp.shape[0], item_comp_t.shape[2]
    if b == 0:
        return torch.empty(0, x, dtype=torch.float32, device=q_comp.device)
    out, tc = _launch_bounds("fused_mol_ub_t", "rails_mol_ub", q_comp, item_comp_t, comp_scale,
                             temperature, (b, x))
    fused_mol_ub_t.launches += 1
    fused_mol_ub_t.int8_launches += quant
    fused_mol_ub_t.tc_launches += tc
    return out


fused_mol_ub_t.launches = 0
fused_mol_ub_t.int8_launches = 0
fused_mol_ub_t.tc_launches = 0


def fused_mol_group_block_max(
    q_comp: torch.Tensor,
    item_comp_t: torch.Tensor,
    temperature: float,
    comp_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, L, X_padded / 256) per-group, per-tile logit maxima / T (K9), rows
    in the n-major order l = n*P_X + m; requires T > 0."""
    _require_positive(temperature)
    quant = _quantized("fused_mol_group_block_max", item_comp_t, comp_scale, need_partial=False)
    scale = (comp_scale,) if comp_scale is not None else ()
    if not use_kernel(q_comp, item_comp_t, *scale):
        return fused_mol_group_block_max_reference(q_comp, item_comp_t, temperature, comp_scale)
    b, p_q, _ = q_comp.shape
    p_x, _, x = item_comp_t.shape
    if b == 0:
        return torch.empty(0, p_q * p_x, x // BLOCK_X, dtype=torch.float32,
                           device=q_comp.device)
    out, tc = _launch_bounds("fused_mol_group_block_max", "rails_mol_group_block_max", q_comp,
                             item_comp_t, comp_scale, temperature,
                             (b, p_q * p_x, x // BLOCK_X))
    fused_mol_group_block_max.launches += 1
    fused_mol_group_block_max.int8_launches += quant
    fused_mol_group_block_max.tc_launches += tc
    return out


fused_mol_group_block_max.launches = 0
fused_mol_group_block_max.int8_launches = 0
fused_mol_group_block_max.tc_launches = 0
