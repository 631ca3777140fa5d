"""Binned row scatter-add for embedding-table gradients (K6): CUDA kernel +
plain version, and the gather whose backward it is.

Replaces `scatter_add_rows` (`rails_tpu/ops/pallas/scatter_add.py:84-194`,
`pallas_call` :172, body `_kernel` :35-81) and the `gather_rows` custom VJP
(:197-216): `zeros((num_rows, D)).at[ids].add(rows)` accumulated in f32 and
cast to `out_dtype`. Negative ids wrap once (+ num_rows); ids still out of
range are dropped; duplicates sum in f32.

On CUDA tensors the wrapper allocates the table and one scratch buffer
(`scratch_layout`) with `torch.empty` and makes one call into
`csrc/scatter_add.cu`, whose header gives the bound and the design: the id
wrap, the per-row counts, their scan, the placement of each update and the
sums, written in `out_dtype`, all run on the card with no torch sort, search
or scan and no host sync. Each row sums its updates in increasing index
order (no floating-point atomics), so two calls give the same bits. The lane
packing for D < 128 (`scatter_add.py:106-141`) is a TPU layout workaround;
here a row of D = 64 takes 16 lanes of a warp (`lanes_per_row`).

`scatter_add_rows` follows the port's dispatch rule (`core.device.use_kernel`):
CPU tensors run `scatter_add_rows_reference` (`index_put_` with accumulate),
CUDA tensors launch the kernel or raise. `scatter_add_rows.launches` counts
calls of the kernel's entry point. `gather_rows(table, ids)` is `table[ids]`
whose backward is `scatter_add_rows`.
"""

from __future__ import annotations

from typing import Optional

import torch

from rails_tpu_torch.core.device import use_kernel
from rails_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ID_CODE = {torch.int32: 0, torch.int64: 1}
# The kernel's constants (`csrc/scatter_add.cu`): a row of more than SHORT
# updates is a long row, summed in pieces of PIECE updates and ranked in
# chunks of RANK_CHUNK ids; the scan takes tiles of SCAN_TILE rows.
SHORT, PIECE, SCAN_TILE, RANK_CHUNK = 32, 128, 4096, 4096
# Scratch parts in layout order; those up to "cnt" are zeroed by the kernel's
# memset.
_SCRATCH_PARTS = ("status", "chunk_cnt", "counters", "done", "cnt", "wid", "start", "slots",
                  "rank", "long_row", "piece_base", "piece_row", "partial")


def scratch_layout(m: int, num_rows: int, d: int) -> dict:
    """The kernel's scratch for m ids into (num_rows, d): byte offsets of
    each part (16-byte aligned) in one buffer of `bytes`, the `zero_bytes`
    the kernel clears from its start, and the grid bounds `max_long` (rows
    of more than SHORT updates), `max_pieces` (their pieces) and `chunks`
    (of RANK_CHUNK ids, counted per long row)."""
    max_long = m // (SHORT + 1)
    max_pieces = m // PIECE + max_long
    chunks = -(-m // RANK_CHUNK)
    sizes = dict(status=8 * (num_rows // SCAN_TILE + 1), chunk_cnt=4 * max_long * chunks,
                 counters=16, done=4 * max_long, cnt=4 * num_rows, wid=4 * m,
                 start=4 * (num_rows + 1), slots=4 * m, rank=4 * m, long_row=4 * max_long,
                 piece_base=4 * max_long, piece_row=4 * max_pieces, partial=4 * max_pieces * d)
    offsets, at = {}, 0
    for name in _SCRATCH_PARTS:
        offsets[name] = at
        at += -(-sizes[name] // 16) * 16
    return dict(offsets=offsets, bytes=at, zero_bytes=offsets["wid"], max_long=max_long,
                max_pieces=max_pieces, chunks=chunks)


def lanes_per_row(d: int, vec: int) -> int:
    """Lanes of a warp that sum one short row of d columns, `vec` per lane:
    the power of two covering d / vec, between 4 and 32."""
    need = -(-d // vec)
    return min(32, max(4, 1 << (need - 1).bit_length()))


def _wrapped_ids(ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Flat int64 ids, negatives wrapped once; out-of-range ids -> num_rows."""
    flat = ids.reshape(-1).long()
    flat = torch.where(flat < 0, flat + num_rows, flat)
    return torch.where((flat >= 0) & (flat < num_rows), flat, torch.full_like(flat, num_rows))


def scatter_add_rows_reference(
    ids: torch.Tensor, rows: torch.Tensor, num_rows: int,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version: (num_rows, D) in `out_dtype` (default rows.dtype)."""
    d = rows.shape[-1]
    flat = _wrapped_ids(ids, num_rows)
    keep = flat < num_rows
    out = torch.zeros(num_rows, d, dtype=torch.float32, device=rows.device)
    out.index_put_((flat[keep],), rows.reshape(-1, d)[keep].float(), accumulate=True)
    return out.to(out_dtype or rows.dtype)


def scatter_add_rows(
    ids: torch.Tensor, rows: torch.Tensor, num_rows: int,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """`zeros((num_rows, D)).at[ids].add(rows)`; ids any shape, rows
    ids.shape + (D,) in f32 or bf16. Same arguments as the plain version."""
    if not use_kernel(ids, rows):
        return scatter_add_rows_reference(ids, rows, num_rows, out_dtype)
    d = rows.shape[-1]
    if rows.dtype not in _DTYPE_CODE:
        raise ValueError(f"scatter_add_rows: rows must be float32 or bfloat16; got {rows.dtype}")
    if rows.numel() != ids.numel() * d:
        raise ValueError(f"scatter_add_rows: rows {tuple(rows.shape)} do not match ids "
                         f"{tuple(ids.shape)}")
    out_dtype = out_dtype or rows.dtype
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"scatter_add_rows: out_dtype must be float32 or bfloat16; "
                         f"got {out_dtype}")
    if max(ids.numel(), num_rows) >= 2**31 - 1:
        raise ValueError("scatter_add_rows: the kernel indexes ids and rows in int32")
    dev = rows.device
    if num_rows <= 0:
        return torch.empty(0, d, dtype=out_dtype, device=dev)
    flat = ids.reshape(-1)
    if flat.dtype not in _ID_CODE:
        flat = flat.long()
    src = rows.reshape(-1, d).contiguous()
    m = flat.numel()
    lay = scratch_layout(m, num_rows, d)
    out = torch.empty(num_rows, d, dtype=out_dtype, device=dev)
    scratch = torch.empty(lay["bytes"], dtype=torch.uint8, device=dev)
    vec = 4 if d % 4 == 0 and src.data_ptr() % (4 * src.element_size()) == 0 else 1
    base, off = scratch.data_ptr(), lay["offsets"]
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.rails_scatter_add_rows(
            _ID_CODE[flat.dtype], _DTYPE_CODE[rows.dtype], _DTYPE_CODE[out_dtype],
            flat.data_ptr(), src.data_ptr(), out.data_ptr(), m, num_rows, d, vec,
            lanes_per_row(d, vec), lay["max_long"], lay["max_pieces"], lay["chunks"],
            base + off["status"],
            lay["zero_bytes"], *(base + off[k] for k in _SCRATCH_PARTS[1:]),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "scatter_add_rows")
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0


class GatherRows(torch.autograd.Function):
    """`table[ids]` with the gradient of `table` from `scatter_add_rows`."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows, ctx.dtype = table.shape[0], table.dtype
        return table[ids.long()]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return scatter_add_rows(ids, g, ctx.num_rows, out_dtype=ctx.dtype), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]` whose backward is the binned scatter-add (`gather_rows`)."""
    return GatherRows.apply(table, ids)
