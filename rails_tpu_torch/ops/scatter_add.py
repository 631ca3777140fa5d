"""Binned row scatter-add for embedding-table gradients (K6): CUDA kernel +
plain version, and the gather whose backward it is.

Replaces `scatter_add_rows` (`rails_tpu/ops/pallas/scatter_add.py:84-194`,
`pallas_call` :172, body `_kernel` :35-81) and the `gather_rows` custom VJP
(:197-216): `zeros((num_rows, D)).at[ids].add(rows)` accumulated in f32 and
cast to `out_dtype`. Negative ids wrap once (+ num_rows); ids still out of
range are dropped; duplicates sum in f32.

The kernel (`csrc/scatter_add.cu`; its header gives the bound and the design)
takes the update rows in id order: the wrapper sorts the wrapped ids with a
stable `torch.argsort` and finds each table row's run with
`torch.searchsorted`, as the JAX function leaves its sort and bounds to XLA,
and cuts each row's run into pieces of at most `PIECE` entries. One warp sums
each piece in sorted order; rows of one piece are written straight to the
table, zeros included, and longer runs (a padding id may own most of a batch)
are summed piece by piece in a second pass: no atomics, and the bits repeat.
The lane packing for D < 128 (`scatter_add.py:106-141`) is a TPU layout
workaround and is not ported.

`scatter_add_rows` follows the port's dispatch rule (`core.device.use_kernel`):
CPU tensors run `scatter_add_rows_reference` (`index_put_` with accumulate),
CUDA tensors launch the kernel or raise. `scatter_add_rows.launches` counts
kernel launches. `gather_rows(table, ids)` is `table[ids]` whose backward is
`scatter_add_rows`.
"""

from __future__ import annotations

from typing import Optional

import torch

from rails_tpu_torch.core.device import use_kernel
from rails_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
PIECE = 256           # sorted entries per warp in the kernel's first pass


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
    lib = _build.load_library()
    dev = rows.device
    with torch.cuda.device(dev):
        flat = _wrapped_ids(ids, num_rows)
        order = torch.argsort(flat, stable=True)
        bounds = torch.searchsorted(flat[order],
                                    torch.arange(num_rows + 1, dtype=torch.int64, device=dev))
        pieces = torch.clamp((bounds[1:] - bounds[:-1] + PIECE - 1) // PIECE, min=1)
        first = torch.zeros(num_rows + 1, dtype=torch.int64, device=dev)
        torch.cumsum(pieces, dim=0, out=first[1:])
        # sum max(1, ceil(run / PIECE)) <= num_rows + M // PIECE: the grid and
        # the scratch are sized without reading `first` back (no host sync).
        max_pieces = num_rows + flat.numel() // PIECE
        src = rows.reshape(-1, d).contiguous()
        out = torch.empty(num_rows, d, dtype=torch.float32, device=dev)
        partial = torch.empty(max_pieces, d, dtype=torch.float32, device=dev)
        err = lib.rails_scatter_add_rows(
            _DTYPE_CODE[rows.dtype], src.data_ptr(), order.data_ptr(), bounds.data_ptr(),
            first.data_ptr(), out.data_ptr(), partial.data_ptr(), max_pieces, num_rows, d, PIECE,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "scatter_add_rows")
    scatter_add_rows.launches += 1
    return out.to(out_dtype or rows.dtype)


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
