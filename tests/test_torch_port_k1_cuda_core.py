"""The shared memory of K1's CUDA-core attention (`hstu_attn_kernel`,
`hstu_attn_chunked_kernel` in `rails_tpu_torch/csrc/hstu_block.cuh`), on the
CPU.

The library owns the rule: the wrappers ask `rails_hstu_attn_smem_bytes`
before any launch. This file holds a mirror of its C++ sums
(`head_attn_smem_bytes`, `chunked_attn_smem_bytes`, `attn_smem_bytes`,
`attn_stride`, and the constants they read) and holds the mirror to the rule
that every (n, dqk, dv) the kernel's first design admitted stays admitted:
the whole-head kernel runs where it fits a block, the chunked one
everywhere else. On a card, tests/test_torch_port_gpu.py holds the library
to this mirror; the kernels' loop orders are held there and by
`chip_smoke.py`'s `[K1-hash]` lines.
"""

import pytest

from rails_tpu_torch.ops.hstu_block import MAX_SMEM_BYTES

# The whole-head kernel: kAttnThreads threads a block, kAttnRows query rows
# a warp at a time, for dv <= 64; the chunked kernel: AT query rows a block,
# keys in chunks of AT, value columns in passes of kAttnCols.
ATTN_THREADS = 512
ATTN_ROWS = 8
ATTN_TILE = 64
ATTN_COLS = 64


def attn_stride(w: int) -> int:
    """`attn_stride`: the chunked attention's shared row stride for w
    floats, a multiple of 4 for float4 access, moved off a multiple of 16 up
    to 256 words (bank spread)."""
    r = -(-w // 4) * 4
    return r + 4 if r % 16 == 0 and r <= 256 else r


def head_attn_smem_bytes(n: int, dqk: int, dv: int) -> int:
    """`head_attn_smem_bytes`: the whole-head kernel's dynamic shared
    memory, 0 where it has no instance (dv > 64): q and k of the head
    transposed, v, each warp's weights of a 32-key step, the time-bucket
    weights and a counter."""
    if dv > 64:
        return 0
    ldq = -(-n // ATTN_ROWS) * ATTN_ROWS
    warps = ATTN_THREADS // 32
    return 4 * (dqk * ldq + warps * 32 * ATTN_ROWS + dqk * (n | 1) + n * dv + 128 + 4)


def chunked_attn_smem_bytes(n: int, dqk: int, dv: int) -> int:
    """`chunked_attn_smem_bytes`: the tile's q rows, one region for a key
    chunk and then its weights, a value chunk and the time-bucket weights,
    min(n, 64) rows each."""
    m = min(n, ATTN_TILE)
    ldq, lda = attn_stride(dqk), attn_stride(m)
    return 4 * (m * ldq + m * max(ldq, lda) + m * min(dv, ATTN_COLS) + 128)


def attn_smem_bytes(n: int, dqk: int, dv: int) -> int:
    """`attn_smem_bytes` (`rails_hstu_attn_smem_bytes`): the whole-head
    kernel's bytes where they fit a block, else the chunked kernel's."""
    head = head_attn_smem_bytes(n, dqk, dv)
    return head if 0 < head <= MAX_SMEM_BYTES else chunked_attn_smem_bytes(n, dqk, dv)


def first_design_attn_smem_bytes(n: int, dqk: int, dv: int) -> int:
    """Shared memory of the attention's first design (whole heads staged: k
    transposed with an odd stride, v, q, one row of weights per warp, the
    column mask, the time-bucket weights and the extended timestamps)."""
    floats = dqk * (n | 1) + n * (dv + dqk + 8 + 1) + 128
    return 4 * floats + 4 * (n + 1)


def _largest_admitted_dv(n: int, dqk: int) -> int:
    """The largest dv the first design admitted at (n, dqk) (0: none)."""
    free = MAX_SMEM_BYTES - first_design_attn_smem_bytes(n, dqk, 0)
    return max(free // (4 * n), 0)


@pytest.mark.parametrize("lo,hi", [(1, 16), (16, 64), (64, 65), (65, 600), (600, 4900)],
                         ids=["n1-15", "n16-63", "n64", "n65-599", "n600-4899"])
def test_attn_admits_every_shape_the_first_design_admitted(lo, hi):
    """For each n and dqk the first design took, at its largest dv (both
    rules grow with dv, so that is the hardest case), the new layout fits
    too. n past 4,900 did not fit even at dqk = dv = 1."""
    checked = 0
    for n in range(lo, hi):
        dqk = 1
        while True:
            dv = _largest_admitted_dv(n, dqk)
            if dv < 1:
                break
            assert chunked_attn_smem_bytes(n, dqk, dv) <= MAX_SMEM_BYTES, (n, dqk, dv)
            assert attn_smem_bytes(n, dqk, dv) <= MAX_SMEM_BYTES, (n, dqk, dv)
            checked += 1
            # Every dqk up to 128, then a coarser walk up to the edge.
            dqk += 1 if dqk < 128 else max(1, dqk // 64)
    assert checked > 0


def test_attn_smem_stops_growing_with_n_and_fits_wide_heads():
    """Past 64 rows the chunked layout no longer grows with n, so the shapes
    the first design refused for length now fit: ML-20M's heads at n =
    8,192 and dqk = dv = 64 at n = 513 (first design: 2x and 1.7x the
    limit)."""
    assert chunked_attn_smem_bytes(211, 32, 32) == 35_328
    assert chunked_attn_smem_bytes(211, 64, 64) == 51_712
    assert chunked_attn_smem_bytes(64, 32, 32) == chunked_attn_smem_bytes(8_192, 32, 32)
    for n, dqk, dv in ((8_192, 32, 32), (513, 64, 64)):
        assert first_design_attn_smem_bytes(n, dqk, dv) > MAX_SMEM_BYTES
        assert attn_smem_bytes(n, dqk, dv) <= MAX_SMEM_BYTES
    # Value columns past ATTN_COLS take further passes, not more memory.
    assert chunked_attn_smem_bytes(211, 32, 4 * ATTN_COLS) == chunked_attn_smem_bytes(
        211, 32, ATTN_COLS)


@pytest.mark.parametrize("n,dqk,dv,head", [
    (211, 32, 32, True), (211, 64, 64, True), (513, 32, 32, True), (1, 8, 8, True),
    (211, 32, 65, False), (211, 96, 96, False), (1_024, 32, 32, False), (300, 64, 64, False),
])
def test_attn_route_takes_the_whole_head_kernel_where_it_fits(n, dqk, dv, head):
    """The whole-head kernel where dv <= 64 and its staging fits a block
    (ML-20M's 98 KB, the wide heads' 180 KB), else the chunked kernel; the
    bytes a launch asks for are that kernel's."""
    fits = 0 < head_attn_smem_bytes(n, dqk, dv) <= MAX_SMEM_BYTES
    assert fits == head
    want = head_attn_smem_bytes(n, dqk, dv) if head else chunked_attn_smem_bytes(n, dqk, dv)
    assert attn_smem_bytes(n, dqk, dv) == want
    assert head_attn_smem_bytes(211, 32, 32) == 98_576


@pytest.mark.parametrize("n,dqk,dv", [(64, 1_000, 8), (1, 60_000, 1), (300, 500, 500)])
def test_attn_shapes_past_the_limit_are_refused(n, dqk, dv):
    """Head widths whose q and key chunk alone pass 227 KB: the wrappers
    raise ValueError on them before any launch (tests/test_torch_port_gpu.py
    holds the wrappers to it on a card)."""
    assert attn_smem_bytes(n, dqk, dv) > MAX_SMEM_BYTES


@pytest.mark.parametrize("w", [1, 3, 4, 8, 16, 25, 32, 48, 61, 64, 256, 257, 1_358, 1_000])
def test_attn_strides_keep_float4_rows_apart_in_banks(w):
    """A row stride is a multiple of 4 (float4 loads); up to 256 words it is
    not a multiple of 16, so rows 1 to 3 apart land on other banks; past
    256 it is w rounded up to 4, the margin the admission rule allows."""
    s, up = attn_stride(w), -(-w // 4) * 4
    assert s % 4 == 0 and w <= s
    if w <= 256:
        assert s % 16 != 0 and s <= up + 4
    else:
        assert s == up
