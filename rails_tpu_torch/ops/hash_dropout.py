"""Counter-hash dropout (K3): the keep mask of the fused train block's o_input,
and the salted global stream of the fused MoL loss (K5).

Replaces `keep_from_idx` (`rails_tpu/ops/pallas/hash_dropout.py:26-36`) and
the batched o_input mask `_dropout_mask_batch`
(`rails_tpu/ops/pallas/hstu_block_train.py:438-449`). The mask is a
murmur3-finalizer hash of the flat index idx = pos * width + col under the
per-user seed seed0 + user * (-1498392781), so the forward (inside K4's
output GEMM) and the backward regenerate the same bits without storing a
mask. The bits equal the JAX package's, which the CPU tests hold bit for bit.

The kernel (`csrc/hash_dropout.cu`, device function in
`csrc/hash_dropout.cuh`) writes the whole (B, n, width) mask, which the
train block's backward multiplies into d(o_input) and the recomputed
o_input. `hash_keep_mask` follows the port's dispatch rule
(`core.device.use_kernel`): a CPU device runs `hash_keep_mask_reference`, a
CUDA device launches the kernel or raises. `hash_keep_mask.launches` counts
kernel launches.

`attn_keep_mask_reference` is the plain attention-weight mask of the train
block's attention dropout (`_attn_dropout_mask`,
`rails_tpu/ops/pallas/hstu_block_train.py:113-121`): per (user, head) the
seed seed0 + user * (-1498392781) + (head + 1) * (-1789569707) over the flat
index i * n + j of the (n, n) map; the softmax map draws head 0. K4's kernels
regenerate it in place (`attn_seed` in `csrc/hash_dropout.cuh`), so it has no
kernel of its own.

`hash_keep_global_reference` is the plain (L, M, R) mask of K5's two
streams (`hash_keep_global`, `rails_tpu/ops/pallas/mol_loss_train.py:57-64`):
idx = row * (M * R) + m * R + r under the seed seed + salt, with the salts
`QI_SALT` (the qi-MLP input) and `PI_SALT` (the softmax weights).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from rails_tpu_torch.core.device import resolve_device, use_kernel
from rails_tpu_torch.ops import _build

_MASK32 = 0xFFFFFFFF
_M1, _M2, _M3 = 0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35
# The o_input stream's per-user salt, int32 -1498392781 = 0xA6B05733.
USER_SALT = -1498392781
# The per-layer seed step of `HSTUStack` (`rails_tpu/models/hstu.py:463`).
LAYER_SALT = 1013904223
# K5's stream salts (`mol_loss_train.py:46-47`): -1498392781 = 0xA6B05733 (the
# JAX comment's 0xA6AC5333 is wrong; it is USER_SALT's value) and
# -1789569707 = 0x95555555.
QI_SALT = -1498392781
PI_SALT = -1789569707
# The attention stream's per-head salt, int32 -1789569707 = 0x95555555.
HEAD_SALT = -1789569707


def wrap_i32(v: int) -> int:
    """A Python int wrapped to int32, two's complement."""
    v &= _MASK32
    return v - (1 << 32) if v >= (1 << 31) else v


def stream_offset(n: int) -> int:
    """The int32 seed shift that moves a stream's flat index by `n`: the hash
    starts from idx * 0x9E3779B1 + seed (mod 2^32), so idx + n under seed s
    is idx under s + stream_offset(n)."""
    return wrap_i32(n * _M1)


def keep_threshold(rate: float) -> int:
    """min(int(rate * 2^31), 2^31 - 1), as `keep_from_idx` computes it."""
    return min(int(rate * 2.0 ** 31), 2 ** 31 - 1)


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 h in [0, 2^32): the product split in 16-bit
    halves of m, so no intermediate leaves int64."""
    lo, hi = m & 0xFFFF, m >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK32


def keep_from_idx_reference(idx: torch.Tensor, seed: torch.Tensor, rate: float) -> torch.Tensor:
    """Scaled keep mask (0 or f32(1/(1-rate))) of int32 flat indices under
    int32 seeds (broadcast against idx); the bits of `keep_from_idx`. The
    32-bit wrapping arithmetic runs exactly in int64 with masks, and the
    shifts are logical because the values are non-negative."""
    h = (_mul32(idx.long() & _MASK32, _M1) + (seed.long() & _MASK32)) & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, _M2)
    h = h ^ (h >> 13)
    h = _mul32(h, _M3)
    h = h ^ (h >> 16)
    keep = (h & 0x7FFFFFFF) >= keep_threshold(rate)
    return keep.to(torch.float32) * (1.0 / (1.0 - rate))


def hash_keep_mask_reference(
    b: int, n: int, width: int, seed0: int, rate: float,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """(b, n, width) f32 o_input keep mask of layer seed `seed0`: user = batch
    row, idx = pos * width + col (`_dropout_mask_batch`)."""
    device = resolve_device(device)
    idx = torch.arange(n * width, dtype=torch.int64, device=device).reshape(1, n, width)
    users = torch.arange(b, dtype=torch.int64, device=device).reshape(b, 1, 1)
    seeds = (seed0 + users * USER_SALT) & _MASK32
    return keep_from_idx_reference(idx, seeds, rate)


def attn_keep_mask_reference(
    b: int, n: int, num_heads: int, seed0: int, rate: float,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """(b, num_heads, n, n) f32 attention keep mask of layer seed `seed0`:
    user = batch row, head h's seed seed0 + user * USER_SALT + (h + 1) *
    HEAD_SALT, idx = i * n + j (`_attn_dropout_mask`). The softmax map is
    num_heads = 1 (head 0)."""
    device = resolve_device(device)
    idx = torch.arange(n * n, dtype=torch.int64, device=device).reshape(1, 1, n, n)
    users = torch.arange(b, dtype=torch.int64, device=device).reshape(b, 1, 1, 1)
    heads = torch.arange(num_heads, dtype=torch.int64, device=device).reshape(1, num_heads, 1, 1)
    seeds = (seed0 + users * USER_SALT + (heads + 1) * HEAD_SALT) & _MASK32
    return keep_from_idx_reference(idx, seeds, rate)


def hash_keep_mask(
    b: int, n: int, width: int, seed0: int, rate: float,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """The o_input keep mask on `device` (the card when None); same arguments
    as `hash_keep_mask_reference`."""
    probe = torch.empty(0, device=resolve_device(device))
    if not use_kernel(probe):
        return hash_keep_mask_reference(b, n, width, seed0, rate, device)
    seed0 = wrap_i32(seed0)
    lib = _build.load_library()
    with torch.cuda.device(probe.device):
        out = torch.empty(b, n, width, dtype=torch.float32, device=probe.device)
        err = lib.rails_hash_keep_mask(
            out.data_ptr(), b, n, width, seed0, keep_threshold(rate), 1.0 / (1.0 - rate),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "hash_keep_mask")
    hash_keep_mask.launches += 1
    return out


hash_keep_mask.launches = 0


def hash_keep_global_reference(
    seed: int, salt: int, l: int, m: int, r: int, rate: float,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """(l, m, r) f32 scaled keep mask of K5's stream `salt`: flat index
    row * (m * r) + mi * r + ci under seed + salt (`hash_keep_global`). K5
    passes its padded extents (M to a multiple of min(8, M), R to a multiple
    of 128) and its m-major row order (`mol_loss_train.lprime`)."""
    device = resolve_device(device)
    idx = torch.arange(l * m * r, dtype=torch.int64, device=device).reshape(l, m, r)
    seeds = torch.tensor(wrap_i32(seed + salt), dtype=torch.int64, device=device)
    return keep_from_idx_reference(idx, seeds, rate)
