"""HSTU encoder: eval through K1 or the XLA block path, training through K4 (+ K3).

Counterpart of `rails_tpu/models/hstu.py`: `_bucketize_time_delta` (:30-36),
`StackedRelativeBias` with its (L, B, N, N) bias and optional mask penalty
(:103-128), `pos_tables(n)` (:130-138) and `ts_tables128` (:140-150),
`HSTUBlock` with its eval and training forward (:175-299: SiLU or no
activation, `rel_bias`/`hstu_rel_bias` or `softmax_rel_bias`, `concat_ua`,
with or without the relative-attention bias), and `HSTUStack.__call__`: the
`fused_train` path (:414-465), the fused eval path (:466-523) and the XLA
eval path (:524-535), each ending with `x * valid`.

Eval dispatches on `HSTUConfig.fused_inference` as JAX does: True runs
`ops.hstu_block.fused_hstu_block` (K1) in the mode JAX picks
(`block_operands`): the bias built in-kernel for int32 timestamps; otherwise
a precomputed (L, B, N, N) bias in the compute dtype, raw under softmax (the
kernel masks after normalisation) and with the -30000 mask penalty folded in
for pointwise attention; no bias without `enable_relative_attention_bias`.
False runs the XLA block path in plain torch (JAX runs it in XLA, not
Pallas). The XLA path buckets time deltas with log(.)/0.301 clipped to
`num_buckets`, casts the bias to the compute dtype, and rounds to the compute
dtype wherever JAX's einsums ask for `preferred_element_type=self.dtype`; its
LayerNorm, SiLU and softmax run in that dtype. Training dispatches on
`HSTUConfig.fused_train`: True runs `ops.hstu_block_train.fused_train_block`
(K4) in f32 or bf16 for int32 timestamps or without the bias (other
timestamps take the XLA path, as in JAX), for every block variant (no
activation, softmax, concat_ua, no bias, head dims above 32) with o_input and
attention dropout from the counter-hash streams of the layer's seed; False
(ML-1M, Amazon Books) the XLA block path with autograd through plain torch,
with flax's attention dropout (after the mask) and o_input dropout drawn from
the caller's `torch.Generator` (checked by rate and scale: flax's PRNG bits
cannot be matched).
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch
from torch import nn

from rails_tpu_torch.core.config import HSTUConfig
from rails_tpu_torch.core.distributed import row_span
from rails_tpu_torch.ops.hash_dropout import LAYER_SALT, USER_SALT, wrap_i32
from rails_tpu_torch.ops.hstu_block import fused_hstu_block
from rails_tpu_torch.ops.hstu_block_train import BlockMeta, fused_train_block
from rails_tpu_torch.similarity.layers import (
    dropout,
    layer_norm_in_dtype,
    normal,
    xavier_uniform,
)


def bucketize_time_delta(delta: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """log(max(|delta|, 1)) / 0.301, truncated and clipped to
    [0, num_buckets] (`_bucketize_time_delta`); int32."""
    v = torch.log(torch.clamp(delta.abs().float(), min=1.0)) / 0.301
    return torch.clamp(v.to(torch.int32), 0, num_buckets)


def train_block_meta(c: HSTUConfig, max_seq_len: int) -> BlockMeta:
    """The fused train block's static description (K4's variant) for a
    config; the normaliser 1/max_seq_len is part of the trained function."""
    return BlockMeta(c.num_heads, c.dqk, c.dv, 1.0 / max_seq_len, c.epsilon, c.num_time_buckets,
                     c.linear_dropout_rate, c.linear_activation,
                     c.normalization == "softmax_rel_bias", c.concat_ua, c.attn_dropout_rate)


class StackedRelativeBias(nn.Module):
    """All blocks' relative-attention bias weights: pos_w (L, 2N-1) and ts_w
    (L, num_buckets+1)."""

    def __init__(self, num_blocks: int, max_seq_len: int, num_buckets: int,
                 generator: torch.Generator):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.num_buckets = num_buckets
        self.pos_w = nn.Parameter(normal((num_blocks, 2 * max_seq_len - 1), 0.02, generator))
        self.ts_w = nn.Parameter(normal((num_blocks, num_buckets + 1), 0.02, generator))

    def pos_tables(self, n: int) -> torch.Tensor:
        """Per-layer (L, n, n) f32 slabs pos_w[j - i + max_seq_len - 1]: serving
        with n < max_seq_len indexes the trained table at its centre."""
        i = torch.arange(n, device=self.pos_w.device)[:, None]
        j = torch.arange(n, device=self.pos_w.device)[None, :]
        return self.pos_w[:, j - i + self.max_seq_len - 1].float().contiguous()

    def ts_tables128(self) -> torch.Tensor:
        """Per-layer time-bucket tables padded or cut to 128 entries, f32
        (int32 timestamps never reach a bucket past 71)."""
        tbl = self.ts_w.float()
        if tbl.shape[1] < 128:
            tbl = nn.functional.pad(tbl, (0, 128 - tbl.shape[1]))
        return tbl[:, :128].contiguous()

    def forward(self, timestamps: torch.Tensor, dtype: torch.dtype,
                penalty: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(L, B, N, N) rel-pos + bucketed time bias of the XLA block path,
        summed in f32 and cast to `dtype`; an additive (B, N, N) `penalty`
        (the fused path's mask) is added in f32 before the cast."""
        n = timestamps.shape[1]
        i = torch.arange(n, device=timestamps.device)[:, None]
        j = torch.arange(n, device=timestamps.device)[None, :]
        rel_pos = self.pos_w[:, j - i + self.max_seq_len - 1]              # (L, N, N)
        ext = torch.cat([timestamps, timestamps[:, n - 1 : n]], dim=1)
        delta = ext[:, 1:, None] - ext[:, None, :-1]                        # (B, N, N)
        buckets = bucketize_time_delta(delta, self.num_buckets)
        rel_ts = self.ts_w.T[buckets.long()]                                # (B, N, N, L)
        bias = rel_pos[:, None] + rel_ts.movedim(-1, 0)
        if penalty is not None:
            bias = bias + penalty[None].to(bias.dtype)
        return bias.to(dtype)

    def row(self, timestamps: torch.Tensor, position: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
        """(L, B, N) bias of one query row per batch row (`hstu.py:152-172`):
        `position` (B,) the 0-based query index; the time part reads
        ts[position + 1], the next item's timestamp."""
        n = timestamps.shape[1]
        j = torch.arange(n, device=timestamps.device)[None, :]
        rel_pos = self.pos_w[:, j - position.long()[:, None] + self.max_seq_len - 1]   # (L, B, N)
        ext = torch.cat([timestamps, timestamps[:, n - 1 : n]], dim=1)
        ts_next = ext.gather(1, torch.clamp(position.long() + 1, max=n)[:, None])      # (B, 1)
        buckets = bucketize_time_delta(ts_next - timestamps, self.num_buckets)
        rel_ts = self.ts_w.T[buckets.long()]                                       # (B, N, L)
        return (rel_pos + rel_ts.movedim(-1, 0)).to(dtype)


class HSTUBlock(nn.Module):
    """Parameters of one block: uvqk (D, 2h*dv + 2h*dqk), o_kernel (h*dv, D),
    or (3*h*dv, D) with `concat_ua`, and o_bias (D,), in the flax layout the
    kernel reads."""

    def __init__(self, cfg: HSTUConfig, max_seq_len: int, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.max_seq_len = max_seq_len
        h, d = cfg.num_heads, cfg.embedding_dim
        o_in = h * cfg.dv * (3 if cfg.concat_ua else 1)
        self.uvqk = nn.Parameter(normal((d, 2 * h * cfg.dv + 2 * h * cfg.dqk), 0.02, generator))
        self.o_kernel = nn.Parameter(xavier_uniform((o_in, d), generator))
        self.o_bias = nn.Parameter(torch.zeros(d))

    def _uvqk(self, x: torch.Tensor):
        """u, v, q, k of LN(x) @ uvqk after the linear activation."""
        c = self.cfg
        h, dqk, dv = c.num_heads, c.dqk, c.dv
        y = layer_norm_in_dtype(x, c.epsilon) @ self.uvqk.to(x.dtype)
        if c.linear_activation == "silu":
            y = y * torch.sigmoid(y)
        elif c.linear_activation != "none":
            raise ValueError(f"Unknown linear_activation {c.linear_activation!r}")
        return torch.split(y, [h * dv, h * dv, h * dqk, h * dqk], dim=-1)

    def _out(self, x: torch.Tensor, u: torch.Tensor, attn_out: torch.Tensor, train: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        c = self.cfg
        a = layer_norm_in_dtype(attn_out, c.epsilon)
        o_input = torch.cat([u, a, u * a], dim=-1) if c.concat_ua else u * a
        if train:
            o_input = dropout(o_input, c.linear_dropout_rate, generator)
        return (o_input @ self.o_kernel.to(x.dtype) + self.o_bias.to(x.dtype)) + x

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                rel_bias: Optional[torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None, return_kv: bool = False):
        """The XLA block (`HSTUBlock.__call__`) in x's dtype: x (B, N, D),
        attn_mask (B, N, N) f32 causal x column-valid, rel_bias (B, N, N) or
        None. With `train`, the attention weights (after the mask) and
        o_input drop at their configured rates. `return_kv` also returns
        (k (B, N, h*dqk), v (B, N, h*dv)), the decode cache."""
        c = self.cfg
        b, n, _ = x.shape
        h, dqk, dv = c.num_heads, c.dqk, c.dv
        dt = x.dtype
        u, v, q, k = self._uvqk(x)
        if c.normalization == "softmax_rel_bias":
            # One map over the full h*dqk contraction shared by every value
            # head, scaled by sqrt(dqk) and masked after normalisation.
            s = q @ k.transpose(1, 2)
            if rel_bias is not None:
                s = s + rel_bias
            attn = torch.softmax(s / torch.tensor(float(dqk) ** 0.5).to(dt), dim=-1)
            attn = attn * attn_mask.to(dt)
            if train:
                attn = dropout(attn, c.attn_dropout_rate, generator)
            attn_out = attn @ v
        elif c.normalization in ("rel_bias", "hstu_rel_bias"):
            qk = torch.einsum("bnhd,bmhd->bhnm", q.reshape(b, n, h, dqk),
                              k.reshape(b, n, h, dqk))
            if rel_bias is not None:
                qk = qk + rel_bias[:, None]
            attn = qk * torch.sigmoid(qk) * (1.0 / self.max_seq_len)
            attn = attn * attn_mask[:, None].to(dt)
            if train:
                attn = dropout(attn, c.attn_dropout_rate, generator)
            attn_out = torch.einsum("bhnm,bmhd->bnhd", attn,
                                    v.reshape(b, n, h, dv)).reshape(b, n, h * dv)
        else:
            raise ValueError(f"Unknown normalization {c.normalization!r}")
        out = self._out(x, u, attn_out, train, generator)
        return (out, (k, v)) if return_kv else out

    def decode_step(self, x_t: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    position: torch.Tensor, bias_row: Optional[torch.Tensor]):
        """One appended position per row against the cached keys and values
        (`hstu.py:301-365`): x_t (B, D), caches (B, N, h*d), position (B,),
        bias_row (B, N) or None. Returns (y_t (B, D), k_cache, v_cache), the
        caches written at `position`; the 1/N normaliser is the full padded
        length's, as in the dense forward."""
        c = self.cfg
        b, n, _ = k_cache.shape
        h, dqk, dv = c.num_heads, c.dqk, c.dv
        dt = x_t.dtype
        u, v, q, k = self._uvqk(x_t)
        rows = torch.arange(b, device=x_t.device)
        pos = position.long()
        k_cache = k_cache.clone()
        v_cache = v_cache.clone()
        k_cache[rows, pos] = k
        v_cache[rows, pos] = v
        col_ok = (torch.arange(n, device=x_t.device)[None, :] <= pos[:, None]).to(dt)
        if c.normalization == "softmax_rel_bias":
            s = torch.einsum("bd,bmd->bm", q, k_cache)
            if bias_row is not None:
                s = s + bias_row
            attn = torch.softmax(s / torch.tensor(float(dqk) ** 0.5).to(dt), dim=-1) * col_ok
            attn_out = torch.einsum("bm,bmd->bd", attn, v_cache)
        elif c.normalization in ("rel_bias", "hstu_rel_bias"):
            qk = torch.einsum("bhd,bmhd->bhm", q.reshape(b, h, dqk), k_cache.reshape(b, n, h, dqk))
            if bias_row is not None:
                qk = qk + bias_row[:, None, :]
            attn = qk * torch.sigmoid(qk) * (1.0 / self.max_seq_len) * col_ok[:, None, :]
            attn_out = torch.einsum("bhm,bmhd->bhd", attn,
                                    v_cache.reshape(b, n, h, dv)).reshape(b, h * dv)
        else:
            raise ValueError(f"Unknown normalization {c.normalization!r}")
        return self._out(x_t, u, attn_out, False, None), k_cache, v_cache


class HSTUStack(nn.Module):
    """Stack of HSTU blocks (`HSTUJagged`)."""

    def __init__(self, cfg: HSTUConfig, max_seq_len: int, compute_dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.max_seq_len = max_seq_len
        self.compute_dtype = compute_dtype
        # No `rel_attn_bias` entry at all without the bias, as in the flax tree.
        self.rel_attn_bias = (
            StackedRelativeBias(cfg.num_blocks, max_seq_len, cfg.num_time_buckets, generator)
            if cfg.enable_relative_attention_bias else None
        )
        for i in range(cfg.num_blocks):
            self.add_module(f"block_{i}", HSTUBlock(cfg, max_seq_len, generator))

    def _internal_bias(self, timestamps: Optional[torch.Tensor]) -> bool:
        """Whether the kernels build the bias themselves (int32 timestamps)."""
        return (self.rel_attn_bias is not None and timestamps is not None
                and timestamps.dtype == torch.int32)

    def block_operands(
        self, valid: torch.Tensor, timestamps: Optional[torch.Tensor]
    ) -> Iterator[dict]:
        """Keyword arguments of `fused_hstu_block` (all but x) for each block,
        in order: weights in the compute dtype, this batch's column mask and
        the bias in JAX's mode (`rails_tpu/models/hstu.py:466-523`): the
        extended timestamps and the layer's bias tables for int32 timestamps;
        else the layer's precomputed bias in the compute dtype, raw under
        softmax and with the -30000 mask penalty folded in otherwise; no bias
        without `enable_relative_attention_bias` or timestamps."""
        c, dt = self.cfg, self.compute_dtype
        n = valid.shape[1]
        softmax = c.normalization == "softmax_rel_bias"
        colmask = valid.float().contiguous()
        per_layer = [{} for _ in range(c.num_blocks)]
        if self._internal_bias(timestamps):
            ext = torch.cat([timestamps, timestamps[:, n - 1 : n]], dim=1).contiguous()
            pos_all = self.rel_attn_bias.pos_tables(n)
            tsw_all = self.rel_attn_bias.ts_tables128()
            for i, kw in enumerate(per_layer):
                kw.update(rel_pos=pos_all[i], ext=ext, tsw=tsw_all[i])
        elif self.rel_attn_bias is not None and timestamps is not None:
            penalty = None
            if not softmax:
                causal = torch.tril(torch.ones(n, n, dtype=torch.float32, device=valid.device))
                penalty = (causal[None] * colmask[:, None, :] - 1.0) * 30000.0
            bias_all = self.rel_attn_bias(timestamps, dt, penalty)
            for i, kw in enumerate(per_layer):
                kw.update(bias=bias_all[i].contiguous(), mask_in_bias=not softmax)
        for i, kw in enumerate(per_layer):
            blk = getattr(self, f"block_{i}")
            yield dict(
                kw,
                colmask=colmask,
                uvqk=blk.uvqk.to(dt).contiguous(),
                o_kernel=blk.o_kernel.to(dt).contiguous(),
                o_bias=blk.o_bias.float().contiguous(),
                num_heads=c.num_heads,
                dqk=c.dqk,
                dv=c.dv,
                # The 1/max_seq_len normaliser is part of the trained function:
                # it stays pinned when serving shorter padded batches.
                inv_n=1.0 / self.max_seq_len,
                eps=c.epsilon,
                num_buckets=c.num_time_buckets,
                activation=c.linear_activation,
                normalization=c.normalization,
            )

    def forward(
        self, x: torch.Tensor, valid: torch.Tensor, timestamps: Optional[torch.Tensor],
        train: bool = False, seed0: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Eval through K1 (`fused_inference`) or the XLA block path. Training
        with `fused_train` runs K4 when the bias can be built in-kernel
        (int32 timestamps, or no bias): block i drops its o_input with the
        hash stream of seed seed0 + i * 1013904223 (int32), and its attention
        weights with the per-head stream of the same seed, which the caller
        draws (0 when no dropout is on); otherwise the XLA block path, whose
        dropouts draw from `generator`."""
        fused_train_ok = self.rel_attn_bias is None or self._internal_bias(timestamps)
        if train and self.cfg.fused_train and fused_train_ok:
            return self._fused_train_forward(x, valid, timestamps, 0 if seed0 is None else seed0)
        if self.cfg.fused_inference and not train:
            for kw in self.block_operands(valid, timestamps):
                x = fused_hstu_block(x, **kw)
            return x * valid[..., None].to(x.dtype)
        n = x.shape[1]
        bias_all = (None if self.rel_attn_bias is None or timestamps is None
                    else self.rel_attn_bias(timestamps, x.dtype))
        causal = torch.tril(torch.ones(n, n, dtype=torch.float32, device=x.device))
        attn_mask = causal[None] * valid[:, None, :].float()
        for i in range(self.cfg.num_blocks):
            x = getattr(self, f"block_{i}")(x, attn_mask, None if bias_all is None else bias_all[i],
                                            train, generator)
        return x * valid[..., None].to(x.dtype)

    def prefill(self, x: torch.Tensor, valid: torch.Tensor,
                timestamps: Optional[torch.Tensor]):
        """The XLA block path's eval forward, also returning each block's
        (k (B, N, h*dqk), v (B, N, h*dv)) cache (`hstu.py:541-569`)."""
        n = x.shape[1]
        bias_all = (None if self.rel_attn_bias is None or timestamps is None
                    else self.rel_attn_bias(timestamps, x.dtype))
        causal = torch.tril(torch.ones(n, n, dtype=torch.float32, device=x.device))
        attn_mask = causal[None] * valid[:, None, :].float()
        cache = []
        for i in range(self.cfg.num_blocks):
            x, kv = getattr(self, f"block_{i}")(
                x, attn_mask, None if bias_all is None else bias_all[i], return_kv=True)
            cache.append(kv)
        return x * valid[..., None].to(x.dtype), tuple(cache)

    def decode_step(self, x_t: torch.Tensor, cache, position: torch.Tensor,
                    timestamps: Optional[torch.Tensor]):
        """One appended position through every block with its cache
        (`hstu.py:571-591`); returns (y_t (B, D), new cache)."""
        bias_rows = (None if timestamps is None or self.rel_attn_bias is None
                     else self.rel_attn_bias.row(timestamps, position, x_t.dtype))
        new_cache = []
        for i, (k_c, v_c) in enumerate(cache):
            x_t, k_c, v_c = getattr(self, f"block_{i}").decode_step(
                x_t, k_c, v_c, position, None if bias_rows is None else bias_rows[i])
            new_cache.append((k_c, v_c))
        return x_t, tuple(new_cache)

    def _fused_train_forward(self, x, valid, timestamps, seed0: int) -> torch.Tensor:
        meta = train_block_meta(self.cfg, self.max_seq_len)
        # The streams number a user by its batch row, seed0 + row * USER_SALT:
        # a data-parallel rank's rows are the global batch's rows from its
        # offset on, which the seed carries.
        seed0 = wrap_i32(seed0 + row_span(x.shape[0])[0] * USER_SALT)
        for i, kw in enumerate(self.block_operands(valid, timestamps)):
            # No rel_pos, ext or tsw without the relative-attention bias.
            x = fused_train_block(
                x, kw.get("rel_pos"), kw.get("tsw"), kw["uvqk"], kw["o_kernel"], kw["o_bias"],
                kw["colmask"], kw.get("ext"), wrap_i32(seed0 + i * LAYER_SALT), meta,
            )
        return x * valid[..., None].to(x.dtype)
