"""HSTU encoder: eval through the K1 kernel, training through K4 (+ K3).

Counterpart of `rails_tpu/models/hstu.py`: `StackedRelativeBias` parameters
with `pos_tables(n)` (:130-138) and `ts_tables128` (:140-150), `HSTUBlock`
parameters (:183-208), the fused eval path of `HSTUStack.__call__`
(:466-523) in internal-bias mode and its `fused_train` path (:414-465), each
ending with `x * valid`.

`HSTUConfig.fused_inference` selects nothing here: the port's eval encoder
always runs `ops.hstu_block.fused_hstu_block`, and its training encoder
`ops.hstu_block_train.fused_train_block`; their plain versions serve CPU
tensors. The XLA training path (`fused_train=False`) and the block variants
the ported configs do not use raise NotImplementedError.
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch
from torch import nn

from rails_tpu_torch.core.config import HSTUConfig
from rails_tpu_torch.ops.hash_dropout import LAYER_SALT, wrap_i32
from rails_tpu_torch.ops.hstu_block import fused_hstu_block
from rails_tpu_torch.ops.hstu_block_train import BlockMeta, fused_train_block
from rails_tpu_torch.similarity.layers import normal, xavier_uniform


class StackedRelativeBias(nn.Module):
    """All blocks' relative-attention bias weights: pos_w (L, 2N-1) and ts_w
    (L, num_buckets+1)."""

    def __init__(self, num_blocks: int, max_seq_len: int, num_buckets: int,
                 generator: torch.Generator):
        super().__init__()
        self.max_seq_len = max_seq_len
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


class HSTUBlock(nn.Module):
    """Parameters of one block: uvqk (D, 2h*dv + 2h*dqk), o_kernel (h*dv, D),
    o_bias (D,), in the flax layout the kernel reads."""

    def __init__(self, cfg: HSTUConfig, generator: torch.Generator):
        super().__init__()
        h, d = cfg.num_heads, cfg.embedding_dim
        self.uvqk = nn.Parameter(normal((d, 2 * h * cfg.dv + 2 * h * cfg.dqk), 0.02, generator))
        self.o_kernel = nn.Parameter(xavier_uniform((h * cfg.dv, d), generator))
        self.o_bias = nn.Parameter(torch.zeros(d))


class HSTUStack(nn.Module):
    """Stack of HSTU blocks, eval (`HSTUJagged`)."""

    def __init__(self, cfg: HSTUConfig, max_seq_len: int, compute_dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        if not cfg.enable_relative_attention_bias:
            raise NotImplementedError(
                "HSTU without relative attention bias needs the no-bias K1 variant "
                "(ROADMAP.md, Queue 1: K1 variants)"
            )
        if cfg.concat_ua or cfg.linear_activation != "silu" or cfg.normalization not in (
            "rel_bias", "hstu_rel_bias"
        ):
            raise NotImplementedError(
                f"HSTU concat_ua={cfg.concat_ua}, linear_activation="
                f"{cfg.linear_activation!r}, normalization={cfg.normalization!r}: "
                "only the SiLU rel_bias block is ported (ROADMAP.md, Queue 1: K1 variants)"
            )
        self.cfg = cfg
        self.max_seq_len = max_seq_len
        self.compute_dtype = compute_dtype
        self.rel_attn_bias = StackedRelativeBias(
            cfg.num_blocks, max_seq_len, cfg.num_time_buckets, generator
        )
        for i in range(cfg.num_blocks):
            self.add_module(f"block_{i}", HSTUBlock(cfg, generator))

    def block_operands(
        self, valid: torch.Tensor, timestamps: torch.Tensor
    ) -> Iterator[dict]:
        """Keyword arguments of `fused_hstu_block` (all but x) for each block,
        in order: weights in the compute dtype, this batch's column mask,
        extended timestamps and the layer's bias tables."""
        if timestamps.dtype != torch.int32:
            raise ValueError("the in-kernel time bias needs int32 timestamps")
        c, dt = self.cfg, self.compute_dtype
        n = timestamps.shape[1]
        colmask = valid.float().contiguous()
        ext = torch.cat([timestamps, timestamps[:, n - 1 : n]], dim=1).contiguous()
        pos_all = self.rel_attn_bias.pos_tables(n)
        tsw_all = self.rel_attn_bias.ts_tables128()
        for i in range(c.num_blocks):
            blk = getattr(self, f"block_{i}")
            yield dict(
                colmask=colmask,
                uvqk=blk.uvqk.to(dt).contiguous(),
                o_kernel=blk.o_kernel.to(dt).contiguous(),
                o_bias=blk.o_bias.float().contiguous(),
                rel_pos=pos_all[i],
                ext=ext,
                tsw=tsw_all[i],
                num_heads=c.num_heads,
                dqk=c.dqk,
                dv=c.dv,
                # The 1/max_seq_len normaliser is part of the trained function:
                # it stays pinned when serving shorter padded batches.
                inv_n=1.0 / self.max_seq_len,
                eps=c.epsilon,
                num_buckets=c.num_time_buckets,
            )

    def forward(
        self, x: torch.Tensor, valid: torch.Tensor, timestamps: torch.Tensor,
        train: bool = False, seed0: Optional[int] = None,
    ) -> torch.Tensor:
        """Eval through K1; with `train`, the `fused_train` path: block i
        drops its o_input with the hash stream of seed seed0 + i * 1013904223
        (int32), which the caller draws (0 when no dropout is on)."""
        if train:
            return self._train_forward(x, valid, timestamps, 0 if seed0 is None else seed0)
        for kw in self.block_operands(valid, timestamps):
            x = fused_hstu_block(x, **kw)
        return x * valid[..., None].to(x.dtype)

    def _train_forward(self, x, valid, timestamps, seed0: int) -> torch.Tensor:
        c = self.cfg
        if not c.fused_train:
            raise NotImplementedError(
                "HSTU training without fused_train (the XLA block path) is not ported "
                "(ROADMAP.md, Queue 1: K4 variants)"
            )
        if c.attn_dropout_rate > 0.0 or self.compute_dtype != torch.float32:
            raise NotImplementedError(
                f"HSTU training with attn_dropout_rate={c.attn_dropout_rate}, compute dtype "
                f"{self.compute_dtype}: only the f32 train block without attention dropout "
                "is ported (ROADMAP.md, Queue 1: K4 variants)"
            )
        meta = BlockMeta(c.num_heads, c.dqk, c.dv, 1.0 / self.max_seq_len, c.epsilon,
                         c.num_time_buckets, c.linear_dropout_rate)
        for i, kw in enumerate(self.block_operands(valid, timestamps)):
            x = fused_train_block(
                x, kw["rel_pos"], kw["tsw"], kw["uvqk"], kw["o_kernel"], kw["o_bias"],
                kw["colmask"], kw["ext"], wrap_i32(seed0 + i * LAYER_SALT), meta,
            )
        return x * valid[..., None].to(x.dtype)
