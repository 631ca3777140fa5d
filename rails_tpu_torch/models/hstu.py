"""HSTU encoder, eval path, every block through the K1 kernel.

Counterpart of `rails_tpu/models/hstu.py`: `StackedRelativeBias` parameters
with `pos_tables(n)` (:130-138) and `ts_tables128` (:140-150), `HSTUBlock`
parameters (:183-208), and the fused eval path of `HSTUStack.__call__`
(:466-523) in internal-bias mode, ending with `x * valid`.

`HSTUConfig.fused_inference` selects nothing here: the port's eval encoder
always runs `ops.hstu_block.fused_hstu_block`, whose plain version serves
CPU tensors. The training path (fused train block, dropout) and the K1
variants the serving config does not use are not ported yet.
"""

from __future__ import annotations

from typing import Iterator

import torch
from torch import nn

from rails_tpu.core.config import HSTUConfig
from rails_tpu_torch.ops.hstu_block import fused_hstu_block
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
        self, x: torch.Tensor, valid: torch.Tensor, timestamps: torch.Tensor
    ) -> torch.Tensor:
        for kw in self.block_operands(valid, timestamps):
            x = fused_hstu_block(x, **kw)
        return x * valid[..., None].to(x.dtype)
