"""SASRec encoder (self-attentive sequential recommendation).

Counterpart of `rails_tpu/models/sasrec.py`: `_ln` with eps 1e-8 (:23-26),
`PointwiseFFN` (:29-62: relu or the exact-erf gelu), `SASRecBlock` (:65-121)
and `SASRecStack` (:124-137). Per block, q comes from LN(x) while k and v come
from the un-normalised x; the attention mask is causal only, so padded keys
stay unmasked (the reference's quirk, :5-9); the attention weights drop with
`ffn_dropout_rate`; the FFN runs on LN(q_in + mha) and the block's output is
multiplied by `valid`. The attention is written as JAX writes it (einsums, a
-inf mask, the softmax in f32), not with `scaled_dot_product_attention`.
Each Linear computes in `compute_dtype` with f32 parameters and rounds where
the flax `Dense(dtype=...)` and the einsums' `preferred_element_type` round.
Parameter names follow the flax tree (`sasrec.block_0.q_proj.weight`,
`sasrec.block_0.ffn.fc1.bias`, ...). Every dropout draws from the caller's
`torch.Generator`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rails_tpu_torch.core.config import SASRecConfig
from rails_tpu_torch.similarity.layers import (
    dense,
    dropout,
    layer_norm_in_dtype,
    linear,
    xavier_normal,
)

LN_EPS = 1e-8


def _xavier_linear(in_features: int, out_features: int, generator: torch.Generator) -> nn.Linear:
    return linear(in_features, out_features,
                  xavier_normal((out_features, in_features), generator))


class PointwiseFFN(nn.Module):
    """Linear(hidden) -> relu or gelu -> dropout -> Linear(D) -> dropout, plus
    the input (`PointwiseFFN`, a kernel-size-1 convolution in the reference)."""

    def __init__(self, d: int, hidden_dim: int, activation: str, dropout_rate: float,
                 compute_dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        self.fc1 = _xavier_linear(d, hidden_dim, generator)
        self.fc2 = _xavier_linear(hidden_dim, d, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = dense(x, self.fc1, self.compute_dtype)
        y = F.relu(y) if self.activation == "relu" else F.gelu(y, approximate="none")
        if train:
            y = dropout(y, self.dropout_rate, generator)
        y = dense(y, self.fc2, self.compute_dtype)
        if train:
            y = dropout(y, self.dropout_rate, generator)
        return y + x


class SASRecBlock(nn.Module):
    """Q = LN(x); y = MHA(Q, x, x, causal); out = FFN(LN(Q + y)) * valid."""

    def __init__(self, cfg: SASRecConfig, compute_dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        d = cfg.embedding_dim
        if d % cfg.num_heads:
            raise ValueError(f"SASRec: embedding_dim {d} is not a multiple of "
                             f"num_heads {cfg.num_heads}")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, _xavier_linear(d, d, generator))
        self.ffn = PointwiseFFN(d, cfg.ffn_hidden_dim, cfg.ffn_activation_fn,
                                cfg.ffn_dropout_rate, compute_dtype, generator)

    def forward(self, x: torch.Tensor, valid: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c, dt = self.cfg, self.compute_dtype
        b, n, d = x.shape
        h = c.num_heads
        dh = d // h
        q_in = layer_norm_in_dtype(x, LN_EPS)
        qh = dense(q_in, self.q_proj, dt).reshape(b, n, h, dh)
        kh = dense(x, self.k_proj, dt).reshape(b, n, h, dh)
        vh = dense(x, self.v_proj, dt).reshape(b, n, h, dh)
        scale = torch.sqrt(torch.tensor(dh, dtype=dt, device=x.device))
        logits = torch.einsum("bnhd,bmhd->bhnm", qh, kh) / scale
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, float("-inf"))
        attn = torch.softmax(logits.float(), dim=-1).to(dt)
        if train:
            attn = dropout(attn, c.ffn_dropout_rate, generator)
        mha = torch.einsum("bhnm,bmhd->bnhd", attn, vh).reshape(b, n, d)
        mha = dense(mha, self.out_proj, dt)
        y = self.ffn(layer_norm_in_dtype(q_in + mha, LN_EPS), train, generator)
        return y * valid[..., None].to(y.dtype)


class SASRecStack(nn.Module):
    """`num_blocks` SASRec blocks; timestamps are taken and ignored, as the
    JAX stack's uniform interface does."""

    def __init__(self, cfg: SASRecConfig, compute_dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_blocks):
            self.add_module(f"block_{i}", SASRecBlock(cfg, compute_dtype, generator))

    def forward(self, x: torch.Tensor, valid: torch.Tensor,
                timestamps: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del timestamps
        for i in range(self.cfg.num_blocks):
            x = getattr(self, f"block_{i}")(x, valid, train, generator)
        return x
