"""MLP building blocks of the MoL similarity, and the initialisers they use.

Counterpart of `rails_tpu/similarity/layers.py`. flax `Dense` layers become
torch `Linear`s (weight (out, in) = the flax kernel transposed). Each module
computes in its `compute_dtype` with float32 parameters, as the flax modules
compute in `dtype`. Dropout (`dropout`) acts only in training and draws its
keep mask from an explicit `torch.Generator` on the tensor's device.

Parameters are initialised from an explicit `torch.Generator` with the flax
initialisers' distributions, so a seed gives the same weights on any device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rails_tpu_torch.core.distributed import draw_rows

# Standard deviation of the unit normal truncated to [-2, 2]
# (flax `variance_scaling(..., "truncated_normal")`).
_TRUNC_STD = 0.87962566103423978


def normal(shape: Tuple[int, ...], std: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).normal_(0.0, std, generator=generator)


def truncated_normal(
    shape: Tuple[int, ...], std: float, generator: torch.Generator
) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times std (`jax.random.truncated_normal`)."""
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * std


def xavier_normal(shape: Tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """flax `xavier_normal` (fan-average, truncated normal); symmetric in
    the two fans, so it serves flax (in, out) and torch (out, in) shapes."""
    fan_in, fan_out = shape[-2], shape[-1]
    std = math.sqrt(2.0 / (fan_in + fan_out)) / _TRUNC_STD
    return truncated_normal(shape, std, generator)


def xavier_uniform(shape: Tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


def linear(
    in_features: int, out_features: int, weight: torch.Tensor, bias: bool = True
) -> nn.Linear:
    """A torch Linear holding `weight` (out, in) and a zero bias."""
    lin = nn.Linear(in_features, out_features, bias=bias, device="meta")
    lin.weight = nn.Parameter(weight)
    if bias:
        lin.bias = nn.Parameter(torch.zeros(out_features))
    return lin


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax `Dense(dtype=...)`: inputs and parameters cast to `dtype`."""
    b = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), b)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout` in training: keep with probability 1 - rate, kept
    values divided by 1 - rate. The identity at rate 0."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep_prob = 1.0 - rate
    # Under a data-parallel row shard: the global batch's mask, this rank's rows.
    keep = draw_rows(lambda shape: torch.empty(shape, dtype=torch.bool, device=x.device)
                     .bernoulli_(keep_prob, generator=generator), x.shape)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def l2_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x / max(||x||_2, eps) along the last axis, as sqrt(max(sq, eps^2))
    (`layers.py:23-34`)."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


def layer_norm_in_dtype(y: torch.Tensor, eps: float) -> torch.Tensor:
    """Parameter-free LayerNorm over the last axis in y's dtype, as
    `jnp.mean` / `jnp.var` compute it: the mean and the variance accumulate
    in f32 and round to y's dtype, then every step rounds to it."""
    yf = y.float()
    mu = yf.mean(dim=-1, keepdim=True).to(y.dtype)
    var = yf.var(dim=-1, keepdim=True, unbiased=False).to(y.dtype)
    return (y - mu) * torch.rsqrt(var + eps)


class GLU(nn.Module):
    """One 2x-wide Linear, split, act(lhs) * rhs; lhs is the first half
    (`layers.py:37-66`). "gelu" is the exact erf GeLU."""

    def __init__(
        self, in_features: int, features: int, activation: str,
        compute_dtype: torch.dtype, generator: torch.Generator,
    ):
        super().__init__()
        if activation not in ("gelu", "silu"):
            raise ValueError(f"Unknown GLU activation {activation!r}")
        self.activation = activation
        self.compute_dtype = compute_dtype
        self.w = linear(
            in_features, 2 * features, normal((2 * features, in_features), 0.02, generator)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lhs, rhs = torch.chunk(dense(x, self.w, self.compute_dtype), 2, dim=-1)
        if self.activation == "gelu":
            lhs = F.gelu(lhs, approximate="none")
        else:
            lhs = F.silu(lhs)
        return lhs * rhs


class ProjMLP(nn.Module):
    """Dropout -> [GLU(hidden)] -> Linear(out) (`layers.py:69-95`); with
    hidden_dim <= 0 Dropout -> Linear."""

    def __init__(
        self, in_features: int, out_features: int, hidden_dim: int, nonlinearity: str,
        compute_dtype: torch.dtype, generator: torch.Generator, dropout_rate: float = 0.0,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dropout_rate = dropout_rate
        self.glu: Optional[GLU] = None
        width = in_features
        if hidden_dim > 0:
            act = "gelu" if nonlinearity == "geglu" else "silu"
            self.glu = GLU(in_features, hidden_dim, act, compute_dtype, generator)
            width = hidden_dim
        self.out = linear(
            width, out_features, xavier_normal((out_features, width), generator)
        )

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if train:
            x = dropout(x, self.dropout_rate, generator)
        if self.glu is not None:
            x = self.glu(x)
        return dense(x, self.out, self.compute_dtype)


class GatingPartialMLP(nn.Module):
    """Dropout -> Linear(hidden) -> SiLU -> Linear(out) (`layers.py:98-132`);
    with hidden_dim <= 0 Dropout -> Linear."""

    def __init__(
        self, in_features: int, out_features: int, hidden_dim: int, use_output_bias: bool,
        compute_dtype: torch.dtype, generator: torch.Generator, dropout_rate: float = 0.0,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dropout_rate = dropout_rate
        self.hidden: Optional[nn.Linear] = None
        width = in_features
        if hidden_dim > 0:
            self.hidden = linear(
                in_features, hidden_dim, xavier_normal((hidden_dim, in_features), generator)
            )
            width = hidden_dim
        self.out = linear(
            width, out_features, xavier_normal((out_features, width), generator),
            bias=use_output_bias,
        )

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if train:
            x = dropout(x, self.dropout_rate, generator)
        if self.hidden is not None:
            x = F.silu(dense(x, self.hidden, self.compute_dtype))
        return dense(x, self.out, self.compute_dtype)
