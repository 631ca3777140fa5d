"""AdamW with optax's `adamw` semantics; large leaves through one fused pass (K7).

Counterpart of `rails_tpu/train/fused_adamw.py`: `FusedAdamWState(count, mu,
nu)` (:35-38) and `fused_adamw` (:106-168). The step evaluates the learning
rate at the pre-increment count and the bias corrections c1 = 1/(1 - b1^t),
c2 = 1/(1 - b2^t) at the post-increment count, all in float32 (:133-146);
weight decay applies to every leaf, as optax's `adamw` has no mask. Leaves of
at least `min_fused_elements` elements whose size divides by 128 go through
`adamw_leaf_update`, the others through its plain version: the JAX package's
routing (:149).

`adamw_leaf_update` replaces the Pallas kernel `_fused_leaf_update`
(:67-103, `pallas_call` :87) with `csrc/fused_adamw.cu`, which updates p, mu
and nu in place (the JAX kernel returns the update u; `optax.apply_updates`
then adds it). The plain version `adamw_leaf_update_reference` does the same
separately rounded f32 operations in the same order, so the two agree bit for
bit. It follows the port's dispatch rule: CPU tensors run the plain version,
CUDA tensors launch the kernel or raise. `adamw_leaf_update.launches` counts
kernel launches. Neither is `torch.optim.AdamW`, whose rounding order
differs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from rails_tpu_torch.core.device import use_kernel
from rails_tpu_torch.ops import _build

Schedule = Callable[[int], float]


@dataclass
class FusedAdamWState:
    """count (steps taken) and the first and second moments by parameter name."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """`optax.linear_schedule`, evaluated in float32 as optax does
    (`(init - end) * frac + end`, the difference taken in Python floats)."""
    span, end = np.float32(init_value - end_value), np.float32(end_value)

    def schedule(count: int) -> float:
        frac = np.float32(1) - np.float32(min(max(count, 0), transition_steps)) / np.float32(
            transition_steps)
        return float(span * frac + end)

    return schedule


def adamw_leaf_update_reference(
    g: torch.Tensor, p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, *,
    lr: float, c1: float, c2: float, b1: float, b2: float, eps: float, wd: float,
) -> None:
    """`_adamw_math` + `apply_updates` in place on f32 p, mu, nu."""
    mu2 = b1 * mu + (1.0 - b1) * g
    nu2 = b2 * nu + (1.0 - b2) * (g * g)
    step = (mu2 * c1) / (torch.sqrt(nu2 * c2) + eps) + wd * p
    p.add_(-lr * step)
    mu.copy_(mu2)
    nu.copy_(nu2)


def adamw_leaf_update(
    g: torch.Tensor, p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, *,
    lr: float, c1: float, c2: float, b1: float, b2: float, eps: float, wd: float,
) -> None:
    """One fused AdamW pass over a leaf; same arguments as
    `adamw_leaf_update_reference`. p, mu and nu are updated in place."""
    kw = dict(lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps, wd=wd)
    if not use_kernel(g, p, mu, nu):
        adamw_leaf_update_reference(g, p, mu, nu, **kw)
        return
    for name, t in (("g", g), ("p", p), ("mu", mu), ("nu", nu)):
        if t.dtype != torch.float32 or t.shape != p.shape or not t.is_contiguous():
            raise ValueError(f"adamw_leaf_update: {name} must be a contiguous f32 {tuple(p.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"adamw_leaf_update: {name} is not 16-byte aligned")
    lib = _build.load_library()
    with torch.cuda.device(p.device):
        err = lib.rails_adamw_update(
            p.data_ptr(), mu.data_ptr(), nu.data_ptr(), g.data_ptr(), p.numel(),
            b1, 1.0 - b1, b2, 1.0 - b2, eps, wd, lr, c1, c2,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "adamw_leaf_update")
    adamw_leaf_update.launches += 1


adamw_leaf_update.launches = 0


class FusedAdamW:
    """`fused_adamw(learning_rate, b1, b2, eps, weight_decay,
    min_fused_elements)` over named f32 parameters, updated in place."""

    def __init__(
        self, params: Mapping[str, torch.Tensor], learning_rate: Union[float, Schedule],
        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4,
        min_fused_elements: Optional[int] = 1 << 21,
    ):
        self.params = dict(params)
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.min_fused_elements = min_fused_elements
        self.state = FusedAdamWState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in self.params.items()},
            nu={k: torch.zeros_like(p, dtype=torch.float32) for k, p in self.params.items()},
        )

    def fused(self, numel: int) -> bool:
        """Whether a leaf of `numel` elements goes through the kernel."""
        m = self.min_fused_elements
        return m is not None and numel >= m and numel % 128 == 0

    @torch.no_grad()
    def step(self, grads: Mapping[str, Optional[torch.Tensor]]) -> None:
        """Apply one update; a missing gradient counts as zeros, as JAX's
        gradient of an unused parameter is."""
        st = self.state
        lr = self.learning_rate
        lr = float(np.float32(lr(st.count) if callable(lr) else lr))
        t = np.float32(st.count + 1)
        c1 = float(np.float32(1) / (np.float32(1) - np.power(np.float32(self.b1), t)))
        c2 = float(np.float32(1) / (np.float32(1) - np.power(np.float32(self.b2), t)))
        kw = dict(lr=lr, c1=c1, c2=c2, b1=self.b1, b2=self.b2, eps=self.eps,
                  wd=self.weight_decay)
        for name, p in self.params.items():
            g = grads.get(name)
            g = torch.zeros_like(p) if g is None else g.contiguous()
            update = adamw_leaf_update if self.fused(p.numel()) else adamw_leaf_update_reference
            update(g, p.data, st.mu[name], st.nu[name], **kw)
        st.count += 1
