"""AdamW with optax's `adamw` semantics; large leaves through one fused pass (K7).

Counterpart of `rails_tpu/train/fused_adamw.py`: `FusedAdamWState(count, mu,
nu)` (:35-38) and `fused_adamw` (:106-168). The step evaluates the learning
rate at the pre-increment count and the bias corrections c1 = 1/(1 - b1^t),
c2 = 1/(1 - b2^t) at the post-increment count, all in float32 (:133-146);
weight decay applies to every leaf, as optax's `adamw` has no mask. Leaves of
at least `min_fused_elements` elements whose size divides by 128 go through
the kernel, the others through its plain version: the JAX package's routing
(:149).

`adamw_update_leaves` replaces the Pallas kernel `_fused_leaf_update`
(:67-103, `pallas_call` :87) with `csrc/fused_adamw.cu`: one launch updates
p, mu and nu of every leaf it is given in place (the JAX kernel returns the
update u of one leaf; `optax.apply_updates` then adds it), so
`FusedAdamW.step` makes one launch per step for its fused leaves. The leaves
are checked once per call. `adamw_leaf_update` is its one-leaf form. The plain
version `adamw_update_leaves_reference` (a loop over
`adamw_leaf_update_reference`) does the same separately rounded f32
operations in the same order, so the two agree bit for bit. It follows the
port's dispatch rule: CPU tensors run the plain version, CUDA tensors launch
the kernel or raise. `adamw_update_leaves.launches` counts kernel launches.
Neither is `torch.optim.AdamW`, whose rounding order differs.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

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


Leaf = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]   # g, p, mu, nu

MAX_LEAVES = 48   # the kernel's leaf table (`csrc/fused_adamw.cu:kMaxLeaves`)


def adamw_update_leaves_reference(
    leaves: Sequence[Leaf], *,
    lr: float, c1: float, c2: float, b1: float, b2: float, eps: float, wd: float,
) -> None:
    """Plain version of `adamw_update_leaves`: each leaf in turn."""
    for g, p, mu, nu in leaves:
        adamw_leaf_update_reference(g, p, mu, nu, lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps,
                                    wd=wd)


def leaf_table(leaves: Sequence[Leaf], device: torch.device) -> list:
    """The kernel's table of `leaves`: the p, then mu, nu and g pointers of
    every leaf, then their sizes. Raises unless every leaf is four
    contiguous, 16-byte aligned f32 tensors of one shape on `device`."""
    ptrs = ([], [], [], [])   # p, mu, nu, g
    for k, leaf in enumerate(leaves):
        shape = leaf[1].shape
        for name, t, col in zip(("g", "p", "mu", "nu"), leaf, (3, 0, 1, 2)):
            if t.device != device:
                raise ValueError(f"adamw_update_leaves: leaf {k}: {name} lies on {t.device}, "
                                 f"not {device}")
            if t.dtype != torch.float32 or t.shape != shape or not t.is_contiguous():
                raise ValueError(f"adamw_update_leaves: leaf {k}: {name} must be a contiguous "
                                 f"f32 {tuple(shape)}")
            ptr = t.data_ptr()
            if ptr % 16:
                raise ValueError(f"adamw_update_leaves: leaf {k}: {name} is not 16-byte aligned")
            ptrs[col].append(ptr)
    return [*ptrs[0], *ptrs[1], *ptrs[2], *ptrs[3], *(leaf[1].numel() for leaf in leaves)]


def adamw_update_leaves(
    leaves: Sequence[Leaf], *,
    lr: float, c1: float, c2: float, b1: float, b2: float, eps: float, wd: float,
) -> None:
    """One fused AdamW pass over every (g, p, mu, nu) leaf, in one launch
    per `MAX_LEAVES` leaves; p, mu and nu are updated in place. Same
    arguments as the plain version."""
    leaves = list(leaves)
    if not leaves:
        return
    device = leaves[0][1].device
    if not use_kernel(leaves[0][1]):   # the first p picks the route; every tensor must follow
        use_kernel(*(t for leaf in leaves for t in leaf))
        adamw_update_leaves_reference(leaves, lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps, wd=wd)
        return
    tables = [leaf_table(leaves[first:first + MAX_LEAVES], device)
              for first in range(0, len(leaves), MAX_LEAVES)]
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for table in tables:
            err = lib.rails_adamw_update_leaves(
                len(table) // 5, (ctypes.c_longlong * len(table))(*table), b1, 1.0 - b1, b2,
                1.0 - b2, eps, wd, lr, c1, c2, stream)
            _build.check(lib, err, "adamw_update_leaves")
            adamw_update_leaves.launches += 1


adamw_update_leaves.launches = 0


def adamw_leaf_update(
    g: torch.Tensor, p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, *,
    lr: float, c1: float, c2: float, b1: float, b2: float, eps: float, wd: float,
) -> None:
    """`adamw_update_leaves` over one leaf; same arguments as
    `adamw_leaf_update_reference`."""
    adamw_update_leaves([(g, p, mu, nu)], lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps, wd=wd)


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
        fused, plain = [], []
        for name, p in self.params.items():
            g = grads.get(name)
            g = torch.zeros_like(p) if g is None else g.contiguous()
            leaf = (g, p.data, st.mu[name], st.nu[name])
            (fused if self.fused(p.numel()) else plain).append(leaf)
        adamw_update_leaves(fused, **kw)
        adamw_update_leaves_reference(plain, **kw)
        st.count += 1
