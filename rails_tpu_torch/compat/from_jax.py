"""Carry a `rails_tpu` model's weights and optimizer state into the port.

`state_dict_from_jax_params` takes the JAX package's `{"params": tree}` with
numpy leaves (the caller converts, e.g.
`jax.tree_util.tree_map(np.asarray, params)`) and returns the state dict that
`SequentialRecommender.load_state_dict(strict=True)` accepts. The port's
parameter names are the flax tree's paths joined by dots; a flax `Dense`
`kernel` (in, out) becomes a torch `Linear` `weight` (out, in).
`adamw_state_from_jax` carries the JAX optimizer state the same way into the
port's `FusedAdamWState`: a `FusedAdamWState(count, mu, nu)` or optax's
`adamw` chain (`fused_optimizer=False`), whose `ScaleByAdamState(count, mu,
nu)` it finds in the chain. `flax_names` is the inverse of the naming rule:
a port state dict back to the flax tree. `fused_tables_from_jax` carries a JAX
`FusedCorpusTables` (int8 codes and scales included) into the port's. This
module imports no jax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from rails_tpu_torch.core.config import ExperimentConfig
from rails_tpu_torch.ops.mol_scoring import FusedCorpusTables
from rails_tpu_torch.train.fused_adamw import FusedAdamWState


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = np.asarray(value)
    return out


def state_dict_from_jax_params(
    params: Mapping, cfg: ExperimentConfig
) -> Dict[str, torch.Tensor]:
    """Port state dict of a JAX `SequentialRecommender` built from `cfg`:
    HSTU or SASRec, MoL or DotProduct (which has no parameters), any input
    preprocessor and embedding module. The port's modules carry the flax
    names, so the tree maps by name alone."""
    if cfg.model_type not in ("HSTU", "SASRec") or cfg.similarity_type not in ("MoL",
                                                                                "DotProduct"):
        raise ValueError(f"{cfg.model_type}/{cfg.similarity_type} is not a model of the "
                         "JAX package")
    return _port_names(params)


def _port_names(tree: Mapping) -> Dict[str, torch.Tensor]:
    """{"params": tree} -> {port parameter name: f32 tensor}."""
    state: Dict[str, torch.Tensor] = {}
    for name, value in _flatten(tree["params"]).items():
        if name.endswith(".kernel"):          # flax Dense -> torch Linear
            name = name[: -len("kernel")] + "weight"
            value = value.T
        state[name] = torch.tensor(np.ascontiguousarray(value), dtype=torch.float32)
    return state


def flax_names(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of `_port_names`: {port parameter name: tensor} ->
    {"params": tree}, a torch `Linear` `weight` (out, in) back to a flax
    `kernel` (in, out) as a transposed view; the leaves stay tensors on
    their device."""
    tree: dict = {}
    for name, value in state_dict.items():
        if name.endswith(".weight"):
            name, value = name[: -len("weight")] + "kernel", value.T
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return {"params": tree}


def _adam_moments(node: Any) -> Any:
    """The node of an optimizer state that holds (count, mu, nu): the state
    itself, or its member inside optax's chain tuple."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node
    if isinstance(node, (tuple, list)):
        for member in node:
            found = _adam_moments(member)
            if found is not None:
                return found
    return None


def adamw_state_from_jax(opt_state: Any) -> FusedAdamWState:
    """The port's optimizer state from a JAX optimizer state with numpy
    leaves: `FusedAdamWState(count, mu, nu)` (`rails_tpu/train/fused_adamw.py:
    35-38`, `fused_optimizer=True`) or the chain state of `optax.adamw`
    (`fused_optimizer=False`), whose `ScaleByAdamState` holds the same count
    and moments. Assign it to `FusedAdamW.state` after moving the moments to
    the parameters' device."""
    adam = _adam_moments(opt_state)
    if adam is None:
        raise ValueError(f"no AdamW moments (count, mu, nu) in {type(opt_state).__name__}")
    return FusedAdamWState(
        count=int(np.asarray(adam.count)),
        mu=_port_names(adam.mu),
        nu=_port_names(adam.nu),
    )


def fused_tables_from_jax(ft: Any) -> FusedCorpusTables:
    """The port's kernel-layout tables from a JAX `FusedCorpusTables`
    (`rails_tpu/ops/pallas/mol_scoring.py:487-503`) with numpy leaves: the
    same bytes (bf16 leaves as ml_dtypes arrays), with the gating partial's
    rows put back from the JAX kernel's m-major logit order (l' = m*P_Q + n)
    into the port's n-major one (the inverse, `_inv_m_major_perm`,
    `rails_tpu/index/top_k.py:1172-1179`). The per-item scales keep their
    order."""
    comp = _tensor(ft.item_comp_t)
    p_x = comp.shape[0]
    partial = _tensor(ft.item_partial_t)
    p_q = partial.shape[0] // p_x
    inv = [m * p_q + n for n in range(p_q) for m in range(p_x)]
    scales = [None if t is None else _tensor(t) for t in (ft.comp_scale, ft.partial_scale)]
    return FusedCorpusTables(comp, partial[inv].contiguous(), int(ft.num_items), *scales)


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes: no numpy bf16 in torch.from_numpy
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())
