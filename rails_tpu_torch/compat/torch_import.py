"""Import checkpoints of the original torch implementation into the port.

Counterpart of `rails_tpu/compat/torch_import.py`. The original repo saves
`torch.save({"epoch", "batch_id", "model_state_dict",
"optimizer_state_dict"})` (its `train.py:538-547`); the model is
DDP-wrapped, so every key carries a `module.` prefix, and older checkpoints
spell the MoL item projection `_item_proj_module` instead of
`_item_embeddings_fn._item_emb_proj_module`. The conversion builds the same
flax-named tree as the JAX package (`params_from_reference_state_dict`) and
then turns it into the port's names with the one naming rule of
`compat/from_jax.py` (`_port_names`: a flax `kernel` (in, out) becomes a
torch `Linear` `weight` (out, in)):

    state_dict, epoch, batch_id = import_torch_checkpoint(path, cfg)

or, end to end, `python -m rails_tpu_torch.cli.import_checkpoint`, which
writes a checkpoint that `cli/eval.py --ckpt` and `cli/train.py
--restore-from-ckpt` restore.

The result is checked against a fresh model for `cfg` (built on the meta
device, so no weight is drawn): a missing or unexpected parameter, or one of
another shape, raises with every offending name.

AdamW moments import too (`optimizer_state_from_reference`): the reference
keys its AdamW state by position in `model.parameters()`, which is the
order of the checkpoint's own `model_state_dict` with the buffers removed,
so each `exp_avg` / `exp_avg_sq` is found by name and goes through its
parameter's conversion (permutations, transposes and stacks, which commute
with the elementwise update). The result is the port's
`FusedAdamWState(count, mu, nu)`, which serves both `train.fused_optimizer`
settings. Nothing here sorts keys.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from rails_tpu_torch.compat.from_jax import _port_names
from rails_tpu_torch.core.config import ExperimentConfig
from rails_tpu_torch.train.fused_adamw import FusedAdamWState

# Substring renames applied to legacy checkpoints (the original repo's
# `eval_from_checkpoint.py:366-374` renames the item-proj linear; matching on
# the module path covers both .weight and .bias).
_LEGACY_RENAMES = {
    "_ndp_module._item_proj_module.":
        "_ndp_module._item_embeddings_fn._item_emb_proj_module.",
}


def _to_numpy(v: Any) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    if not hasattr(v, "detach"):
        # A plain Python number: AdamW's `step` in torch < 2.0 state dicts.
        return np.asarray(v)
    t = v.detach().cpu()
    if t.dtype == torch.bfloat16:      # numpy has no bf16
        t = t.float()
    return t.numpy()


def normalize_state_dict(state_dict: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Strip the DDP `module.` prefix, apply the legacy renames, drop the
    buffers that are not trained, convert values to numpy; the checkpoint's
    key order is kept."""
    out: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        for old, new in _LEGACY_RENAMES.items():
            if old in key:
                key = key.replace(old, new)
                break
        # The causal mask (HSTU, SASRec) and the categorical id -> category
        # remap, which the port takes from the data.
        if key.endswith(("_attn_mask", "_item_id_to_category_id")):
            continue
        out[key] = _to_numpy(value)
    return out


def _require(ok: bool, message: str) -> None:
    """A check on the checkpoint, which comes from outside the program."""
    if not ok:
        raise ValueError(f"reference checkpoint: {message}")


class _StateView:
    """Dict view that records consumption so leftovers can be reported."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        self._sd = sd
        self._used = set()

    def take(self, key: str) -> np.ndarray:
        if key not in self._sd:
            raise KeyError(
                f"reference checkpoint is missing {key!r}; nearest keys: "
                f"{[k for k in self._sd if k.split('.')[-1] == key.split('.')[-1]][:4]}")
        self._used.add(key)
        return self._sd[key]

    def has(self, key: str) -> bool:
        return key in self._sd

    def keys_under(self, prefix: str):
        return [k for k in self._sd if k.startswith(prefix)]

    def unused(self):
        return sorted(set(self._sd) - self._used)


def _dense(sv: _StateView, prefix: str) -> dict:
    """torch Linear at `prefix` -> flax Dense {kernel (in, out)[, bias]}."""
    p = {"kernel": sv.take(prefix + ".weight").T}
    if sv.has(prefix + ".bias"):
        p["bias"] = sv.take(prefix + ".bias")
    return p


def _linear_indices(sv: _StateView, prefix: str):
    """Sorted integer child indices of a torch Sequential that hold weights
    (Dropout layers shift the positions)."""
    idx = set()
    for k in sv.keys_under(prefix + "."):
        m = re.match(re.escape(prefix) + r"\.(\d+)\.", k)
        if m:
            idx.add(int(m.group(1)))
    return sorted(idx)


def _proj_mlp(sv: _StateView, prefix: str) -> dict:
    """proj_fn Sequential -> ProjMLP: (Dropout, GeGLU/SwiGLU, Linear) with a
    hidden layer, else (Dropout, Linear). The GLU bias is stored (1, H)."""
    idx = _linear_indices(sv, prefix)
    if len(idx) == 2:
        glu_prefix = f"{prefix}.{idx[0]}"
        return {
            "glu": {"w": {
                "kernel": sv.take(glu_prefix + "._w"),
                "bias": sv.take(glu_prefix + "._b")[0],
            }},
            "out": _dense(sv, f"{prefix}.{idx[1]}"),
        }
    _require(len(idx) == 1, f"unexpected proj MLP layout under {prefix}: {idx}")
    return {"out": _dense(sv, f"{prefix}.{idx[0]}")}


def _gating_mlp(sv: _StateView, prefix: str) -> dict:
    """Gating partial Sequential ([Dropout?] Linear SiLU Linear [Dropout?])
    -> GatingPartialMLP."""
    idx = _linear_indices(sv, prefix)
    if len(idx) == 2:
        return {
            "hidden": _dense(sv, f"{prefix}.{idx[0]}"),
            "out": _dense(sv, f"{prefix}.{idx[1]}"),
        }
    _require(len(idx) == 1, f"unexpected gating MLP layout under {prefix}: {idx}")
    return {"out": _dense(sv, f"{prefix}.{idx[0]}")}


def _mol_params(sv: _StateView, prefix: str = "_ndp_module.") -> dict:
    """The reference's `MoLSimilarity` state -> the `mol` tree."""
    p = {
        "query_proj": _proj_mlp(sv, prefix + "_query_embeddings_fn._query_emb_proj_module"),
        "item_proj": _proj_mlp(sv, prefix + "_item_embeddings_fn._item_emb_proj_module"),
        "gating_qi": _gating_mlp(sv, prefix + "_gating_fn._qi_partial_module"),
    }
    i = 0
    while sv.has(prefix + f"_query_embeddings_fn._uid_embeddings_{i}.weight"):
        p[f"uid_embeddings_{i}"] = {
            "embedding": sv.take(prefix + f"_query_embeddings_fn._uid_embeddings_{i}.weight")
        }
        i += 1
    if sv.keys_under(prefix + "_gating_fn._query_only_partial_module"):
        p["gating_query"] = _gating_mlp(sv, prefix + "_gating_fn._query_only_partial_module")
    if sv.keys_under(prefix + "_gating_fn._item_only_partial_module"):
        p["gating_item"] = _gating_mlp(sv, prefix + "_gating_fn._item_only_partial_module")
    return p


def _hstu_params(sv: _StateView) -> dict:
    """The reference's `HSTUJagged` layers -> the `hstu` tree, the per-layer
    relative-bias tables stacked into (L, ...) arrays."""
    layers = sorted({
        int(re.match(r"_hstu\._attention_layers\.(\d+)\.", k).group(1))
        for k in sv.keys_under("_hstu._attention_layers.")
    })
    _require(layers == list(range(len(layers))), f"HSTU layers {layers} are not 0..L-1")
    tree: dict = {}
    if sv.has("_hstu._attention_layers.0._rel_attn_bias._pos_w"):
        tree["rel_attn_bias"] = {
            name: np.stack([sv.take(f"_hstu._attention_layers.{i}._rel_attn_bias._{name}")
                            for i in layers])
            for name in ("pos_w", "ts_w")
        }
    for i in layers:
        pre = f"_hstu._attention_layers.{i}"
        tree[f"block_{i}"] = {
            "uvqk": sv.take(pre + "._uvqk"),
            "o_kernel": sv.take(pre + "._o.weight").T,
            "o_bias": sv.take(pre + "._o.bias"),
        }
    return tree


def _sasrec_params(sv: _StateView, d_model: int) -> dict:
    """The reference's `SASRec` (nn.MultiheadAttention + Conv1d FFN) -> the
    `sasrec` tree."""
    layers = sorted({
        int(re.match(r"attention_layers\.(\d+)\.", k).group(1))
        for k in sv.keys_under("attention_layers.")
    })
    tree: dict = {}
    d = d_model
    for i in layers:
        w = sv.take(f"attention_layers.{i}.in_proj_weight")       # (3D, D)
        b = sv.take(f"attention_layers.{i}.in_proj_bias")         # (3D,)
        _require(w.shape == (3 * d, d), f"in_proj_weight {w.shape} is not (3 x {d}, {d})")
        ffn = f"forward_layers.{i}._conv1d"
        tree[f"block_{i}"] = {
            "q_proj": {"kernel": w[:d].T, "bias": b[:d]},
            "k_proj": {"kernel": w[d: 2 * d].T, "bias": b[d: 2 * d]},
            "v_proj": {"kernel": w[2 * d:].T, "bias": b[2 * d:]},
            "out_proj": _dense(sv, f"attention_layers.{i}.out_proj"),
            "ffn": {
                # Conv1d(D, H, kernel_size=1).weight is (H, D, 1).
                "fc1": {"kernel": sv.take(ffn + ".0.weight")[:, :, 0].T,
                        "bias": sv.take(ffn + ".0.bias")},
                "fc2": {"kernel": sv.take(ffn + ".3.weight")[:, :, 0].T,
                        "bias": sv.take(ffn + ".3.bias")},
            },
        }
    return tree


def _preproc_params(sv: _StateView, cfg: ExperimentConfig) -> dict:
    p = {"pos_emb": sv.take("_input_features_preproc._pos_emb.weight")}
    if cfg.input_preprocessor_type in ("rated", "combined"):
        p["rating_emb"] = sv.take("_input_features_preproc._rating_emb.weight")
    return p


def params_from_reference_state_dict(
    state_dict: Dict[str, Any], cfg: ExperimentConfig, strict: bool = True,
) -> dict:
    """A reference `model_state_dict` as the JAX package's `{"params":
    tree}` with numpy leaves. With `strict`, reference keys the conversion
    does not consume raise."""
    sv = _StateView(normalize_state_dict(state_dict))
    tree: dict = {
        "item_emb": {"embedding": sv.take("_embedding_module._item_emb.weight")},
        "input_preproc": _preproc_params(sv, cfg),
    }
    if cfg.model_type == "HSTU":
        tree["hstu"] = _hstu_params(sv)
    elif cfg.model_type == "SASRec":
        d_model = cfg.train.item_embedding_dim
        if cfg.input_preprocessor_type == "rated":
            d_model += cfg.rating_embedding_dim
        tree["sasrec"] = _sasrec_params(sv, d_model)
    else:
        raise ValueError(f"Unknown model_type {cfg.model_type!r}")
    if cfg.similarity_type == "MoL":
        tree["mol"] = _mol_params(sv)
    # The dot-product similarity has no parameters on either side.
    if strict and sv.unused():
        raise ValueError(
            "reference checkpoint keys not consumed by the conversion "
            f"(pass strict=False to ignore): {sv.unused()}")
    return {"params": tree}


def infer_num_items(state_dict: Dict[str, torch.Tensor], cfg: ExperimentConfig,
                    num_items: int | None) -> int:
    """`num_items`, or the item table's rows less the padding row."""
    if num_items is not None:
        return num_items
    if cfg.embedding_module_type == "categorical":
        raise ValueError(
            "categorical embedding checkpoints store a (num_categories"
            " + 1, D) table, so num_items (the max item id) cannot be"
            " inferred from it — pass num_items explicitly")
    return state_dict["item_emb.embedding"].shape[0] - 1


def fresh_model(cfg: ExperimentConfig, num_items: int, device: Any = "meta"):
    """The port's model for `cfg` with its parameters unset: built on the
    meta device, so nothing is drawn even for a table of 695,763 rows
    (on another `device` the parameters are allocated and left unset). The
    categorical remap is a placeholder of zeros: it is no part of the state
    dict."""
    from rails_tpu_torch.models.encoder import SequentialRecommender

    remap = (np.zeros((num_items,), np.int32)
             if cfg.embedding_module_type == "categorical" else None)
    with torch.device("meta"):
        model = SequentialRecommender(cfg, num_items, device="meta",
                                      item_id_to_category_id=remap)
    if str(device) == "meta":
        return model
    model.to_empty(device=device)
    for buf in model.buffers():      # the placeholder remap, zeros again
        buf.zero_()
    return model


def validate_state_dict(state_dict: Dict[str, torch.Tensor], cfg: ExperimentConfig,
                        num_items: int) -> None:
    """Require the names and shapes of a fresh model for `cfg`; every
    problem is listed."""
    expected = {k: tuple(v.shape) for k, v in fresh_model(cfg, num_items).state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    problems = []
    for name, shape in expected.items():
        if name not in got:
            problems.append(f"missing from checkpoint: {name} {shape}")
        elif got[name] != shape:
            problems.append(f"shape mismatch at {name}: checkpoint {got[name]} vs model {shape}")
    problems += [f"unexpected in checkpoint: {name}" for name in got if name not in expected]
    if problems:
        raise ValueError(
            "converted checkpoint does not fit the model for config "
            f"{cfg.name!r}:\n  " + "\n  ".join(problems))


def state_dict_from_reference(
    state_dict: Dict[str, Any],
    cfg: ExperimentConfig,
    num_items: int | None = None,
    strict: bool = True,
    validate: bool = True,
) -> Dict[str, torch.Tensor]:
    """A reference `model_state_dict` as the port's state dict (f32 CPU
    tensors) that `SequentialRecommender.load_state_dict(strict=True)`
    takes. `num_items` defaults to the item table's rows less the padding
    row; with `validate` the result is checked against a fresh model."""
    sd = _port_names(params_from_reference_state_dict(state_dict, cfg, strict=strict))
    if validate:
        validate_state_dict(sd, cfg, infer_num_items(sd, cfg, num_items))
    return sd


def optimizer_state_from_reference(
    opt_state_dict: Dict[str, Any],
    model_state_dict: Dict[str, Any],
    cfg: ExperimentConfig,
    state_dict: Dict[str, torch.Tensor],
) -> FusedAdamWState:
    """A reference `optimizer_state_dict` (torch AdamW) as the port's
    `FusedAdamWState`, whose count is the reference's step. `state_dict` is
    the converted weights of the same checkpoint; the moments must match
    its names and shapes. Parameters are matched to positions through the
    order of `model_state_dict` without its buffers."""
    norm_keys = list(normalize_state_dict(model_state_dict))
    order = [idx for group in opt_state_dict["param_groups"] for idx in group["params"]]
    _require(len(order) == len(norm_keys),
             f"optimizer tracks {len(order)} params, model has {len(norm_keys)}")
    key_of_idx = {idx: norm_keys[pos] for pos, idx in enumerate(order)}

    state = opt_state_dict.get("state", {})
    steps = set()
    moments: Dict[str, Dict[str, np.ndarray]] = {"exp_avg": {}, "exp_avg_sq": {}}
    missing = []
    for idx, key in key_of_idx.items():
        entry = state.get(idx, state.get(str(idx)))
        if entry is None:
            missing.append(key)
            continue
        steps.add(int(_to_numpy(entry["step"])))
        moments["exp_avg"][key] = _to_numpy(entry["exp_avg"])
        moments["exp_avg_sq"][key] = _to_numpy(entry["exp_avg_sq"])
    # torch AdamW keeps a step per parameter and makes its state lazily; the
    # port keeps one count. Zero moments under the shared count would
    # silently break a parameter's bias correction, so refuse.
    if missing or len(steps) > 1:
        raise ValueError(
            "reference optimizer state is not representable with a single "
            f"step count (params never stepped: {missing[:4]}"
            f"{'...' if len(missing) > 4 else ''}; distinct steps: "
            f"{sorted(steps)}). Import the model weights only "
            "(--skip-optimizer / import_torch_checkpoint).")
    mu, nu = (state_dict_from_reference(moments[name], cfg, validate=False)
              for name in ("exp_avg", "exp_avg_sq"))
    for name, sd in (("mu", mu), ("nu", nu)):
        shapes = {k: tuple(v.shape) for k, v in sd.items()}
        if shapes != {k: tuple(v.shape) for k, v in state_dict.items()}:
            raise ValueError(f"reference optimizer {name} does not match the model's parameters")
    return FusedAdamWState(count=steps.pop() if steps else 0, mu=mu, nu=nu)


def _load(path: str) -> Tuple[Dict[str, Any], Dict[str, Any], int, int]:
    """(payload, model_state_dict, epoch, batch_id) of a reference file: the
    training payload or a bare `model_state_dict` (epoch and batch_id 0)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = payload.get("model_state_dict", payload)
    return payload, sd, int(payload.get("epoch", 0)), int(payload.get("batch_id", 0))


def import_torch_checkpoint(
    path: str, cfg: ExperimentConfig, num_items: int | None = None, strict: bool = True,
) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Load a reference checkpoint file and convert its weights. Returns
    (state_dict, epoch, batch_id)."""
    _, sd, epoch, batch_id = _load(path)
    return state_dict_from_reference(sd, cfg, num_items=num_items, strict=strict), epoch, batch_id


def import_torch_checkpoint_full(
    path: str, cfg: ExperimentConfig, num_items: int | None = None, strict: bool = True,
) -> Tuple[Dict[str, torch.Tensor], FusedAdamWState, int, int]:
    """As `import_torch_checkpoint`, with the AdamW moments. Returns
    (state_dict, opt_state, epoch, batch_id); without an optimizer state the
    moments are zeros and the count 0."""
    payload, sd, epoch, batch_id = _load(path)
    state_dict = state_dict_from_reference(sd, cfg, num_items=num_items, strict=strict)
    opt_sd = payload.get("optimizer_state_dict") or {}
    if opt_sd.get("param_groups"):
        opt_state = optimizer_state_from_reference(opt_sd, sd, cfg, state_dict)
    else:
        opt_state = FusedAdamWState(
            count=0, mu={k: torch.zeros_like(v) for k, v in state_dict.items()},
            nu={k: torch.zeros_like(v) for k, v in state_dict.items()})
    return state_dict, opt_state, epoch, batch_id
