"""Import reference gin config files into `ExperimentConfig`.

Counterpart of `rails_tpu/compat/gin_import.py`, over the port's own
`core/config.py`: `parse_gin_bindings` reads the flat `target.param =
<python literal>` bindings the reference's configs use (no macros, scopes or
imports), and `experiment_config_from_gin(path or text)` builds the config
and a `GinImportResult` with the bindings and the `ignored` list. Bindings
that only the reference's CUDA or torch runtime reads are accepted and
recorded in `ignored`:
  - `train_fn.enable_tf32`,
  - `train_fn.eval_user_max_batch_size` (the reference's eval
    micro-batching; eval batches here have fixed rows),
  - `create_data_loader.num_workers` / `.prefetch_factor` (torch DataLoader
    knobs; the loader here prefetches through its own assembler),
  - `create_mol_interaction_module.uid_embedding_l2_weight_decay` (bound in
    the ml-20m sasrec-mol gin but not a parameter of the reference's
    factory; the effective uid L2 weight is `train_fn.loss_weights`).
Any other unknown target or parameter raises. The CLIs take a file through
`--gin-config-file`:

    python -m rails_tpu_torch.cli.train --gin-config-file configs/ml-1m/hstu-mol-...gin
"""

from __future__ import annotations

import ast
import dataclasses
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

from rails_tpu_torch.core.config import (
    DataConfig,
    ExperimentConfig,
    HSTUConfig,
    MoLConfig,
    SASRecConfig,
    TrainConfig,
)

# train_fn params that live outside TrainConfig here.
_TRAIN_FN_SPECIAL = {
    "dataset_name": ("data", "dataset_name"),
    "max_sequence_length": ("data", "max_sequence_length"),
    "positional_sampling_ratio": ("data", "positional_sampling_ratio"),
    "main_module": (None, "model_type"),
    "interaction_module_type": (None, "similarity_type"),
}
_IGNORED = {
    ("train_fn", "enable_tf32"),
    ("train_fn", "eval_user_max_batch_size"),
    ("create_data_loader", "num_workers"),
    ("create_data_loader", "prefetch_factor"),
    ("create_mol_interaction_module", "uid_embedding_l2_weight_decay"),
}

_BINDING_RE = re.compile(
    r"^\s*([A-Za-z_][\w]*)\.([A-Za-z_][\w]*)\s*=\s*(.+?)\s*$"
)


@dataclass
class GinImportResult:
    config: ExperimentConfig
    ignored: List[str]          # accepted-but-inapplicable bindings
    bindings: Dict[Tuple[str, str], Any]


def parse_gin_bindings(text: str) -> Dict[Tuple[str, str], Any]:
    """Parse `target.param = <literal>` lines; comments and blanks skipped."""
    bindings: Dict[Tuple[str, str], Any] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _BINDING_RE.match(line)
        if not m:
            raise ValueError(f"gin line {lineno}: cannot parse {raw!r}")
        target, param, rhs = m.groups()
        # Trailing comments (none of the shipped configs use them inside
        # string values; split conservatively outside quotes).
        if "#" in rhs and not (rhs.startswith(("'", '"'))):
            rhs = rhs.split("#", 1)[0].strip()
        try:
            value = ast.literal_eval(rhs)
        except (SyntaxError, ValueError) as e:
            raise ValueError(
                f"gin line {lineno}: value {rhs!r} is not a python literal"
            ) from e
        bindings[(target, param)] = value
    return bindings


def _fields(cls) -> set:
    return {f.name for f in dataclasses.fields(cls)}


def _adopt_registry_kernel_fields(cfg: ExperimentConfig) -> ExperimentConfig:
    """Copy the kernel toggles (`hstu.fused_train`, `hstu.fused_inference`,
    `train.fused_optimizer`) from the registry config with the same dataset,
    model and similarity, when one exists (the `-fast` variants and
    synthetic-small excepted). The gin surface describes the reference's
    semantics only; without this a gin import of the ml-20m HSTU config
    would train through the XLA block path where `--config ml-20m-hstu-mol`
    trains through K4."""
    from rails_tpu_torch.core.config import get_experiment_config, list_experiment_configs

    for reg_name in list_experiment_configs():
        if reg_name.endswith("-fast") or reg_name == "synthetic-small":
            continue
        reg = get_experiment_config(reg_name)
        if (
            reg.model_type == cfg.model_type
            and reg.similarity_type == cfg.similarity_type
            and reg.data.dataset_name == cfg.data.dataset_name
        ):
            return cfg.replace(
                hstu=cfg.hstu.replace(
                    fused_train=reg.hstu.fused_train,
                    fused_inference=reg.hstu.fused_inference,
                ),
                train=cfg.train.replace(
                    fused_optimizer=reg.train.fused_optimizer,
                ),
            )
    return cfg


def experiment_config_from_gin(
    path_or_text: str, name: str | None = None
) -> GinImportResult:
    """Build an `ExperimentConfig` from a reference gin file (path or text)."""
    import os

    looks_like_text = "\n" in path_or_text or "=" in path_or_text
    if os.path.exists(path_or_text) or not looks_like_text:
        with open(path_or_text) as f:
            text = f.read()
        if name is None:
            name = re.sub(r"\.gin$", "", path_or_text.rsplit("/", 1)[-1])
    else:
        text = path_or_text
    bindings = parse_gin_bindings(text)

    top: Dict[str, Any] = {}
    sub: Dict[str, Dict[str, Any]] = {
        "data": {}, "train": {}, "mol": {}, "hstu": {}, "sasrec": {},
    }
    known = {
        "train": _fields(TrainConfig),
        "data": _fields(DataConfig),
        "mol": _fields(MoLConfig),
        "hstu": _fields(HSTUConfig),
        "sasrec": _fields(SASRecConfig),
    }
    ignored: List[str] = []

    for (target, param), value in bindings.items():
        if (target, param) in _IGNORED:
            ignored.append(f"{target}.{param} = {value!r}")
            continue
        if target == "train_fn":
            if param in _TRAIN_FN_SPECIAL:
                section, field_name = _TRAIN_FN_SPECIAL[param]
                if section is None:
                    top[field_name] = value
                else:
                    sub[section][field_name] = value
                continue
            if param == "loss_weights":
                value = tuple(value.items())
            if param not in known["train"]:
                raise ValueError(f"unknown gin binding train_fn.{param}")
            sub["train"][param] = value
        elif target == "hstu_encoder":
            if param not in known["hstu"]:
                raise ValueError(f"unknown gin binding hstu_encoder.{param}")
            sub["hstu"][param] = value
        elif target == "sasrec_encoder":
            if param not in known["sasrec"]:
                raise ValueError(f"unknown gin binding sasrec_encoder.{param}")
            sub["sasrec"][param] = value
        elif target == "create_mol_interaction_module":
            if param == "uid_embedding_hash_sizes":
                value = tuple(value)
            if param not in known["mol"]:
                raise ValueError(
                    f"unknown gin binding create_mol_interaction_module.{param}"
                )
            sub["mol"][param] = value
        elif target == "get_similarity_function":
            if param != "bf16_training":
                raise ValueError(
                    f"unknown gin binding get_similarity_function.{param}"
                )
            sub["mol"]["bf16_training"] = value
        else:
            raise ValueError(f"unknown gin target {target!r}")

    # The reference threads item_embedding_dim from train_fn into the encoder
    # and both MoL sides (`train.py:188-259`, `encoder_utils.py:113-148`).
    d = sub["train"].get("item_embedding_dim", TrainConfig.item_embedding_dim)
    sub["hstu"].setdefault("embedding_dim", d)
    sub["sasrec"].setdefault("embedding_dim", d)
    sub["mol"].setdefault("query_embedding_dim", d)
    sub["mol"].setdefault("item_embedding_dim", d)

    cfg = ExperimentConfig(
        name=name or "gin-imported",
        mol=MoLConfig(**sub["mol"]),
        hstu=HSTUConfig(**sub["hstu"]),
        sasrec=SASRecConfig(**sub["sasrec"]),
        data=DataConfig(**sub["data"]),
        train=TrainConfig(**sub["train"]),
        **top,
    )
    cfg = _adopt_registry_kernel_fields(cfg)
    return GinImportResult(config=cfg, ignored=ignored, bindings=bindings)
