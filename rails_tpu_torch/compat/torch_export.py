"""Export the port's weights as a checkpoint of the original torch implementation.

Counterpart of `rails_tpu/compat/torch_export.py` and the inverse of
`torch_import.py`: the port's state dict goes back to the flax-named tree
(`compat/from_jax.py:flax_names`, the inverse of the one naming rule) and
from there to a `model_state_dict` that the original repo loads with
`load_state_dict(strict=True)`: its keys and shapes as its `train.py:538-547`
saves them, the DDP `module.` prefix included. The causal-mask buffer
(`_attn_mask`) is rebuilt from the config. The conversion is torch on the
tensors' own device; export followed by import is the identity.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from rails_tpu_torch.compat.from_jax import flax_names
from rails_tpu_torch.core.config import ExperimentConfig


def _dense(out: Dict[str, torch.Tensor], prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = p["kernel"].T
    if "bias" in p:
        out[prefix + ".bias"] = p["bias"]


def _proj_mlp(out, prefix: str, p: dict, hidden: bool) -> None:
    """(Dropout, GLU, Linear) at indices 1 and 2 with a hidden layer,
    (Dropout, Linear) at index 1 without."""
    if hidden:
        out[prefix + ".1._w"] = p["glu"]["w"]["kernel"]
        out[prefix + ".1._b"] = p["glu"]["w"]["bias"][None, :]
        _dense(out, prefix + ".2", p["out"])
    else:
        _dense(out, prefix + ".1", p["out"])


def _gating_mlp(out, prefix: str, p: dict, leading_dropout: bool) -> None:
    """[Dropout?] Linear SiLU Linear: the Linears at offset 0 and 2, one
    further with the leading Dropout."""
    i0 = 1 if leading_dropout else 0
    if "hidden" in p:
        _dense(out, f"{prefix}.{i0}", p["hidden"])
        _dense(out, f"{prefix}.{i0 + 2}", p["out"])
    else:
        _dense(out, f"{prefix}.{i0}", p["out"])


def _mol_state(out, mol: dict, cfg: ExperimentConfig) -> None:
    m = cfg.mol
    pre = "_ndp_module."
    _proj_mlp(out, pre + "_query_embeddings_fn._query_emb_proj_module", mol["query_proj"],
              hidden=m.query_hidden_dim > 0)
    _proj_mlp(out, pre + "_item_embeddings_fn._item_emb_proj_module", mol["item_proj"],
              hidden=m.item_hidden_dim > 0)
    _gating_mlp(out, pre + "_gating_fn._qi_partial_module", mol["gating_qi"],
                leading_dropout=True)
    if "gating_query" in mol:
        _gating_mlp(out, pre + "_gating_fn._query_only_partial_module", mol["gating_query"],
                    leading_dropout=False)
    if "gating_item" in mol:
        _gating_mlp(out, pre + "_gating_fn._item_only_partial_module", mol["gating_item"],
                    leading_dropout=True)
    for i in range(len(m.uid_embedding_hash_sizes)):
        out[pre + f"_query_embeddings_fn._uid_embeddings_{i}.weight"] = (
            mol[f"uid_embeddings_{i}"]["embedding"])


def _hstu_state(out, hstu: dict) -> None:
    """The stacked (L, ...) relative-bias tables go back to each layer."""
    blocks = sorted(int(k.split("_")[1]) for k in hstu if k.startswith("block_"))
    bias = hstu.get("rel_attn_bias")
    for i in blocks:
        pre = f"_hstu._attention_layers.{i}"
        out[pre + "._uvqk"] = hstu[f"block_{i}"]["uvqk"]
        out[pre + "._o.weight"] = hstu[f"block_{i}"]["o_kernel"].T
        out[pre + "._o.bias"] = hstu[f"block_{i}"]["o_bias"]
        if bias is not None:
            out[pre + "._rel_attn_bias._pos_w"] = bias["pos_w"][i]
            out[pre + "._rel_attn_bias._ts_w"] = bias["ts_w"][i]


def _sasrec_state(out, sasrec: dict) -> None:
    """q, k and v back into `in_proj_weight` (3D, D); the FFN's Linears back
    into Conv1d weights (H, D, 1)."""
    blocks = sorted(int(k.split("_")[1]) for k in sasrec if k.startswith("block_"))
    for i in blocks:
        blk = sasrec[f"block_{i}"]
        qkv = ("q_proj", "k_proj", "v_proj")
        out[f"attention_layers.{i}.in_proj_weight"] = torch.cat(
            [blk[k]["kernel"].T for k in qkv], dim=0)
        out[f"attention_layers.{i}.in_proj_bias"] = torch.cat([blk[k]["bias"] for k in qkv])
        _dense(out, f"attention_layers.{i}.out_proj", blk["out_proj"])
        ffn = f"forward_layers.{i}._conv1d"
        out[ffn + ".0.weight"] = blk["ffn"]["fc1"]["kernel"].T[:, :, None]
        out[ffn + ".0.bias"] = blk["ffn"]["fc1"]["bias"]
        out[ffn + ".3.weight"] = blk["ffn"]["fc2"]["kernel"].T[:, :, None]
        out[ffn + ".3.bias"] = blk["ffn"]["fc2"]["bias"]


def reference_state_dict_from_params(
    params: dict, cfg: ExperimentConfig, ddp_prefix: bool = True, include_buffers: bool = True,
) -> Dict[str, torch.Tensor]:
    """`{"params": tree}` (or the bare tree) with tensor leaves as a
    reference-keyed state dict; the values are views of the leaves."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    if include_buffers:
        # Both encoders register a causal-mask buffer sized to the padded
        # total sequence length.
        n = cfg.max_seq_len_padded
        device = tree["item_emb"]["embedding"].device
        out["_attn_mask"] = torch.triu(torch.ones(n, n, dtype=torch.bool, device=device), 1)
    out["_embedding_module._item_emb.weight"] = tree["item_emb"]["embedding"]
    out["_input_features_preproc._pos_emb.weight"] = tree["input_preproc"]["pos_emb"]
    if cfg.input_preprocessor_type in ("rated", "combined"):
        out["_input_features_preproc._rating_emb.weight"] = tree["input_preproc"]["rating_emb"]
    if cfg.model_type == "HSTU":
        _hstu_state(out, tree["hstu"])
    else:
        _sasrec_state(out, tree["sasrec"])
    if cfg.similarity_type == "MoL":
        _mol_state(out, tree["mol"], cfg)
    if ddp_prefix:
        out = {f"module.{k}": v for k, v in out.items()}
    return out


def reference_state_dict(
    state_dict: Mapping[str, torch.Tensor], cfg: ExperimentConfig, ddp_prefix: bool = True,
    include_buffers: bool = True,
) -> Dict[str, torch.Tensor]:
    """The port's state dict as a reference-keyed one: contiguous f32
    tensors (the mask bool) on the CPU."""
    sd = reference_state_dict_from_params(flax_names(state_dict), cfg, ddp_prefix,
                                          include_buffers)
    return {k: v.detach().to("cpu", v.dtype if v.dtype == torch.bool else torch.float32,
                             copy=True).contiguous()
            for k, v in sd.items()}


def export_torch_checkpoint(
    state_dict: Mapping[str, torch.Tensor], cfg: ExperimentConfig, path: str, epoch: int = 0,
    batch_id: int = 0,
) -> None:
    """Write a torch checkpoint file in the reference's payload format; the
    optimizer state is left empty."""
    torch.save({
        "epoch": epoch,
        "batch_id": batch_id,
        "model_state_dict": reference_state_dict(state_dict, cfg),
        "optimizer_state_dict": {},
    }, path)
