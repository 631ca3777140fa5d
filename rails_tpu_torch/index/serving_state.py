"""Save and load the built serving state, so that a server starts from the
corpus tables instead of embedding the corpus and building them again.

Counterpart of `rails_tpu/index/serving_state.py`, in one format: its
"streamed" one (:41-118). Each table of an `EvalState` (the standard,
average and fused kernel-layout tables with their int8 scales, the item
embeddings, the IVF index) is written item-chunk by item-chunk into a
`.npy` memmap under the directory, so that the host holds one chunk at a
time; bf16 tables are stored as their uint16 bit patterns with the logical
dtype in `meta.json`, and empty and absent tables are recorded there
alone. The tables keep the port's layouts (the fused tables n-major, as the
kernels read them). Only the port reads what it writes.

    save_serving_state(dir, eval_state)          # once, offline
    es = load_serving_state(dir, model)          # at every server start

`load_serving_state` maps the files (copy-on-write: nothing is written
back) and moves the tables to the model's device; with `host=True` it
leaves CPU tensors over the maps, so that `pad_and_shard_state` copies only
a rank's slab to its card. The model's weights are not stored: they live in
the training checkpoint, and a state is served with the model it was built
from.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from rails_tpu_torch.core import distributed
from rails_tpu_torch.index.ivf import IVFIndex
from rails_tpu_torch.index.top_k import MoLTopKState
from rails_tpu_torch.ops.mol_scoring import FusedCorpusTables
from rails_tpu_torch.similarity.mol import MoLItemTables
from rails_tpu_torch.train.evaluation import EvalState

# The item axis of every table (the IVF index's arrays: axis 0).
_ITEM_AXES = {
    "item_ids": 0,
    "component_embeddings": 0,
    "gating_partial": 0,
    "avg_component": 0,
    "item_embeddings": 0,
    "fused_item_comp_t": 2,
    "fused_item_partial_t": 1,
    "fused_comp_scale": 1,
    "fused_partial_scale": 1,
}
# Logical dtypes numpy has no type for, stored as bit patterns of this type.
_BITS = {torch.bfloat16: (torch.int16, np.uint16)}
_DTYPES = {str(dt).removeprefix("torch."): dt for dt in (
    torch.float32, torch.float64, torch.bfloat16, torch.float16, torch.int8, torch.uint8,
    torch.int16, torch.int32, torch.int64, torch.bool)}


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype in _BITS:
        view, store = _BITS[t.dtype]
        return t.view(view).numpy().view(store)
    return t.numpy()


def _write(path: str, name: str, t: torch.Tensor, axis: int, chunk_items: int) -> dict:
    """`t` into `<path>/<name>.npy`, `chunk_items` items along `axis` at a
    time; returns its metadata entry."""
    from numpy.lib.format import open_memmap

    store = np.dtype(_BITS[t.dtype][1]) if t.dtype in _BITS else _to_numpy(t[:0]).dtype
    mm = open_memmap(os.path.join(path, name + ".npy"), mode="w+", dtype=store,
                     shape=tuple(t.shape))
    sl = [slice(None)] * t.ndim
    n = t.shape[axis]
    for s0 in range(0, n, chunk_items):
        sl[axis] = slice(s0, min(s0 + chunk_items, n))
        mm[tuple(sl)] = _to_numpy(t.narrow(axis, s0, min(chunk_items, n - s0)))
    mm.flush()
    del mm
    return {"shape": list(t.shape), "stored": str(store), "logical": _dtype_name(t.dtype)}


def _entry(path: str, name: str, t: Optional[torch.Tensor], axis: int, chunk_items: int):
    if t is None:
        return None
    if t.numel() == 0:
        return {"empty": [list(t.shape), _dtype_name(t.dtype)]}
    return _write(path, name, t, axis, chunk_items)


def _read(path: str, name: str, entry: Optional[dict]) -> Optional[torch.Tensor]:
    """The table as a CPU tensor over a copy-on-write map of its file."""
    if entry is None:
        return None
    if "empty" in entry:
        shape, dtype = entry["empty"]
        return torch.zeros(shape, dtype=_DTYPES[dtype])
    mm = np.load(os.path.join(path, name + ".npy"), mmap_mode="c")
    logical = _DTYPES[entry["logical"]]
    if logical in _BITS:
        return torch.from_numpy(mm.view(np.int16)).view(logical)
    return torch.from_numpy(mm)


def save_serving_state(path: str, eval_state: EvalState, chunk_items: int = 1 << 20) -> str:
    """Write `eval_state`'s tables and `meta.json` under the directory
    `path`; returns its absolute path. Under `torch.distributed` every
    process calls it with the same whole state, the primary writes and the
    others wait."""
    path = os.path.abspath(path)
    st = eval_state.topk_state
    tables: Dict[str, Optional[torch.Tensor]] = {
        "item_ids": st.item_ids,
        "component_embeddings": st.item_tables.component_embeddings,
        "gating_partial": st.item_tables.gating_partial,
        "avg_component": st.avg_component,
        "item_embeddings": eval_state.item_embeddings,
    }
    meta = {"top_k_method": eval_state.top_k_method, "num_objects": eval_state.num_objects,
            "fused_num_items": None, "tables": {}, "ivf": None}
    ft = st.fused_tables
    if ft is not None:
        tables.update(fused_item_comp_t=ft.item_comp_t, fused_item_partial_t=ft.item_partial_t,
                      fused_comp_scale=ft.comp_scale, fused_partial_scale=ft.partial_scale)
        meta["fused_num_items"] = ft.num_items
    if distributed.is_primary():
        os.makedirs(path, exist_ok=True)
        for name, t in tables.items():
            meta["tables"][name] = _entry(path, name, t, _ITEM_AXES[name], chunk_items)
        if st.ivf is not None:
            meta["ivf"] = {f: _entry(path, "ivf_" + f, a, 0, chunk_items)
                           for f, a in zip(st.ivf._fields, st.ivf)}
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
    return path


def load_serving_state(path: str, model, host: bool = False) -> EvalState:
    """The `EvalState` saved under `path`, equal to the one `get_eval_state`
    built, on the device of `model`'s parameters, or with `host=True` as CPU
    tensors over the files. Raises when the tables do not fit the model's
    MoL geometry."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dev = torch.device("cpu") if host else next(model.parameters()).device

    def load(name: str, entry: Optional[dict]) -> Optional[torch.Tensor]:
        t = _read(path, name, entry)
        return None if t is None else t.to(dev)

    put = {name: load(name, e) for name, e in meta["tables"].items()}
    comp = put["component_embeddings"]
    if model.cfg.similarity_type == "MoL" and comp.numel():
        m = model.cfg.mol
        if tuple(comp.shape[1:]) != (m.item_dot_product_groups, m.dot_product_dimension):
            raise ValueError(f"serving state {path}: component tables {tuple(comp.shape)} do "
                             f"not fit the model's MoL geometry")
    fused = None
    if meta["fused_num_items"] is not None:
        fused = FusedCorpusTables(
            item_comp_t=put["fused_item_comp_t"], item_partial_t=put["fused_item_partial_t"],
            num_items=int(meta["fused_num_items"]), comp_scale=put["fused_comp_scale"],
            partial_scale=put["fused_partial_scale"])
    ivf = None
    if meta["ivf"] is not None:
        ivf = IVFIndex(**{f: load("ivf_" + f, e) for f, e in meta["ivf"].items()})
    state = MoLTopKState(
        item_ids=put["item_ids"],
        item_tables=MoLItemTables(component_embeddings=comp,
                                  gating_partial=put["gating_partial"]),
        avg_component=put["avg_component"],
        fused_tables=fused,
        ivf=ivf,
    )
    return EvalState(topk_state=state, num_objects=int(meta["num_objects"]),
                     top_k_method=meta["top_k_method"], item_embeddings=put["item_embeddings"])
