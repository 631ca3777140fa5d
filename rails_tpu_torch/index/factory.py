"""Top-k method name -> retrieval function (`rails_tpu/index/factory.py:33-173`).

Every spelling of the JAX factory is served; `MoLIVFTopK{n}` probes the
state's IVF index (`ivf.mol_ivf_top_k`; `get_eval_state` builds it). The
`...Int8...` spellings run the same algorithms as their bf16 twins: the
quantization lives in the state (`get_eval_state` builds it from the name).
Unknown names raise ValueError, as in the JAX package.
"""

from __future__ import annotations

import re

from rails_tpu_torch.index import top_k as tk
from rails_tpu_torch.index.ivf import mol_ivf_top_k


def _bind(fn, **budgets):
    def raw(model, state, q, k, user_ids=None, item_embeddings=None):
        return fn(model, state, q, k, user_ids=user_ids, **budgets)
    return raw


def _certified_result(model, state, q, k, user_ids=None, *, cand_budget):
    # The factory contract returns the TopKResult alone; callers that want
    # the certificate call tk.mol_certified_top_k directly.
    return tk.mol_certified_top_k(model, state, q, k, cand_budget, user_ids=user_ids)[0]


def _mips(model, state, q, k, user_ids=None, item_embeddings=None):
    if item_embeddings is None:
        raise ValueError("MIPSBruteForceTopK scores the item embeddings: pass item_embeddings")
    return tk.mips_brute_force_top_k(state.item_ids, item_embeddings, q, k)


def get_top_k_raw(top_k_method: str):
    """fn(model, state, query_embeddings, k, user_ids=None,
    item_embeddings=None) -> TopKResult; every budget is bound here."""
    exact = {
        "MoLBruteForceTopK": tk.mol_brute_force_top_k,
        "MoLBruteForceTopKFused": tk.mol_brute_force_top_k_fused,
        "MoLBruteForceTopKFusedInt8": tk.mol_brute_force_top_k_fused,
        "MoLBruteForceTopKFusedApprox": tk.mol_brute_force_top_k_fused_approx,
        "MoLBruteForceTopKFusedInt8Approx": tk.mol_brute_force_top_k_fused_approx,
    }
    if top_k_method in exact:
        return _bind(exact[top_k_method])
    if top_k_method == "MIPSBruteForceTopK":
        return _mips
    budgets = parse_top_k_budgets(top_k_method)
    approximate = (
        (r"MoLNaive(?:Faiss)?TopK\d+", tk.mol_naive_top_k),
        (r"MoLAvgTopK\d+", tk.mol_avg_top_k),
        (r"MoLCombTopK\d+_\d+", tk.mol_comb_top_k),
        (r"MoLIVFTopK\d+", mol_ivf_top_k),
        (r"MoLCertTopK\d+(?:Int8)?", _certified_result),
        # One batch-shared tile set scored by K10; without a B suffix every
        # distinct nominated tile is kept.
        (r"MoLTileTopK\d+(?:B\d+)?(?:Int8)?", tk.mol_tile_top_k_shared),
    )
    for pattern, fn in approximate:
        if re.fullmatch(pattern, top_k_method):
            return _bind(fn, **budgets)
    raise ValueError(f"Unknown top_k_method {top_k_method!r}")


def parse_top_k_budgets(top_k_method: str) -> dict:
    """Candidate budgets encoded in a method name (e.g. MoLCombTopK50_500
    -> k_per_group=50, avg_top_k=500). Empty for brute-force methods."""
    m = re.fullmatch(r"MoLNaive(?:Faiss)?TopK(\d+)", top_k_method)
    if m:
        return {"k_per_group": int(m.group(1))}
    m = re.fullmatch(r"MoLAvgTopK(\d+)", top_k_method)
    if m:
        return {"avg_top_k": int(m.group(1))}
    m = re.fullmatch(r"MoLCombTopK(\d+)_(\d+)", top_k_method)
    if m:
        return {"k_per_group": int(m.group(1)), "avg_top_k": int(m.group(2))}
    m = re.fullmatch(r"MoLIVFTopK(\d+)", top_k_method)
    if m:
        return {"nprobe": int(m.group(1))}
    m = re.fullmatch(r"MoLCertTopK(\d+)(?:Int8)?", top_k_method)
    if m:
        return {"cand_budget": int(m.group(1))}
    m = re.fullmatch(r"MoLTileTopK(\d+)(?:B(\d+))?(?:Int8)?", top_k_method)
    if m:
        out = {"tiles_per_group": int(m.group(1))}
        if m.group(2):
            out["tile_budget"] = int(m.group(2))
        return out
    return {}
