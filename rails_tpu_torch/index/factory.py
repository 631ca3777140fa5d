"""Top-k method name -> retrieval function (`rails_tpu/index/factory.py:33-50`).

Only the exact MoL methods are ported; every other spelling the JAX
package accepts raises NotImplementedError.
"""

from __future__ import annotations

from rails_tpu_torch.index import top_k as tk


def get_top_k_raw(top_k_method: str):
    """fn(model, state, query_embeddings, k, user_ids=None) -> TopKResult."""
    if top_k_method == "MoLBruteForceTopK":
        return tk.mol_brute_force_top_k
    if top_k_method == "MoLBruteForceTopKFused":
        return tk.mol_brute_force_top_k_fused
    raise NotImplementedError(
        f"top_k_method {top_k_method!r} is not ported yet; the port serves "
        "MoLBruteForceTopK and MoLBruteForceTopKFused (ROADMAP.md, Queue 1: "
        "K2 options for the Int8 spellings, K8-K10 and approximate retrieval "
        "for the others)"
    )
