"""K2's tensor-core route (`ops/mol_scoring.py:tc_route`, the kernel in
`csrc/mol_scoring_tc.cuh`) on the CPU: which configurations and table types
take it, and the plain version that judges the kernel on the card against
the JAX package's Pallas kernel (interpret mode) on bf16 tables at every
geometry the route serves.

The route adds no operand packing on the host: the kernel permutes W1's rows
and W2's columns into its MLP axis order while it stages them, from the
same f32 arguments the CUDA-core kernel takes. The kernel itself runs in
`tests/test_torch_port_gpu.py` and `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rails_tpu.ops.pallas import mol_scoring as jax_mol
from rails_tpu_torch.core.config import get_experiment_config, list_experiment_configs
from rails_tpu_torch.ops import mol_scoring
from tests.test_torch_port_kernels import _k2_operands

# The MoL geometries (P_Q, P_X, d_P, H) of the registry and whether K2's bf16
# and int8 tables take the tensor cores there. A new geometry must be added here.
REGISTRY_ROUTES = {
    (8, 4, 128, 128): True,    # ml-20m-*
    (8, 4, 64, 128): True,     # ml-1m-*
    (8, 8, 32, 128): True,     # amzn-books-*
    (4, 2, 16, 32): False,     # synthetic-small: P_Q = 4 is half an n8 tile, L = 8
}
# Of each row's largest |score|: both round the MLP's inputs to bf16 at the
# same points and sum in other f32 orders, measured up to 1.5e-4; an MLP in
# f32 instead of bf16 misses by 3.5e-3 to 1e-2.
ROW_TOL = 1e-3


def _mol_geometry(cfg):
    m = cfg.mol
    return (m.query_dot_product_groups, m.item_dot_product_groups, m.dot_product_dimension,
            m.gating_qi_hidden_dim)


@pytest.mark.parametrize("name", [n for n in list_experiment_configs()
                                  if get_experiment_config(n).similarity_type == "MoL"])
def test_tc_route_of_every_registry_mol_config(name):
    """bf16 and int8 tables at the published geometries take the tensor
    cores (int8 codes convert exactly to bf16, and K8 and K9 share the
    logits routine); f32 and fp16 tables never do."""
    geom = _mol_geometry(get_experiment_config(name))
    assert geom in REGISTRY_ROUTES, f"{name}: new MoL geometry {geom}"
    for dtype in (torch.bfloat16, torch.int8):
        assert mol_scoring.tc_route(dtype, *geom) is REGISTRY_ROUTES[geom]
    for dtype in (torch.float32, torch.float16):
        assert mol_scoring.tc_route(dtype, *geom) is False


@pytest.mark.parametrize("geom, want", [
    ((8, 4, 16, 16), True), ((8, 8, 64, 256), True),      # the smallest and largest widths
    ((8, 8, 128, 128), False),                            # P_X * d_P = 1024 > 512
    ((8, 4, 24, 128), False), ((8, 4, 128, 120), False),  # not whole k16 / n8 steps
    ((8, 4, 128, 272), False),                            # H > 256
    ((4, 4, 128, 128), False), ((8, 2, 128, 128), False), ((16, 4, 64, 128), False),
])
def test_tc_route_width_rule(geom, want):
    assert mol_scoring.tc_route(torch.bfloat16, *geom) is want


@pytest.mark.parametrize("geom", [(8, 4, 128), (8, 4, 64), (8, 8, 32)],
                         ids=["ml20m", "ml1m", "books"])
def test_k2_plain_on_bf16_tables_matches_pallas(geom):
    """The plain version on bf16 tables and queries (the MLP's inputs
    rounded to bf16) against JAX's `fused_mol_scores` in interpret mode, B=5
    over 300 items, within ROW_TOL of each row's largest |score|."""
    p_q, p_x, d_p = geom
    o = _k2_operands(seed=3, b=5, x=300, p_q=p_q, p_x=p_x, d_p=d_p)
    bf = {k: o[k].astype(jnp.bfloat16) for k in ("q", "comp", "partial")}
    tables = mol_scoring.prepare_fused_tables(
        *(torch.from_numpy(np.asarray(bf[k], np.float32)).bfloat16()
          for k in ("comp", "partial")))
    weights = mol_scoring.MoLKernelWeights(*(torch.from_numpy(o[k]) for k in ("w1", "b1", "w2",
                                                                              "b2")))
    q = torch.from_numpy(np.asarray(bf["q"], np.float32)).bfloat16()
    got = mol_scoring.fused_mol_scores_t(q, torch.from_numpy(o["qp"]), tables.item_comp_t,
                                         tables.item_partial_t, weights, 0.05)[:, :300].numpy()

    comp_p, part_p, _ = jax_mol.pad_corpus_tables(bf["comp"], bf["partial"], block_x=256)
    jw = jax_mol.MoLKernelWeights(jnp.asarray(o["w1"]), jnp.asarray(o["b1"])[None],
                                  jnp.asarray(o["w2"]), jnp.asarray(o["b2"])[None])
    want = np.asarray(jax_mol.fused_mol_scores(bf["q"], jnp.asarray(o["qp"]), comp_p, part_p,
                                               jw, 0.05, block_x=256, interpret=True))[:, :300]
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= ROW_TOL * scale).all(), np.abs(got - want).max()
    assert (got.argmax(axis=1) == want.argmax(axis=1)).all()
