"""K8 and K9 on the tensor cores (`ops/mol_scoring.py:bounds_tc_route`, the
kernel `mol_bounds_tc_kernel` in `csrc/mol_bounds.cu`) on the CPU: which
configurations and table types take the route, and a plain emulation of the
logits routine the kernels share with K2 (`csrc/mol_tc_logits.cuh`): each
k16 step's product rounded to f32, the steps added in f32 in order, then
times an int8 table's cs[m, x], then times 1/T.

The emulation, on bf16 and int8 tables (`quantize_fused_tables`), matches
JAX's `fused_mol_ub_t` and `fused_mol_group_block_max` in interpret mode; and
the maxima taken in the kernels' order (K8: the max over n of the raw logits,
times cs, the max over m, times 1/T; K9: the max over a tile's items, times
1/T) equal the maxima of the scaled logits bit for bit, which is what makes
K8 the max of K2's logits and K9's max over l K8's per-tile max on the card.
The kernels themselves run in `tests/test_torch_port_gpu.py` and
`chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rails_tpu.ops.pallas import mol_scoring as jax_mol
from rails_tpu_torch.core.config import get_experiment_config, list_experiment_configs
from rails_tpu_torch.ops import mol_scoring

# The MoL geometries (P_Q, P_X, d_P) of the registry and whether K8 and K9 on
# bf16 and int8 tables take the tensor cores there. A new geometry must be
# added here.
REGISTRY_ROUTES = {
    (8, 4, 128): True,     # ml-20m-*
    (8, 4, 64): True,      # ml-1m-*
    (8, 8, 32): True,      # amzn-books-*
    (4, 2, 16): False,     # synthetic-small: P_Q = 4 is half an n8 tile
}
TC_GEOMS = [(8, 4, 128), (8, 4, 64), (8, 8, 32)]
TC_IDS = ["ml20m", "ml1m", "books"]
TEMPERATURE = 0.05
# Emulation vs JAX, relative to the largest |bound|: both sum exact products
# in f32, in other orders.
JAX_RTOL = 1e-5


def _mol_geometry(cfg):
    m = cfg.mol
    return (m.query_dot_product_groups, m.item_dot_product_groups, m.dot_product_dimension)


@pytest.mark.parametrize("name", [n for n in list_experiment_configs()
                                  if get_experiment_config(n).similarity_type == "MoL"])
def test_bounds_tc_route_of_every_registry_mol_config(name):
    """bf16 and int8 tables at the published geometries take the tensor
    cores, f32 and fp16 tables never do, and at H = 128 the route is K2's."""
    cfg = get_experiment_config(name)
    geom = _mol_geometry(cfg)
    assert geom in REGISTRY_ROUTES, f"{name}: new MoL geometry {geom}"
    for dtype in (torch.bfloat16, torch.int8):
        assert mol_scoring.bounds_tc_route(dtype, *geom) is REGISTRY_ROUTES[geom]
    for dtype in (torch.float32, torch.float16):
        assert mol_scoring.bounds_tc_route(dtype, *geom) is False
    for dtype in (torch.bfloat16, torch.int8, torch.float32):
        assert (mol_scoring.bounds_tc_route(dtype, *geom)
                is mol_scoring.tc_route(dtype, *geom, 128))
    if cfg.mol.gating_qi_hidden_dim == 128:
        assert mol_scoring.tc_route(torch.bfloat16, *geom, cfg.mol.gating_qi_hidden_dim) \
            is REGISTRY_ROUTES[geom]


@pytest.mark.parametrize("geom, want", [
    ((8, 4, 16), True), ((8, 8, 64), True),       # the smallest and largest widths
    ((8, 8, 128), False),                         # P_X * d_P = 1024 > 512
    ((8, 4, 24), False), ((8, 4, 8), False),      # not whole k16 steps
    ((4, 4, 128), False), ((8, 2, 128), False), ((16, 4, 64), False),
])
def test_bounds_tc_route_width_rule(geom, want):
    """The rule has no H term: H decides K2's route alone (`tc_route`)."""
    assert mol_scoring.bounds_tc_route(torch.bfloat16, *geom) is want
    assert mol_scoring.bounds_tc_route(torch.int8, *geom) is want
    assert mol_scoring.tc_route(torch.bfloat16, *geom, 24) is False


def _tables(geom, kind, b=5, x=700, seed=0):
    """bf16 queries and kernel-layout tables made with numpy from `seed`
    (int8: the bf16 tables quantized by `quantize_fused_tables`)."""
    p_q, p_x, d_p = geom
    rng = np.random.default_rng(seed)

    def unit(a):
        return a / np.linalg.norm(a, axis=-1, keepdims=True)

    q = torch.from_numpy(unit(rng.standard_normal((b, p_q, d_p))).astype(np.float32)).bfloat16()
    comp = torch.from_numpy(unit(rng.standard_normal((x, p_x, d_p))).astype(np.float32))
    part = torch.from_numpy(rng.standard_normal((x, p_q * p_x)).astype(np.float32))
    tables = mol_scoring.prepare_fused_tables(comp.bfloat16(), part.bfloat16())
    if kind == "int8":
        tables = mol_scoring.quantize_fused_tables(tables)
    return q, tables


def _raw_logits(q, items):
    """(B, P_Q, P_X, X) raw logits in the routine's order: each k16 step's
    product summed in f64 and rounded once to f32, the steps added in f32 in
    ks order."""
    d_p = q.shape[2]
    lg = torch.zeros(q.shape[0], q.shape[1], items.shape[0], items.shape[2])
    for ks in range(d_p // 16):
        k = slice(16 * ks, 16 * ks + 16)
        lg = lg + torch.einsum("bnd,mdx->bnmx", q[:, :, k].double(),
                               items[:, k].double()).float()
    return lg


def _emulate(q, tables):
    """(K2's logits (B, P_Q, P_X, X), K8 (B, X), K9 (B, L, X / 256)) of the
    routine, with K8's and K9's maxima in their kernels' order."""
    inv_t = torch.tensor(1.0 / TEMPERATURE, dtype=torch.float32)
    raw = _raw_logits(q.float(), tables.item_comp_t.float())
    cs = tables.comp_scale
    b, p_q, p_x, x = raw.shape
    k2 = (raw * cs[None, None] if cs is not None else raw) * inv_t
    if cs is None:
        k8 = raw.amax(dim=(1, 2)) * inv_t
        scaled = raw
    else:
        k8 = (raw.amax(dim=1) * cs[None]).amax(dim=1) * inv_t
        scaled = raw * cs[None, None]
    k9 = scaled.reshape(b, p_q * p_x, x // 256, 256).amax(dim=3) * inv_t
    return k2, k8, k9


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("geom", TC_GEOMS, ids=TC_IDS)
def test_k8_emulation_is_the_max_of_k2_logits_and_matches_pallas(geom, kind):
    """B=5 over 700 items (three tiles, the last padded): K8 in the kernel's
    order is the max of K2's logits bit for bit, and matches JAX's
    `fused_mol_ub_t` (interpret mode)."""
    q, tables = _tables(geom, kind)
    k2, k8, _ = _emulate(q, tables)
    assert torch.equal(k8, k2.amax(dim=(1, 2)))
    jq = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)
    extra = {}
    if kind == "int8":
        extra = dict(comp_scale=jnp.asarray(tables.comp_scale.numpy()))
    want = np.asarray(jax_mol.fused_mol_ub_t(
        jq, jnp.asarray(tables.item_comp_t.float().numpy()).astype(
            jnp.int8 if kind == "int8" else jnp.bfloat16),
        TEMPERATURE, block_x=256, interpret=True, **extra))
    got = k8.numpy()
    assert np.abs(got - want).max() <= JAX_RTOL * np.abs(want).max()
    assert (got[:, tables.num_items:] == 0).all()        # pad columns: logit 0


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("geom", TC_GEOMS, ids=TC_IDS)
def test_k9_emulation_is_k8_per_tile_and_matches_pallas(geom, kind):
    """K9 in the kernel's order, maxed over l, is K8's per-tile max bit for
    bit; its n-major rows match JAX's m-major `fused_mol_group_block_max`
    (interpret mode) permuted."""
    q, tables = _tables(geom, kind, x=768, seed=1)
    _, k8, k9 = _emulate(q, tables)
    b, x = k8.shape
    assert torch.equal(k9.amax(dim=1), k8.reshape(b, x // 256, 256).amax(dim=2))
    extra = {}
    if kind == "int8":
        extra = dict(comp_scale=jnp.asarray(tables.comp_scale.numpy()))
    jq = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jax_mol.fused_mol_group_block_max(
        jq, jnp.asarray(tables.item_comp_t.float().numpy()).astype(
            jnp.int8 if kind == "int8" else jnp.bfloat16),
        TEMPERATURE, block_x=256, interpret=True, **extra))
    got = k9.numpy()[:, jax_mol.m_major_perm(*geom[:2])]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= JAX_RTOL * np.abs(want).max()


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("geom", TC_GEOMS, ids=TC_IDS)
def test_plain_k8_k9_hold_the_emulation(geom, kind):
    """The wrappers' plain versions (one f32 einsum over d_P) against the
    routine's order: within JAX_RTOL of the largest bound, as the kernels'
    plain-version checks on the card hold them."""
    q, tables = _tables(geom, kind, b=3, x=512, seed=2)
    _, k8, k9 = _emulate(q, tables)
    cs = tables.comp_scale
    ub = mol_scoring.fused_mol_ub_t(q, tables.item_comp_t, TEMPERATURE, cs)
    gm = mol_scoring.fused_mol_group_block_max(q, tables.item_comp_t, TEMPERATURE, cs)
    assert (ub - k8).abs().max().item() <= JAX_RTOL * k8.abs().max().item()
    assert (gm - k9).abs().max().item() <= JAX_RTOL * k9.abs().max().item()
