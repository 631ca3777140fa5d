"""rails_tpu_torch kernels' plain versions vs the JAX package's Pallas kernels.

The Pallas kernels run in interpret mode on the CPU; the port's wrappers get
CPU tensors, so they run their plain PyTorch versions. Every input comes from
a numpy seed and reaches both sides as the same float32 values.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rails_tpu_torch.core.config import get_experiment_config
from rails_tpu.ops.pallas import hstu_block as jax_hstu
from rails_tpu.ops.pallas import mol_scoring as jax_mol
from rails_tpu_torch.core.device import use_kernel
from rails_tpu_torch.models.hstu import HSTUStack
from rails_tpu_torch.ops import hstu_block, mol_scoring

K1_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_pallas_hstu.py:50
K2_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_pallas_mol.py:73


def _k1_operands(ts: np.ndarray, lengths: np.ndarray, max_seq_len: int, seed: int,
                 d: int = 32, h: int = 2, dqk: int = 16, dv: int = 16):
    """numpy operands of one block: x, colmask, uvqk, Wo, bo, rel_pos, ext, tsw."""
    rng = np.random.default_rng(seed)
    b, n = ts.shape
    f = 2 * h * dv + 2 * h * dqk
    pos_w = 0.02 * rng.standard_normal(2 * max_seq_len - 1)
    i, j = np.arange(n)[:, None], np.arange(n)[None, :]
    ops = dict(
        x=rng.standard_normal((b, n, d)),
        colmask=(np.arange(n)[None, :] < lengths[:, None]).astype(np.float32),
        uvqk=rng.standard_normal((d, f)) / math.sqrt(d),
        o_kernel=rng.standard_normal((h * dv, d)) / math.sqrt(h * dv),
        o_bias=0.02 * rng.standard_normal(d),
        rel_pos=pos_w[j - i + max_seq_len - 1],
        ext=np.concatenate([ts, ts[:, n - 1 :]], axis=1),
        tsw=0.1 * rng.standard_normal(128),
    )
    ops = {k: v.astype(np.int32 if k == "ext" else np.float32) for k, v in ops.items()}
    kw = dict(num_heads=h, dqk=dqk, dv=dv, inv_n=1.0 / max_seq_len, eps=1e-6, num_buckets=128)
    return ops, kw


def _k1_both(ops: dict, kw: dict):
    got = hstu_block.fused_hstu_block(**{k: torch.from_numpy(v) for k, v in ops.items()}, **kw)
    j = {k: jnp.asarray(v) for k, v in ops.items()}
    want = jax_hstu.fused_hstu_block(
        j["x"], None, j["colmask"], j["uvqk"], j["o_kernel"], j["o_bias"],
        interpret=True, time_bias=(j["rel_pos"], j["ext"], j["tsw"]), **kw,
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("n", [35, 19], ids=["n_max", "n_truncated"])
def test_k1_plain_matches_pallas(n):
    """At n = max_seq_len and at a truncated serving length (rel-pos read at
    the trained centre, 1/max_seq_len kept)."""
    rng = np.random.default_rng(n)
    b, max_seq_len = 3, 35
    ts = np.sort(rng.integers(0, 1 << 30, size=(b, n)), axis=1)
    lengths = np.array([n - 1, n // 2, 1])
    got, want = _k1_both(*_k1_operands(ts, lengths, max_seq_len, seed=n))
    np.testing.assert_allclose(got, want, **K1_TOL)


def _boundary_deltas() -> np.ndarray:
    """|delta| at the bucket boundaries e^(0.301 k) +- 1 (the bucket is
    trunc(ln|delta| / 0.301)) and at 10^(0.301 k) +- 1, inside int32."""
    centres = [math.exp(0.301 * k) for k in range(1, 72)]
    centres += [10 ** (0.301 * k) for k in range(1, 31)]
    vals = {int(round(c)) + o for c in centres for o in (-1, 0, 1)}
    return np.array(sorted(v for v in vals if 1 <= v < 2**31 - 1), dtype=np.int64)


def test_time_bucket_matches_pallas_at_boundaries():
    deltas = _boundary_deltas()
    deltas = np.concatenate([deltas, -deltas, [0, -1]]).astype(np.int32)
    for num_buckets in (128, 64):
        got = hstu_block.time_bucket(torch.from_numpy(deltas), num_buckets).numpy()
        want = np.asarray(jax_hstu._time_bucket(jnp.asarray(deltas), num_buckets))
        np.testing.assert_array_equal(got, want)


def test_k1_bucket_boundaries_match_pallas():
    """Timestamps laid out so that column 0's deltas sit on bucket boundaries."""
    deltas = _boundary_deltas()
    b = 3
    n = -(-len(deltas) // b) + 1
    rows = np.resize(deltas, b * (n - 1)).reshape(b, n - 1)
    ts = np.concatenate([np.zeros((b, 1), np.int64), np.sort(rows, axis=1)], axis=1)
    lengths = np.array([n - 1, n - 1, n // 2])
    got, want = _k1_both(*_k1_operands(ts, lengths, max_seq_len=n, seed=7))
    np.testing.assert_allclose(got, want, **K1_TOL)


def _k2_operands(seed: int = 0, b: int = 8, x: int = 300, p_q: int = 8, p_x: int = 4,
                 d_p: int = 32, hd: int = 128):
    rng = np.random.default_rng(seed)
    l = p_q * p_x

    def unit(a):
        return a / np.linalg.norm(a, axis=-1, keepdims=True)

    return dict(
        q=unit(rng.standard_normal((b, p_q, d_p))).astype(np.float32),
        qp=rng.standard_normal((b, l)).astype(np.float32),
        comp=unit(rng.standard_normal((x, p_x, d_p))).astype(np.float32),
        partial=rng.standard_normal((x, l)).astype(np.float32),
        w1=(rng.standard_normal((l, hd)) / math.sqrt(l)).astype(np.float32),
        b1=(0.1 * rng.standard_normal(hd)).astype(np.float32),
        w2=(rng.standard_normal((hd, l)) / math.sqrt(hd)).astype(np.float32),
        b2=(0.1 * rng.standard_normal(l)).astype(np.float32),
    )


def test_k2_plain_matches_pallas():
    o = _k2_operands()
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    tables = mol_scoring.prepare_fused_tables(t["comp"], t["partial"])
    weights = mol_scoring.MoLKernelWeights(t["w1"], t["b1"], t["w2"], t["b2"])
    x = tables.num_items
    got = mol_scoring.fused_mol_scores_t(
        t["q"], t["qp"], tables.item_comp_t, tables.item_partial_t, weights, 0.05
    )[:, :x]

    comp_p, part_p, _ = jax_mol.pad_corpus_tables(
        jnp.asarray(o["comp"]), jnp.asarray(o["partial"]), block_x=128
    )
    jw = jax_mol.MoLKernelWeights(
        jnp.asarray(o["w1"]), jnp.asarray(o["b1"])[None], jnp.asarray(o["w2"]),
        jnp.asarray(o["b2"])[None],
    )
    want = jax_mol.fused_mol_scores(
        jnp.asarray(o["q"]), jnp.asarray(o["qp"]), comp_p, part_p, jw, 0.05,
        block_x=128, interpret=True,
    )[:, :x]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **K2_TOL)


def test_wrappers_on_cpu_run_plain_versions_without_launching():
    ops, kw = _k1_operands(
        np.sort(np.random.default_rng(1).integers(0, 1 << 20, (2, 9)), axis=1),
        np.array([8, 3]), max_seq_len=9, seed=1,
    )
    k1_args = {k: torch.from_numpy(v) for k, v in ops.items()}
    o = {k: torch.from_numpy(v) for k, v in _k2_operands(x=40).items()}
    tables = mol_scoring.prepare_fused_tables(o["comp"], o["partial"])
    k2_args = (o["q"], o["qp"], tables.item_comp_t, tables.item_partial_t,
               mol_scoring.MoLKernelWeights(o["w1"], o["b1"], o["w2"], o["b2"]), 0.05)
    assert hstu_block.fused_hstu_block.launches == 0
    assert mol_scoring.fused_mol_scores_t.launches == 0
    torch.testing.assert_close(
        hstu_block.fused_hstu_block(**k1_args, **kw),
        hstu_block.fused_hstu_block_reference(**k1_args, **kw), rtol=0, atol=0,
    )
    torch.testing.assert_close(
        mol_scoring.fused_mol_scores_t(*k2_args),
        mol_scoring.fused_mol_scores_t_reference(*k2_args), rtol=0, atol=0,
    )
    assert hstu_block.fused_hstu_block.launches == 0
    assert mol_scoring.fused_mol_scores_t.launches == 0


def test_dispatch_rule():
    cpu = torch.zeros(2)
    assert use_kernel(cpu, cpu) is False
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        use_kernel(cpu, torch.zeros(2, device="meta"))


@pytest.mark.parametrize("variant", ["activation", "normalization", "concat_ua"])
def test_unported_k1_variants_raise(variant):
    """K1's and K4's variants are ported: the fused train block (K4) with
    the variant's flag trains (its plain version on the CPU); what stays
    refused, in K1's wrapper: an output projection of neither h*dv nor
    3*h*dv rows and an unknown activation or normalization."""
    ops, kw = _k1_operands(np.zeros((1, 4), np.int64), np.array([3]), max_seq_len=4, seed=2)
    args = {k: torch.from_numpy(v) for k, v in ops.items()}
    if variant == "concat_ua":
        args["o_kernel"] = torch.zeros(2 * args["o_kernel"].shape[0], args["o_kernel"].shape[1])
        with pytest.raises(ValueError, match="3\\*h\\*dv"):
            hstu_block.fused_hstu_block(**args, **kw)
        change = {"concat_ua": True}
    elif variant == "activation":
        with pytest.raises(ValueError, match="activation"):
            hstu_block.fused_hstu_block(**args, **kw, activation="gelu")
        change = {"linear_activation": "none"}
    else:
        with pytest.raises(ValueError, match="normalization"):
            hstu_block.fused_hstu_block(**args, **kw, normalization="softmax")
        change = {"normalization": "softmax_rel_bias"}
    hstu_cfg = get_experiment_config("synthetic-small").hstu.replace(fused_train=True, **change)
    stack = HSTUStack(hstu_cfg, 8, torch.float32, torch.Generator().manual_seed(0))
    x = torch.zeros(1, 8, hstu_cfg.embedding_dim)
    valid = torch.ones(1, 8, dtype=torch.bool)
    ts = torch.arange(8, dtype=torch.int32)[None]
    out = stack(x, valid, ts, train=True)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
