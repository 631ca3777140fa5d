"""The cost probes P1 and P2 in the port vs rails_tpu.

P1: the port's plain version of each `encode_probe` mode against the JAX
probe's Pallas kernel (`rails_tpu/cli/encode_probe.py:make_block`) run in
interpret mode (`force_tpu_interpret_mode`), at B=4, n=16, D=64, h=2,
dqk=dv=16, f32 and bf16. P2: the port's plain version of each `mol_probe`
mode against the JAX probe's `_variant_kernel` in the test's own
`pl.pallas_call(..., interpret=True)` with the BlockSpecs of
`mol_probe.py:136-165`, at B=32, X=512, block 256, fed the JAX probe's exact
arrays (the port puts them into K2's n-major order with `probe_operands`).
Then both CLIs on `--device cpu` at tiny sizes.
"""

import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rails_tpu.cli import encode_probe as jax_encode_probe
from rails_tpu.cli import mol_probe as jax_mol_probe
from rails_tpu_torch.cli import encode_probe as port_encode_cli
from rails_tpu_torch.cli import mol_probe as port_mol_cli
from rails_tpu_torch.compat.from_jax import _tensor
from rails_tpu_torch.ops import encode_probe, mol_probe

P1_MODES = ("full", "noact", "linattn", "nottb", "noattn", "ident")
P2_MODES = ("full", "nosilu", "noexp", "nomlp", "nocombine", "writeonly")
# f32: the plain version and the Pallas kernel differ only in f32 summation
# order, as K1's plain version (`test_torch_port_hstu_variants.py`).
P1_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
          # bf16: one ulp of the bf16 output (2^-8 relative) from those orders.
          "bfloat16": dict(rtol=1e-2, atol=1e-2)}
# P2's plain version vs the JAX probe (bf16 tables, MLP in bf16): within
# this share of the largest |score|. Both round the logits and the hidden
# layer to bf16 at the same points; an f32 summation order that moves a value
# across a bf16 rounding boundary moves its gating term by one bf16 ulp.
P2_TOL = 2e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", P1_MODES)
def test_encode_probe_plain_version_matches_jax_probe(mode, dtype):
    b, n, d, h, dqk, dv, group = 4, 16, 64, 2, 16, 16, 2
    f = 2 * h * dv + 2 * h * dqk
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    relpos = (0.3 * rng.standard_normal((n, n))).astype(np.float32)
    ext = np.cumsum(rng.integers(1, 1000, size=(b, n + 1)), axis=1).astype(np.int32)
    tsw = (0.3 * rng.standard_normal(128)).astype(np.float32)
    lengths = np.array([16, 9, 3, 12])
    colmask = (np.arange(n)[None] < lengths[:, None]).astype(np.float32)
    uvqk = (rng.standard_normal((d, f)) / d**0.5).astype(np.float32)
    ow = (rng.standard_normal((3 * h * dv, d)) / (h * dv) ** 0.5).astype(np.float32)
    ob = (0.1 * rng.standard_normal(d)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    run = jax_encode_probe.make_block(mode, b, n, d, f, h, dqk, dv, group)
    with pltpu.force_tpu_interpret_mode():
        want = run(jnp.asarray(x, jdt), jnp.asarray(relpos), jnp.asarray(ext)[:, None, :],
                   jnp.asarray(ext)[:, 1:, None], jnp.asarray(tsw)[None],
                   jnp.asarray(colmask)[:, None, :], jnp.asarray(uvqk, jdt),
                   jnp.asarray(ow, jdt), jnp.asarray(ob)[None])
    tdt = getattr(torch, dtype)
    got = encode_probe.encode_probe_block(
        mode, torch.from_numpy(x).to(tdt), torch.from_numpy(colmask),
        torch.from_numpy(uvqk).to(tdt), torch.from_numpy(ow).to(tdt), torch.from_numpy(ob),
        torch.from_numpy(relpos), torch.from_numpy(ext), torch.from_numpy(tsw),
        num_heads=h, dqk=dqk, dv=dv, inv_n=1.0 / n)
    assert encode_probe.encode_probe_block.launches == 0
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **P1_TOL[dtype])


def _jax_mol_scorer(mode, b, x, p_q, p_x, d_p, hdim, block_b=32, block_x=256):
    """`mol_probe.make_scorer`'s pallas_call, in interpret mode."""
    l = p_q * p_x
    kernel = functools.partial(jax_mol_probe._variant_kernel, p_q=p_q, p_x=p_x,
                               inv_temperature=20.0, mlp_dtype=jnp.bfloat16, mode=mode)
    vmem = dict(memory_space=pltpu.VMEM)
    in_specs = [
        pl.BlockSpec((p_q, block_b, d_p), lambda j, i: (0, j, 0), **vmem),
        pl.BlockSpec((block_b, l), lambda j, i: (j, 0), **vmem),
        pl.BlockSpec((p_x, d_p, block_x), lambda j, i: (0, 0, i), **vmem),
        pl.BlockSpec((l, block_x), lambda j, i: (0, i), **vmem),
        pl.BlockSpec((l, hdim), lambda j, i: (0, 0), **vmem),
        pl.BlockSpec((1, hdim), lambda j, i: (0, 0), **vmem),
        pl.BlockSpec((hdim, l), lambda j, i: (0, 0), **vmem),
        pl.BlockSpec((1, l), lambda j, i: (0, 0), **vmem),
    ]

    def score(q, qp, item, ip, w1, b1, w2, b2):
        return pl.pallas_call(
            kernel, grid=(b // block_b, x // block_x), in_specs=in_specs,
            out_specs=pl.BlockSpec((block_b, block_x), lambda j, i: (j, i), **vmem),
            out_shape=jax.ShapeDtypeStruct((b, x), jnp.float32),
            scratch_shapes=[pltpu.VMEM((l, block_b, block_x), jnp.float32)],
            interpret=True,
        )(q.astype(jnp.bfloat16), qp, item, ip, w1, b1, w2, b2)

    return score


@pytest.fixture(scope="module")
def mol_arrays():
    """The JAX probe's arrays (`mol_probe.py:118-130`) at B=32, X=512, with
    nonzero biases so that every mode reads them."""
    p_q, p_x, d_p, hdim, b, x = 8, 4, 128, 128, 32, 512
    l = p_q * p_x
    rng = np.random.default_rng(0)
    return dict(
        item=jnp.asarray(rng.standard_normal((p_x, d_p, x)) * 0.1, jnp.bfloat16),
        ip=jnp.asarray(rng.standard_normal((l, x)) * 0.1, jnp.bfloat16),
        q=jnp.asarray(rng.standard_normal((p_q, b, d_p)) * 0.1, jnp.float32),
        qp=jnp.asarray(rng.standard_normal((b, l)) * 0.1, jnp.float32),
        w1=jnp.asarray(rng.standard_normal((l, hdim)) * 0.1, jnp.float32),
        b1=jnp.asarray(rng.standard_normal((1, hdim)) * 0.1, jnp.float32),
        w2=jnp.asarray(rng.standard_normal((hdim, l)) * 0.1, jnp.float32),
        b2=jnp.asarray(rng.standard_normal((1, l)) * 0.1, jnp.float32),
    )


@pytest.mark.parametrize("mode", P2_MODES)
def test_mol_probe_plain_version_matches_jax_probe(mode, mol_arrays):
    a = mol_arrays
    p_x, d_p, x = a["item"].shape
    p_q, b, _ = a["q"].shape
    want = np.asarray(_jax_mol_scorer(mode, b, x, p_q, p_x, d_p, a["w1"].shape[1])(
        a["q"], a["qp"], a["item"], a["ip"], a["w1"], a["b1"], a["w2"], a["b2"]))
    t = {k: _tensor(np.asarray(v)) for k, v in a.items()}
    got = mol_probe.mol_probe_scores(mode, *mol_probe.probe_operands(**t)).numpy()
    assert mol_probe.mol_probe_scores.launches == 0
    assert got.shape == want.shape == (b, x)
    assert np.isfinite(want).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= P2_TOL, err


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_encode_probe_cli_on_cpu(capsys):
    res = port_encode_cli.main(["--device", "cpu", "--batch-size", "2", "--lengths", "8,12",
                                "--num-blocks", "2", "--runs", "1"])
    printed = _last_json(capsys.readouterr().out)
    assert set(printed) >= {"geometry", "ms_per_encode"}
    assert printed["geometry"] == dict(d=256, h=8, dqk=32, dv=32, blocks=2, batch=2)
    assert set(printed["ms_per_encode"]) == {"8", "12"}
    for row in printed["ms_per_encode"].values():
        assert list(row) == list(P1_MODES) + ["production"]
        assert all(v > 0 for v in row.values())
    assert res["device"] == "cpu"


def test_mol_probe_cli_on_cpu(capsys):
    res = port_mol_cli.main(["--device", "cpu", "--num-items", "600", "--runs", "1",
                             "--k", "20"])
    printed = _last_json(capsys.readouterr().out)
    assert set(printed) >= {"geometry", "ms_per_batch"}
    assert printed["geometry"] == dict(p_q=8, p_x=4, d_p=128, h=128, batch=32, num_items=600)
    assert list(printed["ms_per_batch"]) == list(P2_MODES) + ["select_hierarchical"]
    assert res["device"] == "cpu"


def test_probe_full_modes_equal_the_serving_kernels_plain_versions():
    """P1 `full` is K1's concat_ua block with the mask multiplied, and P2
    `full` is K2 over the probe's arrays put into K2's n-major order; on the
    CPU the plain versions agree within f32 summation order."""
    from rails_tpu_torch.ops.hstu_block import fused_hstu_block_reference
    from rails_tpu_torch.ops.mol_scoring import fused_mol_scores_t_reference

    rng = np.random.default_rng(4)
    b, n, d, h, dqk, dv = 3, 10, 32, 2, 8, 8
    f = 2 * h * dv + 2 * h * dqk
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    ext = torch.from_numpy(np.cumsum(rng.integers(1, 900, (b, n + 1)), axis=1).astype(np.int32))
    colmask = (torch.arange(n)[None] < torch.tensor([10, 4, 7])[:, None]).float()
    args = (t(b, n, d), colmask, t(d, f) / d**0.5, t(3 * h * dv, d) / (h * dv) ** 0.5, t(d),
            0.3 * t(n, n), ext, 0.3 * t(128))
    kw = dict(num_heads=h, dqk=dqk, dv=dv, inv_n=1.0 / n)
    torch.testing.assert_close(encode_probe.encode_probe_block_reference("full", *args, **kw),
                               fused_hstu_block_reference(*args, **kw), rtol=1e-5, atol=1e-6)

    p_q, p_x, d_p, hd, b, x = 8, 4, 16, 16, 5, 64
    l = p_q * p_x
    ops = mol_probe.probe_operands(
        0.1 * t(p_q, b, d_p), 0.1 * t(b, l), (0.1 * t(p_x, d_p, x)).bfloat16(),
        (0.1 * t(l, x)).bfloat16(), 0.1 * t(l, hd), 0.1 * t(hd), 0.1 * t(hd, l), 0.1 * t(l))
    got = mol_probe.mol_probe_scores_reference("full", *ops)
    want = fused_mol_scores_t_reference(*ops, 1.0 / 20.0)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", [m for m in P2_MODES if m != "writeonly"])
def test_mol_probe_error_bound_holds_for_another_summation_order(mode, mol_arrays):
    """The same scores summed in another order, the query and item
    components reversed (their logits, gating terms and MLP rows with them),
    lie within `mol_probe_error_bound` of the plain version, a finite bound
    for every score but noexp's, whose sum(e) may cancel. (writeonly scores
    logit 0, which the reversal moves.)"""
    t = {k: _tensor(np.asarray(v)) for k, v in mol_arrays.items()}
    q, qp, item, ip, w = mol_probe.probe_operands(**t)
    p_q, p_x = q.shape[1], item.shape[0]
    rev = torch.tensor([(p_q - 1 - n) * p_x + (p_x - 1 - m) for n in range(p_q)
                        for m in range(p_x)])
    flipped = (q.flip(1).contiguous(), qp[:, rev], item.flip(0).contiguous(), ip[rev].contiguous(),
               type(w)(w.w1[rev], w.b1, w.w2[:, rev], w.b2[rev]))
    want = mol_probe.mol_probe_scores_reference(mode, q, qp, item, ip, w)
    got = mol_probe.mol_probe_scores_reference(mode, *flipped)
    bound = mol_probe.mol_probe_error_bound(mode, q, qp, item, ip, w)
    if mode != "noexp":
        assert torch.isfinite(bound).all()
    assert ((got - want).abs() <= bound).all(), ((got - want).abs() / bound).max().item()


def _scores_with_one_flip(mode, ops, logit=None, hidden=None):
    """The plain version's scores with ONE of its MLP inputs, logit `logit`
    or hidden unit `hidden` of every score, moved to the next bf16 value away
    from zero: one bf16 ulp, the flip `mol_probe_error_bound` allows."""
    q, qp, item, ip, w = ops
    b, l = q.shape[0], q.shape[1] * item.shape[0]

    def flip(v, idx):
        if idx is not None:
            v = v.clone()
            v[..., idx] += torch.sign(v[..., idx]) * mol_probe.bf16_ulp(v[..., idx])
        return v

    lg = torch.einsum("bnd,mdx->bxnm", q.float(), item.float()).reshape(b, -1, l) * 20.0
    h = flip(lg.to(torch.bfloat16).float(), logit) @ w.w1.to(torch.bfloat16).float() + w.b1
    h = h * torch.sigmoid(h)
    qi = flip(h.to(torch.bfloat16).float(), hidden) @ w.w2.to(torch.bfloat16).float() + w.b2
    gi = qp[:, None, :] * ip.float().T[None] + qi
    gw = gi if mode == "nosilu" else gi * torch.sigmoid(gi)
    e = gw if mode == "noexp" else torch.exp(gw - gw.amax(dim=-1, keepdim=True))
    return (e * lg).sum(dim=-1) / e.sum(dim=-1)


@pytest.mark.parametrize("mode", ["full", "nosilu", "noexp"])
def test_mol_probe_error_bound_covers_one_flip_and_rejects_seeded_faults(mode, mol_arrays):
    """`mol_probe_error_bound` is derived from one bf16 rounding flip of an
    MLP input: moving any one logit or hidden unit of the plain version's
    MLP by one bf16 ulp stays within it at every score, while the scores of
    seeded wrong weights (`chip_smoke.P2_FAULTS`: two W2 rows swapped, a
    logit dropped from the MLP) break it."""
    t = {k: _tensor(np.asarray(v)) for k, v in mol_arrays.items()}
    ops = mol_probe.probe_operands(**t)
    q, qp, item, ip, w = ops
    want = mol_probe.mol_probe_scores_reference(mode, *ops)
    assert torch.equal(_scores_with_one_flip(mode, ops), want)
    bound = mol_probe.mol_probe_error_bound(mode, *ops)
    for flipped in ([dict(logit=i) for i in (0, 13, 31)] + [dict(hidden=k) for k in (0, 77, 127)]):
        moved = (_scores_with_one_flip(mode, ops, **flipped) - want).abs()
        assert (moved > 0).any(), flipped
        assert (moved <= bound).all(), (flipped, (moved / bound).max().item())
    w2 = w.w2.clone()
    w2[[0, 1]] = w2[[1, 0]]
    w1 = w.w1.clone()
    w1[5] = 0.0
    for wrong in (type(w)(w.w1, w.b1, w2, w.b2), type(w)(w1, w.b1, w.w2, w.b2)):
        got = mol_probe.mol_probe_scores_reference(mode, q, qp, item, ip, wrong)
        assert ((got - want).abs() / bound).max().item() > 1.0
