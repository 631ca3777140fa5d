"""The plain versions of K5 (fused MoL loss) and K6 (row scatter-add) vs the
JAX package.

The Pallas kernels run in interpret mode on the CPU; the port's wrappers get
CPU tensors, so they run their plain PyTorch versions. Inputs come from a
numpy seed and reach both sides as the same float32 values; both sides get
the same explicit dropout seed, so the hash masks are the same bits.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.ops.pallas.mol_loss_train import (
    _PI_SALT,
    _QI_SALT,
    hash_keep_global,
    make_fused_mol_loss,
)
from rails_tpu.ops.pallas.mol_scoring import MoLKernelWeights, m_major_perm
from rails_tpu.ops.pallas.scatter_add import scatter_add_rows as jax_scatter_add_rows
from rails_tpu_torch.ops import hash_dropout, mol_loss_train, scatter_add

P_Q, P_X, D_P, H = 4, 2, 16, 24          # tests/test_pallas_mol_train.py:25
TEMP, EPS, SEED = 0.05, 1e-6, 12345
GRAD_NAMES = ("q_comp", "qp", "item_comp", "ip", "w1", "b1", "w2", "b2")


def _inputs(m, r, p_q=P_Q, p_x=P_X, d_p=D_P, h=H, seed=0, normalize=False):
    rng = np.random.default_rng(seed)
    l = p_q * p_x

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    q, it = normal(m, p_q, d_p), normal(r, p_x, d_p)
    if normalize:      # l2-normalised components, as every published config
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        it /= np.linalg.norm(it, axis=-1, keepdims=True)
    return dict(q_comp=q, qp=normal(m, l), item_comp=it, ip=normal(r, l),
                w1=normal(l, h, scale=0.3), b1=normal(1, h, scale=0.1),
                w2=normal(h, l, scale=0.3), b2=normal(1, l, scale=0.1))


def _jax_fwd_and_grads(x, cot, p_q, p_x, pi_rate, qi_rate, seed):
    fused = make_fused_mol_loss(p_q=p_q, p_x=p_x, temperature=TEMP,
                                softmax_dropout_rate=pi_rate, qi_dropout_rate=qi_rate, eps=EPS,
                                block_q=8, interpret=True)

    def loss(q, qp, it, ip, w1, b1, w2, b2):
        out = fused(q, qp, it, ip, MoLKernelWeights(w1, b1, w2, b2), jnp.int32(seed))
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(8)), has_aux=True)(
        *(jnp.asarray(x[k]) for k in GRAD_NAMES))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_fwd_and_grads(x, cot, p_q, p_x, pi_rate, qi_rate, seed):
    leaves = [torch.from_numpy(x[k]).requires_grad_(True) for k in GRAD_NAMES]
    before = (mol_loss_train.fused_mol_loss_forward.launches,
              mol_loss_train.fused_mol_loss_backward.launches)
    out = mol_loss_train.fused_mol_loss(*leaves, seed, p_q=p_q, p_x=p_x, temperature=TEMP,
                                        qi_rate=qi_rate, pi_rate=pi_rate, eps=EPS)
    (out * torch.from_numpy(cot)).sum().backward()
    assert (mol_loss_train.fused_mol_loss_forward.launches,
            mol_loss_train.fused_mol_loss_backward.launches) == before
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _assert_grads_close(got, want):
    """tests/test_pallas_mol_train.py:125-134: positions where the renorm clamps
    at eps amplify f32 noise by 1/eps, so <= 0.1% stragglers within a loose
    bound are allowed."""
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert a.shape == b.shape, name
        err = np.abs(a - b) / (3e-3 + 3e-3 * np.abs(b))
        assert np.mean(err > 1.0) <= 1e-3, (name, err.max(), np.mean(err > 1.0))
        scale = max(1.0, float(np.max(np.abs(b))))
        assert np.max(np.abs(a - b)) < 0.05 * scale, name


@pytest.mark.parametrize(
    "pi_rate,qi_rate,m,r",
    [(0.0, 0.0, 24, 40), (0.2, 0.0, 24, 40), (0.2, 0.1, 20, 130), (0.5, 0.3, 8, 128)],
)
def test_fused_mol_loss_matches_pallas(pi_rate, qi_rate, m, r):
    x = _inputs(m, r)
    cot = np.random.default_rng(7).standard_normal((m, r)).astype(np.float32)
    want_out, want_grads = _jax_fwd_and_grads(x, cot, P_Q, P_X, pi_rate, qi_rate, SEED)
    got_out, got_grads = _port_fwd_and_grads(x, cot, P_Q, P_X, pi_rate, qi_rate, SEED)
    np.testing.assert_allclose(got_out, want_out, rtol=2e-4, atol=2e-4)
    _assert_grads_close(got_grads, want_grads)


def test_fused_mol_loss_matches_pallas_at_ml20m_geometry():
    """8x4x128 with H = 128 (ml-20m's MoL), R = 128, a small M, both rates on."""
    m, r = 16, 128
    x = _inputs(m, r, p_q=8, p_x=4, d_p=128, h=128, seed=3, normalize=True)
    cot = np.random.default_rng(8).standard_normal((m, r)).astype(np.float32)
    want_out, want_grads = _jax_fwd_and_grads(x, cot, 8, 4, 0.2, 0.1, -98765)
    got_out, got_grads = _port_fwd_and_grads(x, cot, 8, 4, 0.2, 0.1, -98765)
    np.testing.assert_allclose(got_out, want_out, rtol=2e-4, atol=2e-4)
    _assert_grads_close(got_grads, want_grads)


@pytest.mark.parametrize("salt", [_QI_SALT, _PI_SALT], ids=["qi", "pi"])
@pytest.mark.parametrize("seed", [0, 12345, -(2**31), 2**31 - 1])
def test_hash_keep_global_is_bit_equal(salt, seed):
    """The (L, M, R) stream at the padded extents of (m=20, r=130), and the
    n-major (M, R, L) mask the port's loss uses, bit for bit."""
    assert int(salt) in (hash_dropout.QI_SALT, hash_dropout.PI_SALT)
    m, r, l = 20, 130, P_Q * P_X
    mp, rp = mol_loss_train.padded_extents(m, r)
    assert (mp, rp) == (24, 256)
    rate = 0.3
    want = np.asarray(hash_keep_global(jnp.int32(seed), salt, l, mp, rp, rate))
    got = hash_dropout.hash_keep_global_reference(seed, int(salt), l, mp, rp, rate, "cpu")
    assert np.array_equal(got.numpy(), want)
    inv = np.argsort(m_major_perm(P_Q, P_X))
    assert np.array_equal(mol_loss_train.lprime(P_Q, P_X).numpy(), inv)
    mask = mol_loss_train.loss_mask(seed, int(salt), m, r, P_Q, P_X, rate, "cpu")
    assert np.array_equal(mask.numpy(), want[inv][:, :m, :r].transpose(1, 2, 0))


def test_padded_extents_follow_the_pallas_blocks():
    assert mol_loss_train.padded_extents(26_880, 128) == (26_880, 128)
    assert mol_loss_train.padded_extents(5, 7) == (5, 128)
    assert mol_loss_train.padded_extents(13, 129) == (16, 256)


def _scatter_case(name):
    rng = np.random.default_rng(len(name))
    num_rows, d = 300, 128
    if name == "duplicates":
        ids = rng.integers(0, 40, (6, 50))
    elif name == "wrap_and_drop":
        ids = rng.integers(-num_rows - 20, num_rows + 20, (4, 77))
    elif name == "empty":
        ids = np.zeros((0,), np.int64)
    elif name == "narrow":
        num_rows, d = 97, 40
        ids = rng.integers(-5, num_rows, (3, 31))
    else:
        ids = rng.integers(0, num_rows, (2, 64))
    rows = rng.standard_normal(ids.shape + (d,)).astype(np.float32)
    return ids.astype(np.int32), rows, num_rows


@pytest.mark.parametrize("case", ["duplicates", "wrap_and_drop", "empty", "narrow", "bf16"])
def test_scatter_add_rows_matches_pallas(case):
    ids, rows, num_rows = _scatter_case(case)
    if case == "bf16":
        j_rows = jnp.asarray(rows).astype(jnp.bfloat16)
        t_rows = torch.from_numpy(rows).to(torch.bfloat16)
    else:
        j_rows, t_rows = jnp.asarray(rows), torch.from_numpy(rows)
    if ids.size:
        want = np.asarray(jax_scatter_add_rows(jnp.asarray(ids), j_rows, num_rows,
                                               interpret=True, out_dtype=jnp.float32))
    else:
        want = np.zeros((num_rows, rows.shape[-1]), np.float32)
    before = scatter_add.scatter_add_rows.launches
    got = scatter_add.scatter_add_rows(torch.from_numpy(ids), t_rows, num_rows,
                                       out_dtype=torch.float32)
    assert scatter_add.scatter_add_rows.launches == before
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_gather_rows_gradient_matches_indexing():
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal((50, 24)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-50, 50, (7, 9)).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((7, 9, 24)).astype(np.float32))
    grads = []
    for fn in (scatter_add.gather_rows, lambda t, i: t[i.long()]):
        leaf = table.clone().requires_grad_(True)
        out = fn(leaf, ids)
        (out * w).sum().backward()
        grads.append((out.detach(), leaf.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=0, atol=0)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-6, atol=1e-6)
