"""K6 (row scatter-add) and K7 (AdamW over many leaves): their host-side
logic and their plain versions vs the JAX package.

The Pallas kernels run in interpret mode on the CPU; the port's wrappers get
CPU tensors, so they run their plain PyTorch versions and launch nothing.
Inputs come from a numpy seed and reach both sides as the same values.
"""

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from rails_tpu.ops.pallas.scatter_add import scatter_add_rows as jax_scatter_add_rows
from rails_tpu.train.fused_adamw import fused_adamw
from rails_tpu_torch.ops import scatter_add
from rails_tpu_torch.train import fused_adamw as port_adamw

ADAMW_TOL = dict(rtol=1e-6, atol=1e-6)         # tests/test_fused_adamw.py
KW = dict(lr=1e-3, c1=10.0, c2=50.5, b1=0.9, b2=0.98, eps=1e-8, wd=1e-3)


def _leaves(numels, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in numels:
        g, p, mu = (rng.standard_normal(n).astype(np.float32) * s for s in (1e-2, 1.0, 1e-3))
        nu = 1e-5 * rng.random(n).astype(np.float32)
        out.append(tuple(torch.from_numpy(x) for x in (g, p, mu, nu)))
    return out


def test_adamw_update_leaves_reference_is_the_per_leaf_plain_version():
    leaves = _leaves((1, 7, 4099, 300 * 64))
    got = [(g, *(t.clone() for t in rest)) for g, *rest in leaves]
    want = [(g, *(t.clone() for t in rest)) for g, *rest in leaves]
    port_adamw.adamw_update_leaves_reference(got, **KW)
    for g, p, mu, nu in want:
        port_adamw.adamw_leaf_update_reference(g, p, mu, nu, **KW)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_adamw_update_leaves_on_the_cpu_runs_the_plain_version():
    leaves = _leaves((5, 128, 1000), seed=1)
    got = [(g, *(t.clone() for t in rest)) for g, *rest in leaves]
    want = [(g, *(t.clone() for t in rest)) for g, *rest in leaves]
    before = port_adamw.adamw_update_leaves.launches
    port_adamw.adamw_update_leaves(got, **KW)
    port_adamw.adamw_leaf_update(*got[0], **KW)
    port_adamw.adamw_update_leaves([], **KW)
    assert port_adamw.adamw_update_leaves.launches == before
    port_adamw.adamw_update_leaves_reference(want, **KW)
    port_adamw.adamw_leaf_update_reference(*want[0], **KW)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_leaf_table_refuses_what_the_kernel_does_not_take():
    leaves = _leaves((64, 130))
    cpu = torch.device("cpu")
    assert port_adamw.leaf_table(leaves, cpu) == [
        *(leaf[k].data_ptr() for k in (1, 2, 3, 0) for leaf in leaves), 64, 130]
    g, p, mu, nu = leaves[1]
    with pytest.raises(ValueError, match="leaf 1: p is not 16-byte aligned"):
        port_adamw.leaf_table([leaves[0], (g, torch.zeros(131)[1:], mu, nu)], cpu)
    with pytest.raises(ValueError, match="leaf 1: mu must be a contiguous f32"):
        port_adamw.leaf_table([leaves[0], (g, p, mu.double(), nu)], cpu)
    with pytest.raises(ValueError, match="leaf 0: g must be a contiguous f32"):
        port_adamw.leaf_table([(g[:64], p, mu, nu)], cpu)
    with pytest.raises(ValueError, match="leaf 0: nu must be a contiguous f32"):
        port_adamw.leaf_table([(g, p, mu, torch.zeros(2 * 130)[::2])], cpu)
    with pytest.raises(ValueError, match="leaf 1: g lies on cpu, not meta"):
        port_adamw.leaf_table([tuple(t.to("meta") for t in leaves[0]), leaves[1]],
                              torch.device("meta"))


def test_fused_adamw_step_sends_every_fused_leaf_in_one_call(monkeypatch):
    """FusedAdamW.step hands the kernel's entry point its fused leaves once
    per step and updates the others through the plain version."""
    params = {"a": torch.zeros(256 * 3), "b": torch.zeros(8), "c": torch.zeros(128 * 4),
              "d": torch.zeros(100)}
    opt = port_adamw.FusedAdamW(params, 1e-3, min_fused_elements=256)
    calls = []
    real = port_adamw.adamw_update_leaves
    monkeypatch.setattr(port_adamw, "adamw_update_leaves",
                        lambda leaves, **kw: (calls.append(len(leaves)), real(leaves, **kw)))
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    for _ in range(3):
        opt.step(grads)
    assert calls == [2, 2, 2]          # "a" and "c": >= 256 elements, a multiple of 128
    assert opt.state.count == 3 and all(bool(p.ne(0).all()) for p in params.values())


@pytest.mark.parametrize("warmup", [False, True], ids=["constant", "warmup"])
def test_fused_adamw_over_two_fused_leaves_matches_jax(warmup):
    """Three steps with two fused leaves and two plain ones against the JAX
    fused_adamw (its Pallas kernel in interpret mode): parameters and
    moments, and no kernel launch on the CPU."""
    rng = np.random.default_rng(5)
    shapes = {"item": (320, 64), "uid": (160, 128), "w": (16, 8), "b": (8,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (0.05 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    if warmup:
        jax_lr = optax.linear_schedule(1e-4, 1e-3, transition_steps=3)
        port_lr = port_adamw.linear_schedule(1e-4, 1e-3, 3)
    else:
        jax_lr = port_lr = 1e-3
    kw = dict(b1=0.9, b2=0.98, eps=1e-8, weight_decay=1e-3, min_fused_elements=160 * 128)
    opt = fused_adamw(jax_lr, interpret=True, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    popt = port_adamw.FusedAdamW(tp, port_lr, **kw)
    assert [popt.fused(int(np.prod(s))) for s in shapes.values()] == [True, True, False, False]
    before = port_adamw.adamw_update_leaves.launches
    for g in grads:
        updates, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, updates)
        popt.step({k: torch.from_numpy(v) for k, v in g.items()})
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), err_msg=k, **ADAMW_TOL)
            np.testing.assert_allclose(popt.state.mu[k].numpy(), np.asarray(st.mu[k]),
                                       **ADAMW_TOL)
            np.testing.assert_allclose(popt.state.nu[k].numpy(), np.asarray(st.nu[k]),
                                       **ADAMW_TOL)
    assert port_adamw.adamw_update_leaves.launches == before


@pytest.mark.parametrize("m,num_rows,d", [(0, 1, 4), (1, 1, 64), (27_008, 26_745, 256),
                                          (3_904, 695_763, 64), (100_000, 7, 40)])
def test_scratch_layout_is_aligned_disjoint_and_large_enough(m, num_rows, d):
    lay = scatter_add.scratch_layout(m, num_rows, d)
    off = lay["offsets"]
    names = list(off)
    assert names == list(scatter_add._SCRATCH_PARTS)
    assert all(v % 16 == 0 for v in off.values())
    assert [off[k] for k in names] == sorted(off[k] for k in names)
    assert lay["zero_bytes"] == off["wid"] >= off["cnt"] + 4 * num_rows
    assert off["chunk_cnt"] - off["status"] >= 8 * (num_rows // scatter_add.SCAN_TILE + 1)
    assert off["counters"] - off["chunk_cnt"] >= 4 * lay["max_long"] * lay["chunks"]
    assert off["rank"] - off["slots"] >= 4 * m and off["long_row"] - off["rank"] >= 4 * m
    assert lay["chunks"] * scatter_add.RANK_CHUNK >= m
    assert lay["bytes"] - off["partial"] >= 4 * lay["max_pieces"] * d
    # What the scan can register: rows of more than SHORT updates and their pieces.
    rng = np.random.default_rng(m)
    just_long = np.repeat(np.arange(m // (scatter_add.SHORT + 1) + 1), scatter_add.SHORT + 1)
    for ids in (np.zeros(m, np.int64), rng.integers(0, num_rows, m), just_long[:m]):
        counts = np.bincount(ids % num_rows, minlength=num_rows) if m else np.zeros(1, int)
        long_counts = counts[counts > scatter_add.SHORT]
        assert long_counts.size <= lay["max_long"]
        assert int(np.sum(-(-long_counts // scatter_add.PIECE))) <= lay["max_pieces"]


@pytest.mark.parametrize("d,vec,lanes", [(256, 4, 32), (128, 4, 32), (64, 4, 16), (24, 4, 8),
                                         (4, 4, 4), (40, 1, 32), (7, 1, 8), (1000, 4, 32)])
def test_lanes_per_row(d, vec, lanes):
    assert scatter_add.lanes_per_row(d, vec) == lanes


def _books_case(rows_dtype):
    """Amazon Books widths (D = 64, the lane-packed route of the JAX
    function) with ~57% padding, cut to 2,000 rows for interpret mode."""
    rng = np.random.default_rng(61)
    num_rows, d = 2_000, 64
    ids = rng.integers(-num_rows, num_rows, (8, 61))
    ids = np.where(rng.random((8, 61)) < 0.57, 0, ids).astype(np.int32)
    rows = rng.standard_normal(ids.shape + (d,)).astype(np.float32)
    return ids, rows, num_rows, rows_dtype


@pytest.mark.parametrize("rows_dtype,out_dtype", [("float32", "float32"),
                                                  ("bfloat16", "float32"),
                                                  ("float32", "bfloat16")])
def test_scatter_add_rows_at_books_width_matches_pallas(rows_dtype, out_dtype):
    ids, rows, num_rows, _ = _books_case(rows_dtype)
    j_rows = jnp.asarray(rows).astype(rows_dtype)
    t_rows = torch.from_numpy(rows).to(getattr(torch, rows_dtype))
    want = np.asarray(jax_scatter_add_rows(jnp.asarray(ids), j_rows, num_rows, interpret=True,
                                           out_dtype=getattr(jnp, out_dtype)).astype(jnp.float32))
    before = scatter_add.scatter_add_rows.launches
    got = scatter_add.scatter_add_rows(torch.from_numpy(ids), t_rows, num_rows,
                                       out_dtype=getattr(torch, out_dtype))
    assert scatter_add.scatter_add_rows.launches == before
    assert got.dtype == getattr(torch, out_dtype) and got.shape == want.shape
    # f32 sums in other orders; a bf16 table rounds them once more.
    tol = 2.0**-8 if out_dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


class _FakeLib:
    """The kernel library's entry points, recording each call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def kernel_route(monkeypatch):
    """The wrappers' CUDA route on CPU tensors, with a recording library in
    place of the built one (no kernel runs)."""
    from contextlib import nullcontext

    from rails_tpu_torch.ops import _build

    lib = _FakeLib()
    for module in (scatter_add, port_adamw):
        monkeypatch.setattr(module, "use_kernel", lambda *tensors: True)
    for wrapper in (scatter_add.scatter_add_rows, port_adamw.adamw_update_leaves):
        monkeypatch.setattr(wrapper, "launches", wrapper.launches)   # restored afterwards
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 0})())
    return lib


def _torch_calls(fn):
    from torch.overrides import TorchFunctionMode

    class Record(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.names.append(getattr(func, "__name__", str(func)))
            return func(*args, **(kwargs or {}))

    with Record() as record:
        out = fn()
    return out, record.names


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_scatter_add_rows_kernel_route_is_one_call_and_no_torch_sort(kernel_route, ids_dtype):
    """On the kernel route the wrapper allocates the table and the scratch and
    makes one call: no sort, search, scan, select or cast in torch."""
    ids = torch.randint(-60, 60, (4, 9), dtype=ids_dtype)
    rows = torch.randn(4, 9, 64)
    out, names = _torch_calls(lambda: scatter_add.scatter_add_rows(ids, rows, 50,
                                                                   out_dtype=torch.bfloat16))
    assert out.shape == (50, 64) and out.dtype == torch.bfloat16
    assert set(names) <= {"__get__", "numel", "reshape", "contiguous", "empty", "data_ptr",
                          "element_size"}, names
    assert [name for name, _ in kernel_route.calls] == ["rails_scatter_add_rows"]
    args = kernel_route.calls[0][1]
    lay = scatter_add.scratch_layout(36, 50, 64)
    assert args[:3] == ((0 if ids_dtype == torch.int32 else 1), 0, 1)
    assert args[6:16] == (36, 50, 64, 4, 16, lay["max_long"], lay["max_pieces"], lay["chunks"],
                          args[14], lay["zero_bytes"])
    assert args[17] - args[14] == lay["offsets"]["counters"] - lay["offsets"]["status"]


def test_fused_adamw_step_kernel_route_is_one_call_for_every_fused_leaf(kernel_route):
    params = {"a": torch.zeros(256 * 3), "b": torch.zeros(8), "c": torch.zeros(128 * 4)}
    opt = port_adamw.FusedAdamW(params, 1e-3, min_fused_elements=256)
    before = port_adamw.adamw_update_leaves.launches
    opt.step({k: torch.ones_like(p) for k, p in params.items()})
    assert port_adamw.adamw_update_leaves.launches == before + 1
    (name, args), = kernel_route.calls
    assert name == "rails_adamw_update_leaves" and args[0] == 2
    table = list(args[1])
    assert table[:2] == [params["a"].data_ptr(), params["c"].data_ptr()]    # the p pointers
    assert table[8:] == [256 * 3, 128 * 4]                                # the sizes
    assert bool(params["b"].ne(0).all())                          # the plain route, updated
