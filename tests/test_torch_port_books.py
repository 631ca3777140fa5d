"""The Amazon Books configuration (`amzn-books-hstu-mol[-fast]`) vs rails_tpu.

Books trains through the XLA block path (`fused_train=False`) in bf16, with
an 8x8x32 MoL (L = 64 logits, H = 128) and geglu projections, no uid
components and `mi_loss` as its only aux loss; `-fast` adds shared negatives
and the bf16 K5. Here, at small depth (2 blocks, a few thousand items, short
histories), with numpy-seeded inputs and fixed negatives on both sides:

- the XLA-path train step vs `make_train_step`, every dropout at 0, in f32 at
  `ml-1m-hstu-mol` widths (D=50, h=2, dqk=dv=25; rtol 1e-4 on the loss,
  5e-3 / 1e-4 on gradients, as the fused step's test) and in bf16 at Books
  widths (the bf16 step's tolerances: loss rtol 1e-2, each parameter group's
  gradients within 7e-2 of its largest value), then 3 optimizer steps;
- the XLA path's attention and o_input dropout by rate and scale;
- the bf16 K5 plain versions vs `make_fused_mol_loss` (interpret mode) at the
  Books geometry with a small M: forward and 8 gradients;
- the 8x8x32 plain versions of K2, K8, K9 and K10 vs the Pallas kernels on
  f32, bf16 and int8 tables;
- the Books eval step vs `make_eval_step_fn` (MoLBruteForceTopK,
  MoLBruteForceTopKFused, MoLCertTopK{n}), f32 and bf16;
- `state_dict_from_jax_params` on a Books tree.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.core import config as jax_config
from rails_tpu.core.config import get_experiment_config
from rails_tpu.data import datasets as jax_datasets
from rails_tpu.index import top_k as jtk
from rails_tpu.losses.sampled_softmax import get_weighted_loss as jax_weighted_loss
from rails_tpu.losses.sampled_softmax import sampled_softmax_loss as jax_loss
from rails_tpu.ops.pallas import mol_scoring as jax_mol
from rails_tpu.ops.pallas.mol_loss_train import make_fused_mol_loss
from rails_tpu.train import evaluation as jax_eval
from rails_tpu.train import loop as jax_loop
from rails_tpu_torch.compat.from_jax import fused_tables_from_jax, state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.data.features import SequentialFeatures
from rails_tpu_torch.models import hstu as port_hstu
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.ops import mol_loss_train, mol_scoring
from rails_tpu_torch.train import evaluation as port_eval
from tests.test_torch_port_train_step import _configure, _fix_negatives, _port_batch, _port_state

NUM_ITEMS = 600
NO_DROPOUT_MOL = dict(query_dropout_rate=0.0, uid_dropout_rate=0.0, item_dropout_rate=0.0,
                      softmax_dropout_rate=0.0, gating_qi_dropout_rate=0.0,
                      gating_item_dropout_rate=0.0)
# The bf16 step's tolerances, as in tests/test_torch_port_bf16_train.py.
BF16_LOSS_RTOL, BF16_GRAD_TOL = 1e-2, 7e-2
ROW_TOL = 1e-2      # K2 / K10 with bf16 rounding points, of each row's largest |score|


def _small(cfg, fast: bool = False, batch: int = 4, negatives: int = 64):
    """`cfg` at 2 blocks over a synthetic corpus of NUM_ITEMS items with
    histories of 10 (N = 13), every dropout off; learning rate 1e-4, at which
    three steps on one batch of 4 do not yet collapse the loss."""
    return _configure(cfg, dict(
        hstu=dict(num_blocks=2, linear_dropout_rate=0.0, attn_dropout_rate=0.0),
        train=dict(dropout_rate=0.0, local_batch_size=batch, eval_batch_size=batch,
                   learning_rate=1e-4,
                   num_negatives=negatives, gr_output_length=2, shared_negatives=fast,
                   fused_mol_loss=fast),
        mol=NO_DROPOUT_MOL,
        data=dict(dataset_name="synthetic", max_sequence_length=10, synthetic_num_users=64,
                  synthetic_num_items=NUM_ITEMS),
    ))


def _setup(name: str, fast: bool = False, f32: bool = False):
    """Both packages' configs, a batch, fixed negatives and the JAX state."""
    cfg, port_cfg = (_small(m.get_experiment_config(name), fast)
                     for m in (jax_config, port_config))
    if f32:
        cfg, port_cfg = (_configure(c, dict(mol=dict(bf16_training=False),
                                            train=dict(main_module_bf16=False, eval_bf16=False)))
                         for c in (cfg, port_cfg))
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.train_dataset.batches(
        batch_size=cfg.train.local_batch_size,
        max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    b, n = batch.features.ids.shape
    shape = (cfg.train.num_negatives,) if fast else (b * (n - 1), cfg.train.num_negatives)
    negatives = np.random.default_rng(5).choice(ds.all_item_ids, size=shape).astype(np.int32)
    with pytest.MonkeyPatch.context() as mp:
        _fix_negatives(mp, negatives)
        model, state, train_step, sampler = jax_loop.create_train_state(
            cfg, ds.max_item_id, ds.all_item_ids, batch)
    return dict(cfg=cfg, port_cfg=port_cfg, ds=ds, batch=batch, model=model, state=state,
                train_step=train_step, sampler=sampler, negatives=negatives,
                params=jax.tree_util.tree_map(np.asarray, state.params),
                opt_state=jax.tree_util.tree_map(np.asarray, state.opt_state))


STEPS = {
    "f32_ml1m": ("ml-1m-hstu-mol", False, True),
    "bf16_books": ("amzn-books-hstu-mol", False, False),
    "bf16_books_fast": ("amzn-books-hstu-mol-fast", True, False),
}


@pytest.fixture(scope="module", params=list(STEPS))
def step_setup(request):
    name, fast, f32 = STEPS[request.param]
    return dict(_setup(name, fast, f32), kind=request.param)


def _group_errors(got: dict, want: dict) -> dict:
    """Per parameter group: (max |got - want|, max |want|)."""
    groups: dict = {}
    for name, w in want.items():
        group = name.split(".")[0]
        err, scale = groups.get(group, (0.0, 0.0))
        groups[group] = (max(err, float((got[name].float() - w).abs().max())),
                         max(scale, float(w.abs().max())))
    return groups


def test_train_step_loss_aux_and_grads_match_jax(step_setup, monkeypatch):
    s = step_setup
    _fix_negatives(monkeypatch, s["negatives"])
    cfg, model = s["cfg"], s["model"]
    features = jax_loop.scatter_target(s["batch"].features, s["batch"].target_ids)

    @jax.jit
    def loss_and_grads(params):
        def loss_fn(p):
            main, aux = model.apply(p, features, s["sampler"], cfg.train.num_negatives,
                                    cfg.train.temperature, True, False, 4,
                                    cfg.train.shared_negatives, method=jax_loss,
                                    rngs={"dropout": jax.random.PRNGKey(0),
                                          "sampler": jax.random.PRNGKey(1)})
            return jax_weighted_loss(main, aux, dict(cfg.train.loss_weights)), (main, aux)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (total, (main, aux)), grads = loss_and_grads(s["params"])
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, grads), s["port_cfg"])
    port, state, train_step = _port_state(s)
    assert not port.cfg.hstu.fused_train
    bf16 = s["kind"] != "f32_ml1m"
    assert port.compute_dtype == (torch.bfloat16 if bf16 else torch.float32)
    before = mol_loss_train.fused_mol_loss_forward.launches
    _, metrics = train_step(state, _port_batch(s["batch"]), torch.Generator().manual_seed(0))
    assert mol_loss_train.fused_mol_loss_forward.launches == before   # CPU: plain versions
    rtol = BF16_LOSS_RTOL if bf16 else 1e-4
    np.testing.assert_allclose(metrics["loss"].item(), float(main), rtol=rtol)
    np.testing.assert_allclose(metrics["loss_incl_aux"].item(), float(total), rtol=rtol)
    want_aux = {"mi_loss"} | (set() if bf16 else {"uid_embedding_l2_norm"})
    assert set(aux) == want_aux
    for key in aux:
        np.testing.assert_allclose(metrics[f"aux/{key}"].item(), float(aux[key]), rtol=rtol,
                                   atol=1e-4 if bf16 else 0.0, err_msg=key)
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want)
    if not bf16:
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=5e-3, atol=1e-4,
                                       err_msg=name)
        return
    for name in got:
        assert got[name].dtype == torch.float32, name
    for group, (err, scale) in _group_errors(got, want).items():
        assert err <= BF16_GRAD_TOL * scale, (group, err, scale)


def test_three_steps_match_jax(step_setup, monkeypatch):
    """Three optimizer steps from the same (params, mu, nu, count)."""
    s = step_setup
    _fix_negatives(monkeypatch, s["negatives"])
    state, rng = s["state"], jax.random.PRNGKey(0)
    want = []
    for _ in range(3):
        state, m = s["train_step"](state, s["batch"], rng)
        want.append(float(m["loss"]))
    _, port_state, train_step = _port_state(s)
    batch, gen = _port_batch(s["batch"]), torch.Generator().manual_seed(0)
    got = []
    for _ in range(3):
        port_state, m = train_step(port_state, batch, gen)
        got.append(m["loss"].item())
    assert port_state.optimizer.state.count == 3
    if s["kind"] == "f32_ml1m":
        np.testing.assert_allclose(got, want, rtol=1e-3)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL)
    assert got[2] < got[0]


def test_state_dict_from_jax_params_books():
    """A Books tree (geglu projections, no uid tables, an 8x8 qi MLP) loads
    strictly, leaf for leaf."""
    s = _setup("amzn-books-hstu-mol")
    sd = state_dict_from_jax_params(s["params"], s["port_cfg"])
    assert not any("uid_embeddings" in k for k in sd)
    assert tuple(sd["mol.query_proj.glu.w.weight"].shape) == (2 * 512, 64)
    assert tuple(sd["mol.gating_qi.hidden.weight"].shape) == (128, 64)
    assert tuple(sd["mol.item_proj.out.weight"].shape) == (8 * 32, 64)
    port = SequentialRecommender(s["port_cfg"], s["ds"].max_item_id, torch.bfloat16,
                                 device="cpu")
    port.load_state_dict(sd, strict=True)
    flat = jax.tree_util.tree_leaves_with_path(s["params"])
    assert len(flat) == len(sd)
    np.testing.assert_array_equal(port.mol.gating_qi.hidden.weight.detach().numpy(),
                                  s["params"]["params"]["mol"]["gating_qi"]["hidden"]["kernel"].T)


def test_xla_path_dropout_sites(monkeypatch):
    """Training on the XLA block path drops the attention weights (after the
    mask) and o_input at their rates, scaling what it keeps by 1/(1 - rate),
    from the generator; eval drops nothing."""
    from rails_tpu_torch.similarity import layers

    cfg = _configure(port_config.get_experiment_config("amzn-books-hstu-mol"),
                     dict(hstu=dict(num_blocks=2, attn_dropout_rate=0.3), mol=NO_DROPOUT_MOL,
                          train=dict(dropout_rate=0.0)))
    seen = []
    real = layers.dropout

    def recording(x, rate, generator):
        out = real(x, rate, generator)
        if rate > 0:
            live = x != 0
            kept = live & (out != 0)
            seen.append((rate, tuple(x.shape)))
            assert abs(1.0 - kept.sum().item() / live.sum().item() - rate) < 0.05, rate
            torch.testing.assert_close(out[kept], (x[kept].float() / (1.0 - rate)).to(x.dtype))
        return out

    monkeypatch.setattr(port_hstu, "dropout", recording)
    model = SequentialRecommender(cfg, 500, torch.bfloat16, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    b, n = 8, cfg.max_seq_len_padded
    lengths = rng.integers(20, n - 1, b)
    ids = np.where(np.arange(n)[None] <= lengths[:, None], rng.integers(1, 500, (b, n)), 0)
    ts = np.sort(rng.integers(1, 1 << 20, (b, n)), axis=1) * (ids > 0)
    feats = SequentialFeatures(*(torch.from_numpy(a.astype(np.int32)) for a in (
        lengths, ids, ts, np.ones((b, n)), np.arange(b))))
    model.encode_sequence(feats, True, torch.Generator().manual_seed(1))
    h, d = cfg.hstu.num_heads, cfg.hstu.dv
    assert seen == [(0.3, (b, h, n, n)), (0.5, (b, n, h * d))] * 2, seen
    seen.clear()
    with torch.no_grad():
        a, b_ = model.encode(feats), model.encode(feats)
    assert seen == [] and torch.equal(a, b_)


def _k5_inputs(m, r, seed=0):
    rng = np.random.default_rng(seed)
    l = 64

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    q, it = normal(m, 8, 32), normal(r, 8, 32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    it /= np.linalg.norm(it, axis=-1, keepdims=True)
    return dict(q_comp=q, qp=normal(m, l), item_comp=it, ip=normal(r, l),
                w1=normal(l, 128, scale=0.125), b1=normal(1, 128, scale=0.1),
                w2=normal(128, l, scale=0.09), b2=normal(1, l, scale=0.1))


K5_NAMES = ("q_comp", "qp", "item_comp", "ip", "w1", "b1", "w2", "b2")
K5_BF16 = ("q_comp", "qp", "item_comp", "ip")


def test_bf16_k5_plain_matches_pallas():
    """The bf16 K5 at 8x8x32, H=128 (bf16 operands, f32 weights): the plain
    forward within 1e-2 of its largest |value| and each gradient within 2e-2
    of its largest |value| of `make_fused_mol_loss` on the same bf16 inputs,
    at M=13 and R=130 (both padded by the JAX kernel) with both dropouts on;
    the operands' gradients bf16, the weights' f32, as in JAX."""
    pi_rate, qi_rate, m, r = 0.2, 0.1, 13, 130
    x = _k5_inputs(m, r, seed=m)
    cot = np.random.default_rng(7).standard_normal((m, r)).astype(np.float32)
    fused = make_fused_mol_loss(p_q=8, p_x=8, temperature=0.05, softmax_dropout_rate=pi_rate,
                                qi_dropout_rate=qi_rate, eps=1e-6, block_q=8, interpret=True)

    def loss(q, qp, it, ip, w1, b1, w2, b2):
        out = fused(q, qp, it, ip, jax_mol.MoLKernelWeights(w1, b1, w2, b2), jnp.int32(-4321))
        return jnp.sum(out * cot), out

    jargs = [jnp.asarray(x[k], jnp.bfloat16 if k in K5_BF16 else jnp.float32) for k in K5_NAMES]
    (_, want), want_grads = jax.value_and_grad(loss, argnums=tuple(range(8)),
                                               has_aux=True)(*jargs)
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16 if k in K5_BF16 else torch.float32) for k, a in zip(K5_NAMES, jargs)]
    kw = dict(p_q=8, p_x=8, temperature=0.05, qi_rate=qi_rate, pi_rate=pi_rate, eps=1e-6)
    got = mol_loss_train.fused_mol_loss_forward(*targs, -4321, **kw)
    grads = mol_loss_train.fused_mol_loss_backward(*targs, -4321, torch.from_numpy(cot), **kw)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-2 * np.abs(want).max()
    for name, g, w, a in zip(K5_NAMES, grads, want_grads, targs):
        assert g.dtype == a.dtype and str(w.dtype) == str(a.dtype).split(".")[-1], name
        w = np.asarray(w.astype(jnp.float32))
        assert np.abs(g.float().numpy() - w).max() <= 2e-2 * np.abs(w).max(), name


@pytest.fixture(scope="module")
def serving():
    """An untrained f32 Books model (2 blocks) over NUM_ITEMS items (3 tiles
    of 256, the last one padded) and one batch of 16 queries."""
    cfg = _configure(_small(get_experiment_config("amzn-books-hstu-mol"), batch=16),
                     dict(mol=dict(bf16_training=False),
                          train=dict(main_module_bf16=False, eval_bf16=False)))
    port_cfg = _configure(_small(port_config.get_experiment_config("amzn-books-hstu-mol"),
                                 batch=16),
                          dict(mol=dict(bf16_training=False),
                               train=dict(main_module_bf16=False, eval_bf16=False)))
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.eval_dataset.batches(
        batch_size=16, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    all_ids = np.arange(1, NUM_ITEMS + 1, dtype=np.int32)
    model, state, _, _ = jax_loop.create_train_state(cfg, NUM_ITEMS, all_ids, batch)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    return dict(cfg=cfg, port_cfg=port_cfg, model=model, params=params, batch=batch,
                all_ids=all_ids)


def _port_model(s, dtype):
    port = SequentialRecommender(s["port_cfg"], NUM_ITEMS, dtype, device="cpu")
    port.load_state_dict(state_dict_from_jax_params(s["params"], s["port_cfg"]), strict=True)
    return port


def _assert_row_close(got, want, tol):
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= tol * scale).all(), np.abs(got - want).max()


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_8x8_scoring_plain_matches_pallas(serving, kind):
    """K2, K10, K8 and K9 at 8x8x32 on the JAX package's own tables
    (`fused_tables_from_jax`): f32 tables to rtol 1e-4 (K8, K9 to 1e-5),
    bf16 and int8 tables, whose MLP rounds to bf16, K2/K10 within 1e-2 of each
    row's largest |score|, K8/K9 to 1e-5 of their largest value."""
    s = serving
    model, params = s["model"], s["params"]
    ids = jnp.asarray(s["all_ids"])
    emb = model.apply(params, ids, method=model.get_item_embeddings)
    table = jnp.float32 if kind == "float32" else jnp.bfloat16
    jstate = jtk.build_mol_topk_state(model, params, ids, emb, table_dtype=table,
                                      build_fused=True, quantize_fused=kind == "int8")
    jft = jstate.fused_tables
    pft = fused_tables_from_jax(jax.tree_util.tree_map(np.asarray, jft))
    q = model.apply(params, s["batch"].features, method=model.encode)
    jq = model.apply(params, q, s["batch"].features.user_ids, method=model.query_components)
    jq = jq.astype(jnp.float32 if kind == "float32" else jnp.bfloat16)
    qp = model.apply(params, q, method=model.query_gating_partial)
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(
        torch.float32 if kind == "float32" else torch.bfloat16)
    tqp = torch.from_numpy(np.array(qp))
    temp = float(model.cfg.mol.temperature)
    scales = dict(comp_scale=jft.comp_scale, partial_scale=jft.partial_scale)
    port = _port_model(s, torch.float32)
    w = mol_scoring.extract_gating_qi_weights(port.mol)
    tiles = np.array([2, 0, 1, 1], dtype=np.int32)          # the last (padded) tile, a duplicate
    with torch.inference_mode():
        got_k2 = mol_scoring.fused_mol_scores_t(tq, tqp, pft.item_comp_t, pft.item_partial_t, w,
                                                temp, pft.comp_scale, pft.partial_scale).numpy()
        got_k10 = mol_scoring.fused_mol_scores_tiles(
            tq, tqp, torch.from_numpy(tiles), pft.item_comp_t, pft.item_partial_t, w, temp,
            pft.comp_scale, pft.partial_scale).numpy()
        got_ub = mol_scoring.fused_mol_ub_t(tq, pft.item_comp_t, temp, pft.comp_scale).numpy()
        got_gm = mol_scoring.fused_mol_group_block_max(tq, pft.item_comp_t, temp,
                                                       pft.comp_scale).numpy()
    jw = jax_mol.extract_gating_qi_weights(params)
    want_k2 = np.asarray(jax_mol.fused_mol_scores_t(
        jq, qp, jft.item_comp_t, jft.item_partial_t, jw, temp, block_x=256, interpret=True,
        **scales))
    want_k10 = np.asarray(jax_mol.fused_mol_scores_tiles(
        jq, qp, jnp.asarray(tiles), jft.item_comp_t, jft.item_partial_t, jw, temp, block_x=256,
        interpret=True, **scales))
    want_ub = np.asarray(jax_mol.fused_mol_ub_t(jq, jft.item_comp_t, temp, block_x=256,
                                                interpret=True, comp_scale=jft.comp_scale))
    want_gm = np.asarray(jax_mol.fused_mol_group_block_max(
        jq, jft.item_comp_t, temp, block_x=256, interpret=True, comp_scale=jft.comp_scale))
    real = (tiles[:, None] * 256 + np.arange(256)).reshape(-1) < NUM_ITEMS
    assert got_gm.shape == want_gm.shape == (16, 64, 3)
    if kind == "float32":
        np.testing.assert_allclose(got_k2[:, :NUM_ITEMS], want_k2[:, :NUM_ITEMS], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got_k10[:, real], want_k10[:, real], rtol=1e-4, atol=1e-4)
    else:
        _assert_row_close(got_k2[:, :NUM_ITEMS], want_k2[:, :NUM_ITEMS], ROW_TOL)
        _assert_row_close(got_k10[:, real], want_k10[:, real], ROW_TOL)
    np.testing.assert_allclose(got_ub, want_ub, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_gm[:, jax_mol.m_major_perm(8, 8)], want_gm, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("method,dtype", [
    ("MoLBruteForceTopK", "float32"), ("MoLBruteForceTopKFused", "float32"),
    ("MoLCertTopK300", "float32"), ("MoLBruteForceTopK", "bfloat16"),
    ("MoLBruteForceTopKFused", "bfloat16")])
def test_books_eval_step_matches_jax(serving, method, dtype):
    """The Books eval step on both sides. f32 (model and tables): equal ranks,
    scores within 1e-4, ids equal where scores stand apart. bf16 (encoder in
    bf16, bf16 tables): ranks equal on >= 90% of rows, scores within 2e-2 of
    each row's largest |score| (the XLA encoder rounds op by op)."""
    s = serving
    model, params, batch = s["model"], s["params"], s["batch"]
    bf16 = dtype == "bfloat16"
    if bf16:
        cfg = _configure(s["cfg"], dict(train=dict(main_module_bf16=True, eval_bf16=True)))
        model, _ = jax_loop.init_model(cfg, NUM_ITEMS, jax.random.PRNGKey(0), batch,
                                       all_item_ids=s["all_ids"])
    jes = jax_eval.get_eval_state(model, params, s["all_ids"], method,
                                  table_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    jstep = jax_eval.make_eval_step_fn(model, method, k=30, num_objects=jes.num_objects,
                                       truncate_k_prime_to=60)
    ranks, ids, scores = (np.asarray(a) for a in jstep(
        params, jes.topk_state, jes.item_embeddings, batch.features, batch.target_ids))
    port = _port_model(s, torch.bfloat16 if bf16 else torch.float32)
    pes = port_eval.get_eval_state(port, s["all_ids"], method,
                                   table_dtype=torch.bfloat16 if bf16 else torch.float32,
                                   device="cpu")
    pstep = port_eval.make_eval_step_fn(port, method, k=30, num_objects=pes.num_objects,
                                        truncate_k_prime_to=60)
    feats = SequentialFeatures(*(torch.from_numpy(np.array(f)) for f in batch.features))
    p_ranks, p_ids, p_scores = (t.numpy() for t in pstep(
        pes.topk_state, feats, torch.from_numpy(np.array(batch.target_ids)),
        pes.item_embeddings))
    if bf16:
        # JAX's own bf16 and f32 steps differ by up to 1.5e-2 of a row's
        # largest |score| at the top-1 on these weights; bf16 elementwise
        # chains (geglu, LayerNorm) round at other places in the two packages.
        top1 = np.abs(p_scores[:, 0] - scores[:, 0]) / np.abs(scores).max(axis=1)
        overlap = (p_ids[:, :, None] == ids[:, None, :]).any(axis=2).mean()
        assert top1.max() <= 3e-2 and (p_ranks == ranks).mean() >= 0.9 and overlap >= 0.8
        return
    np.testing.assert_array_equal(p_ranks, ranks)
    np.testing.assert_allclose(p_scores, scores, rtol=1e-4, atol=1e-4)
    gap = np.abs(np.diff(scores, axis=1)) > 1e-5
    isolated = np.ones_like(scores, dtype=bool)
    isolated[:, 1:] &= gap
    isolated[:, :-1] &= gap
    np.testing.assert_array_equal(p_ids[isolated], ids[isolated])
