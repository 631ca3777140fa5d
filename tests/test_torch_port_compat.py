"""The port's checkpoint compatibility with the original torch implementation
(`rails_tpu_torch/compat/torch_import.py`, `torch_export.py`, the
`import_checkpoint` and `export_checkpoint` CLIs), held against the JAX
package on the CPU at synthetic-small's widths (D=32, 2 blocks, N=35).

The original repo is not needed: its checkpoint format is written by the
JAX package's `reference_state_dict_from_params` from JAX parameters drawn
from a numpy seed (every leaf random, so a wrong transpose, slice or stack
shows), for each case of `CASES`: HSTU with MoL (a single Linear for the
query projection and each gating partial, a GLU item projection), MoL with uid embeddings
and the query-only and item-only gating partials, the rated and combined
preprocessors, the categorical embedding, SASRec, the dot-product
similarity, and the legacy `_item_proj_module` spelling.

- The port's import equals `state_dict_from_jax_params` of the same
  parameters bit for bit; its export equals JAX's (keys, order, values, the
  causal mask); export -> import and import -> export are the identity; the
  imported model encodes as JAX's does.
- Files cross between the packages: JAX's export through the port's import
  CLI, the port's export through JAX's `import_torch_checkpoint`.
- AdamW: `torch.optim.AdamW` for 3 steps over reference-format parameters,
  the import, then a fourth step on both sides within JAX's limits (rtol
  2e-5, atol 1e-7), under both `fused_optimizer` settings; the moments equal
  JAX's `optimizer_state_from_reference` through `adamw_state_from_jax` for
  both JAX layouts; int steps, lazy and divergent states.
- The CLIs: import, `cli.eval --ckpt` (the line of a port checkpoint of the
  same weights), `cli.train --restore-from-ckpt`, export and import again;
  `--skip-optimizer`, `--no-strict`, `--num-items`, `--gin-config-file`.
"""

import copy
import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.compat import torch_export as jax_export
from rails_tpu.compat import torch_import as jax_import
from rails_tpu.core.config import get_experiment_config as jax_experiment_config
from rails_tpu.data.features import SequentialFeatures as JaxFeatures
from rails_tpu.models.encoder import SequentialRecommender as JaxRecommender
from rails_tpu.train.loop import make_optimizer as jax_make_optimizer
from rails_tpu.train.loop import model_dtype as jax_model_dtype
from rails_tpu_torch.compat.from_jax import adamw_state_from_jax, state_dict_from_jax_params
from rails_tpu_torch.compat.torch_export import export_torch_checkpoint, reference_state_dict
from rails_tpu_torch.compat.torch_import import (
    import_torch_checkpoint_full,
    optimizer_state_from_reference,
    state_dict_from_reference,
)
from rails_tpu_torch.core.config import get_experiment_config
from rails_tpu_torch.data.features import SequentialFeatures
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.train.loop import make_optimizer

NUM_ITEMS, NUM_CATEGORIES, BATCH = 40, 7, 4
CASES = {
    "hstu-mol": {"mol": dict(uid_embedding_hash_sizes=(), query_hidden_dim=0,
                             item_hidden_dim=32, gating_qi_hidden_dim=0,
                             gating_query_hidden_dim=0, gating_item_hidden_dim=0)},
    "mol-uid-gating": {},
    "hstu-rated": {"input_preprocessor_type": "rated"},
    "hstu-combined": {"input_preprocessor_type": "combined"},
    "categorical": {"embedding_module_type": "categorical",
                    "num_item_categories": NUM_CATEGORIES},
    "sasrec": {"model_type": "SASRec"},
    "dot": {"similarity_type": "DotProduct"},
}
LEGACY = ("_ndp_module._item_embeddings_fn._item_emb_proj_module", "_ndp_module._item_proj_module")
# `tests/test_torch_import.py:570-573`: a step of torch's AdamW against
# another implementation of the same update.
ADAMW_RTOL, ADAMW_ATOL = 2e-5, 1e-7
TINY = ["--set", "data.synthetic_num_users=96", "--set", "data.synthetic_num_items=120",
        "--set", "train.local_batch_size=16", "--set", "train.eval_batch_size=16",
        "--set", "train.num_negatives=8", "--set", "train.eval_interval=100",
        "--set", "train.partial_eval_num_iters=1"]
CLI_ITEMS = 120


def _configure(cfg, changes: dict):
    """Apply `CASES`' changes; the same code serves both packages' configs."""
    for key, value in changes.items():
        if isinstance(value, dict):
            cfg = cfg.replace(**{key: getattr(cfg, key).replace(**value)})
        else:
            cfg = cfg.replace(**{key: value})
    return cfg


def _features(cfg, num_items: int, seed: int = 0):
    """(lengths, ids, timestamps, ratings, user_ids) as numpy, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    n = cfg.max_seq_len_padded
    lengths = rng.integers(1, n - cfg.train.gr_output_length, BATCH).astype(np.int32)
    valid = np.arange(n)[None] < lengths[:, None]
    ids = np.where(valid, rng.integers(1, num_items + 1, (BATCH, n)), 0).astype(np.int32)
    ts = np.where(valid, np.cumsum(rng.integers(1, 5000, (BATCH, n)), axis=1), 0).astype(np.int32)
    ratings = np.where(valid, rng.integers(0, cfg.num_ratings, (BATCH, n)), 0).astype(np.int32)
    return lengths, ids, ts, ratings, np.arange(BATCH, dtype=np.int32)


def _remap(cfg, num_items: int):
    if cfg.embedding_module_type != "categorical":
        return None
    return np.random.default_rng(5).integers(0, NUM_CATEGORIES, num_items).astype(np.int32)


def _jax_model(cfg, num_items: int, seed: int = 1):
    """A JAX model for `cfg` and its parameters ({"params": tree}, numpy
    leaves): the tree's shapes from `jax.eval_shape` of an init through
    `encode` and `similarity_fn`, every leaf 0.1 x N(0, 1) from `seed`."""
    model = JaxRecommender(cfg=cfg, num_items=num_items, dtype=jax_model_dtype(cfg),
                           item_id_to_category_id=_remap(cfg, num_items))
    feats = JaxFeatures(*(jnp.asarray(a) for a in _features(cfg, num_items)))

    def init_all(m, f):
        q = m.encode(f)
        return m.similarity_fn(q, m.get_item_embeddings(f.ids[:, :4]), user_ids=f.user_ids)

    shapes = jax.eval_shape(lambda key: model.init(key, feats, method=init_all),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    return model, params


def _tensors(sd: dict) -> dict:
    """A reference-format numpy state dict as torch tensors, its order kept."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def _case(name: str) -> dict:
    """(JAX config, port config, JAX model, params, reference state dict as
    tensors, the port's state dict of the same parameters) of a case; the
    legacy one is mol-uid-gating's with the old item-projection name."""
    changes = CASES["mol-uid-gating" if name == "legacy" else name]
    jcfg = _configure(jax_experiment_config("synthetic-small"), changes)
    pcfg = _configure(get_experiment_config("synthetic-small"), changes)
    model, params = _jax_model(jcfg, NUM_ITEMS)
    ref = _tensors(jax_export.reference_state_dict_from_params(params, jcfg))
    if name == "legacy":
        ref = {k.replace(*LEGACY): v for k, v in ref.items()}
        assert any(LEGACY[1] in k for k in ref)
    return dict(jcfg=jcfg, pcfg=pcfg, model=model, params=params, ref=ref,
                port=state_dict_from_jax_params(params, pcfg))


def _assert_same(got: dict, want: dict, ordered: bool = False):
    if ordered:
        assert list(got) == list(want)
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        v = torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("name", sorted(CASES) + ["legacy"])
def test_import_equals_state_dict_from_jax_params(name):
    """The import of JAX's reference-format export is the port's state dict
    of the same parameters, bit for bit."""
    case = _case(name)
    got = state_dict_from_reference(case["ref"], case["pcfg"], num_items=NUM_ITEMS)
    _assert_same(got, case["port"])


@pytest.fixture(params=sorted(CASES))
def case(request):
    return _case(request.param)


def test_export_equals_jax_export(case):
    got = reference_state_dict(case["port"], case["pcfg"])
    want = jax_export.reference_state_dict_from_params(case["params"], case["jcfg"])
    _assert_same(got, want, ordered=True)
    assert got["module._attn_mask"].shape == (case["pcfg"].max_seq_len_padded,) * 2
    for ddp, buffers in ((False, True), (True, False)):
        got = reference_state_dict(case["port"], case["pcfg"], ddp, buffers)
        want = jax_export.reference_state_dict_from_params(case["params"], case["jcfg"], ddp,
                                                           buffers)
        _assert_same(got, want, ordered=True)


def test_round_trips_are_the_identity(case):
    pcfg = case["pcfg"]
    back = state_dict_from_reference(reference_state_dict(case["port"], pcfg), pcfg,
                                     num_items=NUM_ITEMS)
    _assert_same(back, case["port"])
    again = reference_state_dict(state_dict_from_reference(case["ref"], pcfg,
                                                           num_items=NUM_ITEMS), pcfg)
    _assert_same(again, case["ref"], ordered=True)


def test_imported_model_encodes_as_jax(case):
    """Within `tests/test_torch_port_models.py`'s f32 limits (rtol = atol =
    1e-5)."""
    pcfg, jcfg = case["pcfg"], case["jcfg"]
    port = SequentialRecommender(pcfg, NUM_ITEMS, device="cpu",
                                 item_id_to_category_id=_remap(pcfg, NUM_ITEMS))
    port.load_state_dict(state_dict_from_reference(case["ref"], pcfg, num_items=NUM_ITEMS),
                         strict=True)
    feats = _features(jcfg, NUM_ITEMS, seed=3)
    want = np.asarray(case["model"].apply(case["params"], JaxFeatures(*map(jnp.asarray, feats)),
                                          method=case["model"].encode))
    with torch.no_grad():
        got = port.encode(SequentialFeatures(*map(torch.from_numpy, feats))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# Files across the packages, strictness
# --------------------------------------------------------------------------- #

def _tiny(cfg_get, override):
    cfg = cfg_get("synthetic-small")
    for key, _, val in (s.partition("=") for s in TINY[1::2]):
        cfg = override(cfg, key, val)
    return cfg


@pytest.fixture(scope="module")
def cli_model():
    """synthetic-small at the CLI tests' sizes (TINY): the JAX config and
    params, the port config and the port's state dict of the params."""
    from rails_tpu.cli.train import apply_override as jax_override
    from rails_tpu_torch.cli.train import apply_override

    jcfg = _tiny(jax_experiment_config, jax_override)
    pcfg = _tiny(get_experiment_config, apply_override)
    _, params = _jax_model(jcfg, CLI_ITEMS, seed=2)
    return dict(jcfg=jcfg, pcfg=pcfg, params=params,
                port=state_dict_from_jax_params(params, pcfg))


def _import_cli(argv):
    from rails_tpu_torch.cli import import_checkpoint

    return import_checkpoint.main(argv + ["--device", "cpu"])


def _export_cli(argv):
    from rails_tpu_torch.cli import export_checkpoint

    return export_checkpoint.main(argv + ["--device", "cpu"])


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_jax_export_file_imports_through_the_port_cli(cli_model, tmp_path):
    path = str(tmp_path / "ref_ep4")
    jax_export.export_torch_checkpoint(cli_model["params"], cli_model["jcfg"], path, epoch=4,
                                       batch_id=30)
    out = _import_cli(["--config", "synthetic-small", *TINY, "--ckpt", path,
                       "--out", str(tmp_path / "run")])
    assert out.endswith(os.path.join("ckpts", "ep4"))
    payload = _load(out)
    _assert_same(payload["model"], cli_model["port"])
    assert (payload["epoch"], payload["batch_id"], payload["step"]) == (4, 30, 0)
    assert payload["opt_state"]["count"] == 0 and payload["generator"] is None
    assert all(not v.any() for v in payload["opt_state"]["mu"].values())


def test_port_export_file_imports_through_jax(cli_model, tmp_path):
    path = str(tmp_path / "port_ref")
    export_torch_checkpoint(cli_model["port"], cli_model["pcfg"], path, epoch=2, batch_id=9)
    payload = _load(path)
    assert set(payload) == {"epoch", "batch_id", "model_state_dict", "optimizer_state_dict"}
    assert payload["optimizer_state_dict"] == {}
    assert {v.dtype for v in payload["model_state_dict"].values()} == {torch.float32, torch.bool}
    params, epoch, batch_id = jax_import.import_torch_checkpoint(path, cli_model["jcfg"])
    assert (epoch, batch_id) == (2, 9)
    want = jax.tree_util.tree_flatten_with_path(cli_model["params"])[0]
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert len(got) == len(want)
    for k, v in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(k)], v)


def test_strict_geometry_and_categorical_errors(cli_model):
    """As JAX's: an unconsumed key raises unless `strict=False`; a config of
    another geometry lists every mismatch; a categorical config needs
    `num_items`."""
    pcfg, jcfg = cli_model["pcfg"], cli_model["jcfg"]
    ref = _tensors(jax_export.reference_state_dict_from_params(cli_model["params"], jcfg))
    extra = dict(ref, **{"module._extra.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="not consumed by the conversion.*_extra"):
        state_dict_from_reference(extra, pcfg)
    _assert_same(state_dict_from_reference(extra, pcfg, strict=False), cli_model["port"])

    wider = pcfg.replace(mol=pcfg.mol.replace(dot_product_dimension=8))
    with pytest.raises(ValueError, match="does not fit the model") as err:
        state_dict_from_reference(ref, wider)
    assert "shape mismatch at mol.query_proj.out.weight" in str(err.value)
    with pytest.raises(ValueError, match="does not fit the model") as err:
        state_dict_from_reference(ref, pcfg.replace(mol=pcfg.mol.replace(
            uid_embedding_hash_sizes=(128, 64))))
    assert "missing from checkpoint: mol.uid_embeddings_1.embedding (65, 16)" in str(err.value)
    with pytest.raises(ValueError, match="unexpected in checkpoint: mol.gating_query"):
        state_dict_from_reference(ref, pcfg.replace(mol=pcfg.mol.replace(
            gating_query_fn=False, gating_combination_type="none")))
    with pytest.raises(KeyError, match="_pos_emb"):
        state_dict_from_reference({k: v for k, v in ref.items() if "_pos_emb" not in k}, pcfg)

    cat = pcfg.replace(embedding_module_type="categorical", num_item_categories=CLI_ITEMS)
    with pytest.raises(ValueError, match="pass num_items explicitly"):
        state_dict_from_reference(ref, cat)
    state_dict_from_reference(ref, cat, num_items=500)


# --------------------------------------------------------------------------- #
# AdamW moments
# --------------------------------------------------------------------------- #

def _lr(optimizer, count: int) -> float:
    lr = optimizer.learning_rate
    return float(np.float32(lr(count) if callable(lr) else lr))


def _torch_adamw(ref: dict, pcfg, optimizer, steps: int = 3, seed: int = 123):
    """torch.optim.AdamW (the original repo's optimizer: the config's
    betas, eps 1e-8, its weight decay) over the reference parameters in
    their order, `steps` steps of seeded gradients at the port schedule's
    learning rate. Returns (payload, params, opt, gradient generator)."""
    names = [k for k in ref if not k.endswith("_attn_mask")]
    params = [torch.nn.Parameter(ref[k].clone()) for k in names]
    t = pcfg.train
    opt = torch.optim.AdamW(params, lr=_lr(optimizer, 0), betas=(t.beta1, t.beta2), eps=1e-8,
                            weight_decay=t.weight_decay)
    gen = torch.Generator().manual_seed(seed)
    for count in range(steps):
        _torch_step(opt, params, gen, _lr(optimizer, count))
    it = iter(params)
    payload = {"epoch": 1, "batch_id": 5,
               "model_state_dict": {k: v if k.endswith("_attn_mask") else next(it).detach().clone()
                                    for k, v in ref.items()},
               "optimizer_state_dict": copy.deepcopy(opt.state_dict())}
    return payload, names, params, opt, gen


def _torch_step(opt, params, gen, lr) -> dict:
    grads = [torch.randn(p.shape, generator=gen) for p in params]
    for p, g in zip(params, grads):
        p.grad = g
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    return grads


@pytest.mark.parametrize("fused", [False, True], ids=["optax", "fused"])
def test_adamw_step_after_import_matches_torch(cli_model, fused):
    """Three torch steps, the import, then one more step through the port's
    `FusedAdamW` and torch's on the same gradients (mapped through the
    conversion). With `fused_optimizer` the leaves of a multiple of 128
    elements go through K7's route (its plain version on the CPU)."""
    pcfg = cli_model["pcfg"]
    pcfg = pcfg.replace(train=pcfg.train.replace(fused_optimizer=fused))
    ref = _tensors(jax_export.reference_state_dict_from_params(cli_model["params"],
                                                                cli_model["jcfg"]))
    model = SequentialRecommender(pcfg, CLI_ITEMS, device="cpu")
    optimizer = make_optimizer(pcfg, model)
    if fused:
        optimizer.min_fused_elements = 128    # the tiny leaves reach the kernel's route
        assert any(optimizer.fused(p.numel()) for p in model.parameters())
    payload, names, params, opt, gen = _torch_adamw(ref, pcfg, optimizer)
    sd = state_dict_from_reference(payload["model_state_dict"], pcfg)
    state = optimizer_state_from_reference(payload["optimizer_state_dict"],
                                           payload["model_state_dict"], pcfg, sd)
    assert state.count == 3
    model.load_state_dict(sd, strict=True)
    optimizer.state = state
    grads = _torch_step(opt, params, gen, _lr(optimizer, 3))
    optimizer.step(state_dict_from_reference(dict(zip(names, grads)), pcfg, validate=False))
    assert optimizer.state.count == 4
    want = state_dict_from_reference(dict(zip(names, (p.detach() for p in params))), pcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=ADAMW_RTOL,
                                   atol=ADAMW_ATOL, err_msg=name)


@pytest.mark.parametrize("fused", [False, True], ids=["optax", "fused"])
def test_imported_moments_equal_jax(cli_model, fused):
    """The port's moments and count equal JAX's import passed through
    `adamw_state_from_jax`, for optax's `adamw` chain and JAX's
    `FusedAdamWState`."""
    jcfg, pcfg = cli_model["jcfg"], cli_model["pcfg"]
    jcfg = jcfg.replace(train=jcfg.train.replace(fused_optimizer=fused))
    ref = _tensors(jax_export.reference_state_dict_from_params(cli_model["params"], jcfg))
    model = SequentialRecommender(pcfg, CLI_ITEMS, device="cpu")
    payload = _torch_adamw(ref, pcfg, make_optimizer(pcfg, model))[0]
    msd, osd = payload["model_state_dict"], payload["optimizer_state_dict"]
    params = jax_import.params_from_reference_state_dict(msd, jcfg)
    jax_state, step = jax_import.optimizer_state_from_reference(osd, msd, jcfg, params,
                                                                jax_make_optimizer(jcfg))
    want = adamw_state_from_jax(jax.tree_util.tree_map(np.asarray, jax_state))
    got = optimizer_state_from_reference(osd, msd, pcfg, state_dict_from_reference(msd, pcfg))
    assert got.count == want.count == step == 3
    _assert_same(got.mu, want.mu)
    _assert_same(got.nu, want.nu)


def test_int_steps_lazy_and_divergent_states(cli_model):
    """torch < 2.0 keeps `step` as an int; a parameter never stepped or
    steps that differ cannot share one count and raise as JAX's import."""
    pcfg = cli_model["pcfg"]
    ref = _tensors(jax_export.reference_state_dict_from_params(cli_model["params"],
                                                                cli_model["jcfg"]))
    model = SequentialRecommender(pcfg, CLI_ITEMS, device="cpu")
    payload = _torch_adamw(ref, pcfg, make_optimizer(pcfg, model), steps=2)[0]
    msd, osd = payload["model_state_dict"], payload["optimizer_state_dict"]
    sd = state_dict_from_reference(msd, pcfg)
    old = copy.deepcopy(osd)
    for entry in old["state"].values():
        entry["step"] = int(entry["step"])
    old["state"] = {str(k): v for k, v in old["state"].items()}
    assert optimizer_state_from_reference(old, msd, pcfg, sd).count == 2

    first = sorted(osd["state"])[0]
    lazy = {"state": {k: v for k, v in osd["state"].items() if k != first},
            "param_groups": osd["param_groups"]}
    with pytest.raises(ValueError, match="skip-optimizer"):
        optimizer_state_from_reference(lazy, msd, pcfg, sd)
    divergent = copy.deepcopy(osd)
    divergent["state"][first]["step"] = divergent["state"][first]["step"] + 5
    with pytest.raises(ValueError, match="distinct steps"):
        optimizer_state_from_reference(divergent, msd, pcfg, sd)


def test_categorical_moments_import_where_jax_raises(cli_model):
    """A categorical checkpoint's moments import: the port infers
    `num_items` only to validate the weights. JAX's import converts the
    moments without `num_items` and raises."""
    pcfg, jcfg = (c.replace(embedding_module_type="categorical", num_item_categories=CLI_ITEMS)
                  for c in (cli_model["pcfg"], cli_model["jcfg"]))
    ref = _tensors(jax_export.reference_state_dict_from_params(cli_model["params"],
                                                                cli_model["jcfg"]))
    model = SequentialRecommender(cli_model["pcfg"], CLI_ITEMS, device="cpu")
    payload = _torch_adamw(ref, pcfg, make_optimizer(cli_model["pcfg"], model))[0]
    msd, osd = payload["model_state_dict"], payload["optimizer_state_dict"]
    sd = state_dict_from_reference(msd, pcfg, num_items=500)
    state = optimizer_state_from_reference(osd, msd, pcfg, sd)
    assert state.count == 3 and state.mu.keys() == sd.keys()
    params = jax_import.params_from_reference_state_dict(msd, jcfg, num_items=500)
    with pytest.raises(ValueError, match="pass num_items explicitly"):
        jax_import.optimizer_state_from_reference(osd, msd, jcfg, params,
                                                  jax_make_optimizer(jcfg))


def test_old_torch_payload_loads_weights_only(cli_model, tmp_path):
    """A payload with int steps saved the way torch 2 saves it loads with
    `weights_only=True`; one without `param_groups` gives zero moments and
    count 0."""
    pcfg = cli_model["pcfg"]
    ref = _tensors(jax_export.reference_state_dict_from_params(cli_model["params"],
                                                                cli_model["jcfg"]))
    model = SequentialRecommender(pcfg, CLI_ITEMS, device="cpu")
    payload = _torch_adamw(ref, pcfg, make_optimizer(pcfg, model), steps=1)[0]
    for entry in payload["optimizer_state_dict"]["state"].values():
        entry["step"] = int(entry["step"])
    torch.save(payload, tmp_path / "old")
    sd, state, epoch, batch_id = import_torch_checkpoint_full(str(tmp_path / "old"), pcfg)
    assert (state.count, epoch, batch_id) == (1, 1, 5)
    payload["optimizer_state_dict"] = {}
    torch.save(payload, tmp_path / "bare")
    sd2, state, _, _ = import_torch_checkpoint_full(str(tmp_path / "bare"), pcfg)
    _assert_same(sd2, sd)
    assert state.count == 0 and all(not v.any() for v in (*state.mu.values(),
                                                          *state.nu.values()))


# --------------------------------------------------------------------------- #
# The CLIs
# --------------------------------------------------------------------------- #

@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """TensorBoard's import pulls in TensorFlow; the JSONL log is written."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_cli_import_eval_resume_export_reimport(cli_model, tmp_path):
    """A reference file with AdamW moments through the import CLI; the eval
    CLI prints what it prints for a port checkpoint of the same weights;
    `cli.train` resumes from it for one epoch; the export CLI and a second
    import give back the resumed weights and epoch."""
    from rails_tpu_torch.cli import eval as eval_cli
    from rails_tpu_torch.cli import train
    from rails_tpu_torch.train.checkpoint import save_checkpoint
    from rails_tpu_torch.train.loop import TrainState

    pcfg = cli_model["pcfg"]
    model = SequentialRecommender(pcfg, CLI_ITEMS, device="cpu")
    model.load_state_dict(cli_model["port"], strict=True)
    optimizer = make_optimizer(pcfg, model)
    ref = _tensors(jax_export.reference_state_dict_from_params(cli_model["params"],
                                                                cli_model["jcfg"]))
    payload = _torch_adamw(ref, pcfg, optimizer)[0]
    payload.update(epoch=2, batch_id=12)
    torch.save(payload, tmp_path / "ref_ep2")
    common = ["--config", "synthetic-small", *TINY]
    imported = _import_cli(common + ["--ckpt", str(tmp_path / "ref_ep2"),
                                     "--out", str(tmp_path / "imported")])
    saved = _load(imported)
    assert (saved["epoch"], saved["batch_id"], saved["step"], saved["opt_state"]["count"]) == (
        2, 12, 3, 3)
    _assert_same(saved["model"], state_dict_from_reference(payload["model_state_dict"], pcfg))

    model.load_state_dict(saved["model"], strict=True)
    own = save_checkpoint(str(tmp_path), TrainState(model, optimizer, 0), 0, 0)
    argv = common + ["--device", "cpu", "--top-k-method", "MoLBruteForceTopKFused",
                     "--eval-against-brute-force"]
    line = eval_cli.main(argv + ["--ckpt", imported])
    assert line == eval_cli.main(argv + ["--ckpt", own])
    assert all(np.isfinite(float(v)) for v in line[1].split(","))

    result = train.main(common + ["--device", "cpu", "--workdir", str(tmp_path / "work"),
                                  "--num-epochs", "4", "--restore-from-ckpt", imported])
    assert np.isfinite(result.final_metrics["hr@10"])
    (run,) = os.listdir(tmp_path / "work")
    resumed = str(tmp_path / "work" / run / "ckpts" / "ep3")
    after = _load(resumed)
    assert (after["epoch"], after["batch_id"], after["step"]) == (3, 18, 9)
    assert after["opt_state"]["count"] == 9

    exported = _export_cli(common + ["--ckpt", resumed, "--out", str(tmp_path / "ref_ep3")])
    again = _load(_import_cli(common + ["--ckpt", exported, "--out", str(tmp_path / "again")]))
    _assert_same(again["model"], after["model"])
    assert (again["epoch"], again["batch_id"]) == (3, 18)


def test_cli_flags(cli_model, tmp_path):
    """`--skip-optimizer` leaves fresh moments, `--no-strict` passes an
    unconsumed key, a categorical config needs `--num-items`, and a reference
    gin file stands in for `--config`."""
    from rails_tpu.compat.gin_import import experiment_config_from_gin as jax_gin
    from rails_tpu_torch.compat.gin_import import experiment_config_from_gin

    pcfg = cli_model["pcfg"]
    ref = _tensors(jax_export.reference_state_dict_from_params(cli_model["params"],
                                                                cli_model["jcfg"]))
    model = SequentialRecommender(pcfg, CLI_ITEMS, device="cpu")
    payload = _torch_adamw(ref, pcfg, make_optimizer(pcfg, model))[0]
    torch.save(payload, tmp_path / "ref")
    extra = dict(payload, optimizer_state_dict={})
    extra["model_state_dict"] = dict(payload["model_state_dict"],
                                     **{"module._extra.bias": torch.zeros(3)})
    torch.save(extra, tmp_path / "extra")
    common = ["--config", "synthetic-small", *TINY]
    with pytest.raises(ValueError, match="_extra"):
        _import_cli(common + ["--ckpt", str(tmp_path / "extra"), "--out", str(tmp_path / "s")])
    loose = _load(_import_cli(common + ["--ckpt", str(tmp_path / "extra"), "--no-strict",
                                        "--out", str(tmp_path / "loose")]))
    common += ["--ckpt", str(tmp_path / "ref")]
    fresh = _load(_import_cli(common + ["--out", str(tmp_path / "a"), "--skip-optimizer"]))
    assert fresh["step"] == 0 and fresh["opt_state"]["count"] == 0
    assert all(not v.any() for v in fresh["opt_state"]["nu"].values())
    stepped = _load(_import_cli(common + ["--out", str(tmp_path / "b")]))
    assert stepped["step"] == stepped["opt_state"]["count"] == 3
    assert all(v.any() for v in stepped["opt_state"]["nu"].values())
    _assert_same(fresh["model"], stepped["model"])
    _assert_same(loose["model"], stepped["model"])

    cat = common + ["--set", "embedding_module_type=categorical",
                    "--set", f"num_item_categories={CLI_ITEMS}"]
    with pytest.raises(ValueError, match="pass num_items explicitly"):
        _import_cli(cat + ["--out", str(tmp_path / "c")])
    catted = _load(_import_cli(cat + ["--out", str(tmp_path / "c"), "--num-items", "500"]))
    _assert_same(catted["model"], stepped["model"])
    assert catted["opt_state"]["count"] == 3

    gin = tmp_path / "small.gin"
    gin.write_text(GIN)
    jcfg = jax_gin(str(gin)).config
    assert experiment_config_from_gin(str(gin)).config.to_dict() == jcfg.to_dict()
    gin_params = _jax_model(jcfg, CLI_ITEMS, seed=4)[1]
    jax_export.export_torch_checkpoint(gin_params, jcfg, str(tmp_path / "gin_ref"))
    got = _load(_import_cli(["--gin-config-file", str(gin), "--ckpt", str(tmp_path / "gin_ref"),
                             "--out", str(tmp_path / "g")]))
    _assert_same(got["model"], state_dict_from_jax_params(
        gin_params, experiment_config_from_gin(str(gin)).config))


GIN = """
train_fn.dataset_name = "synthetic"
train_fn.max_sequence_length = 16
train_fn.main_module = "HSTU"
train_fn.interaction_module_type = "MoL"
train_fn.item_embedding_dim = 16
hstu_encoder.num_blocks = 1
hstu_encoder.num_heads = 2
hstu_encoder.dqk = 8
hstu_encoder.dv = 8
create_mol_interaction_module.dot_product_dimension = 8
create_mol_interaction_module.query_dot_product_groups = 2
create_mol_interaction_module.item_dot_product_groups = 2
create_mol_interaction_module.query_hidden_dim = 16
create_mol_interaction_module.gating_qi_hidden_dim = 8
create_mol_interaction_module.gating_query_hidden_dim = 8
create_mol_interaction_module.gating_item_hidden_dim = 8
"""
