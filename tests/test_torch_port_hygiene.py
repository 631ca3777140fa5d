"""rails_tpu_torch package hygiene: no JAX and nothing of the JAX package, a
config copy that cannot drift, entry points on the card by default, a build
that fails loudly, and unported paths that say so."""

import ast
import ctypes
import glob
import os
import re
import shutil
import subprocess
import sys
import textwrap
import types

import pytest
import torch

from rails_tpu.core import config as jax_config
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.core.config import get_experiment_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The chip scripts at the root: the smoke test and every profile script.
SCRIPTS = ("chip_smoke.py",) + tuple(sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(REPO, "profile_*.py"))))


def test_port_imports_no_jax():
    """Every module of the package imports with jax, flax and the JAX
    package blocked."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        for name in ("jax", "flax", "rails_tpu"):
            sys.modules[name] = None      # any `import jax` / `import rails_tpu.x` now raises
        import rails_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(rails_tpu_torch.__path__, "rails_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "jaxlib", "rails_tpu")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        assert "rails_tpu_torch.index.oracle" in mods, mods
        for m in ("cli.encode_probe", "cli.mol_probe", "ops.encode_probe", "ops.mol_probe",
                  "models.sasrec", "similarity.dot_product", "losses.bce", "index.ivf",
                  "data.native", "data.preprocessor", "data.item_features", "data.tables",
                  "cli.preprocess", "core.distributed", "core.mesh", "index.sharded",
                  "similarity.lm_embeddings", "cli.shard_bench", "cli.train", "cli.eval",
                  "cli.sweep", "cli.train_bench", "train.driver", "train.checkpoint",
                  "train.metrics", "train.profiling", "index.serving_state",
                  "compat.gin_import", "compat.torch_import", "compat.torch_export",
                  "cli.import_checkpoint", "cli.export_checkpoint"):
            assert "rails_tpu_torch." + m in mods, mods
        print(len(mods))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


def test_frontier_cli_imports_nothing_of_the_jax_package():
    """The frontier CLI runs on the CPU at a tiny size, IVF with
    `--cluster-order` included, with jax, flax and the JAX package blocked;
    so does the preprocessing CLI on an ML-1M-shaped ratings.dat."""
    code = textwrap.dedent(
        """
        import os, sys, tempfile
        for name in ("jax", "flax", "rails_tpu"):
            sys.modules[name] = None
        from rails_tpu_torch.cli import frontier, preprocess
        out = frontier.main(["--config", "synthetic-small", "--set", "hstu.fused_train=true",
                             "--num-items", "600", "--train-steps", "1", "--runs", "1",
                             "--methods", "MoLIVFTopK8", "--cluster-order", "--device", "cpu"])
        assert [r["method"] for r in out["rows"]] == ["ivf_build", "MoLIVFTopK8"], out
        root = tempfile.mkdtemp()
        os.makedirs(os.path.join(root, "tmp", "ml-1m"))
        with open(os.path.join(root, "tmp", "ml-1m", "ratings.dat"), "w") as f:
            f.writelines(f"{i % 7 + 1}::{i}::{i % 5 + 1}::{1000 + i}\\n" for i in range(247, 3953))
        preprocess.main(["--datasets", "ml-1m", "--root", root])
        assert os.path.getsize(os.path.join(root, "tmp", "ml-1m", "sasrec_format.csv"))
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "jaxlib", "rails_tpu")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("cli", ["encode_probe", "mol_probe"])
def test_probe_clis_import_nothing_of_the_jax_package(cli):
    """The cost-probe CLIs run on the CPU, at tiny sizes, with jax, flax and
    the JAX package blocked."""
    args = {"encode_probe": ["--batch-size", "2", "--lengths", "8", "--num-blocks", "1",
                             "--runs", "1", "--modes", "full,ident"],
            "mol_probe": ["--num-items", "64", "--runs", "1", "--k", "8", "--modes", "full"]}[cli]
    code = textwrap.dedent(
        f"""
        import sys
        for name in ("jax", "flax", "rails_tpu"):
            sys.modules[name] = None
        from rails_tpu_torch.cli import {cli}
        {cli}.main({args!r} + ["--device", "cpu"])
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "jaxlib", "rails_tpu")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_shard_bench_cli_imports_nothing_of_the_jax_package():
    """The item-sharded serving CLI runs one rank on gloo over the CPU at a
    tiny size, exact and IVF with the streamed check, with jax, flax and the
    JAX package blocked."""
    code = textwrap.dedent(
        """
        import sys
        for name in ("jax", "flax", "rails_tpu"):
            sys.modules[name] = None
        from rails_tpu_torch.cli import shard_bench
        from rails_tpu_torch.core import distributed
        for method in ("MoLBruteForceTopKFused", "MoLIVFTopK8"):
            out = shard_bench.main(["--device", "cpu", "--config", "synthetic-small",
                                    "--num-items", "600", "--runs", "1", "--k", "20",
                                    "--method", method, "--check-against-chunked"])
            assert out["item_parallel"] == 1 and out["ms_per_batch"] > 0, out
            assert out["metric"] == f"sharded_{method}_top20_qps", out
            distributed.shutdown()
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "jaxlib", "rails_tpu")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0, out.stderr


CLI_TINY = ["--set", "data.synthetic_num_users=48", "--set", "data.synthetic_num_items=120",
            "--set", "train.local_batch_size=16", "--set", "train.eval_batch_size=16",
            "--set", "train.num_negatives=8"]


def test_training_and_eval_clis_import_nothing_of_the_jax_package(tmp_path):
    """The train, eval, sweep, train_bench, export_checkpoint and
    import_checkpoint CLIs run on the CPU at a tiny size, a checkpoint (also
    exported to the original repo's format and imported back) and a serving
    state between them, with jax, flax, orbax and the JAX package blocked
    (and TensorBoard, whose import pulls in TensorFlow: the JSONL log is
    written all the same)."""
    code = textwrap.dedent(
        f"""
        import os, sys
        for name in ("jax", "flax", "orbax", "rails_tpu", "torch.utils.tensorboard"):
            sys.modules[name] = None
        from rails_tpu_torch.cli import (eval, export_checkpoint, import_checkpoint, sweep,
                                         train, train_bench)
        tiny = {CLI_TINY!r} + ["--device", "cpu", "--config", "synthetic-small"]
        work = {str(tmp_path)!r}
        train.main(tiny + ["--workdir", os.path.join(work, "runs"), "--num-epochs", "1"])
        (run,) = os.listdir(os.path.join(work, "runs"))
        trained = os.path.join(work, "runs", run, "ckpts", "ep0")
        assert os.path.getsize(os.path.join(work, "runs", run, "metrics.jsonl"))
        ref = export_checkpoint.main(tiny + ["--ckpt", trained, "--out",
                                             os.path.join(work, "ref_ep0")])
        ckpt = import_checkpoint.main(tiny + ["--ckpt", ref, "--out", os.path.join(work, "imp")])
        ss = os.path.join(work, "ss")
        first = eval.main(tiny + ["--ckpt", ckpt, "--top-k-method", "MoLBruteForceTopKFused",
                                  "--eval-against-brute-force", "--save-serving-state", ss])
        assert first == eval.main(tiny + ["--ckpt", ckpt, "--top-k-method",
                                          "MoLBruteForceTopKFused", "--eval-against-brute-force",
                                          "--load-serving-state", ss])
        rows = sweep.main(tiny + ["--ckpt", ckpt, "--limit-users", "16", "--no-eval-time"])
        assert len(rows) >= 4
        rec = train_bench.main(["--config", "synthetic-small", "--batch-size", "8",
                                "--num-items", "100", "--runs", "1", "--device", "cpu"])
        assert rec["mfu_pct"] is None
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "flax", "jaxlib", "orbax", "rails_tpu")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("cli", ["train", "eval", "sweep", "train_bench", "import_checkpoint",
                                 "export_checkpoint"])
def test_training_and_eval_clis_default_to_the_card(cli, monkeypatch, tmp_path):
    """Without `--device` each CLI goes to the card: on a build without CUDA
    it raises instead of running on the CPU."""
    import importlib

    module = importlib.import_module(f"rails_tpu_torch.cli.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["--config", "synthetic-small", "--num-items", "100", "--runs", "1"]
            if cli == "train_bench" else ["--config", "synthetic-small"] + CLI_TINY)
    if cli == "train":
        argv += ["--workdir", str(tmp_path)]
    if cli.endswith("_checkpoint"):
        argv += ["--ckpt", str(tmp_path / "in"), "--out", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        module.main(argv)


# JAX files without a port file of the same path, each with its reason.
NOT_PORTED = {
    "ops/pallas/": "the Pallas kernels, ported under ops/ and csrc/",
    "cli/hstu_probe.py": "drives the probe_skip knob; the P1 and P2 probes replace it",
}


def test_every_jax_module_has_a_port_file():
    """Every `rails_tpu/**/*.py` has a file of the same path under
    `rails_tpu_torch/`, apart from `NOT_PORTED`: the port does all that the
    JAX package does."""
    def files(pkg):
        root = os.path.join(REPO, pkg)
        return {os.path.relpath(p, root)
                for p in glob.glob(os.path.join(root, "**", "*.py"), recursive=True)}

    port = files("rails_tpu_torch")
    missing = sorted(f for f in files("rails_tpu") - port
                     if not any(f.startswith(skip) for skip in NOT_PORTED))
    assert not missing, missing
    for skip in NOT_PORTED:
        assert any(f.startswith(skip) for f in files("rails_tpu")), skip


RANK_HELPERS = {"chip_smoke.py": ("sharded_rank", "shard_model", "small_state", "dp_rank",
                                  "dp_steps", "train_batch", "launch_counts", "reset_launches",
                                  "kernel_counters", "k4_wrappers", "sync"),
                "tests/torch_port_ranks.py": None}


@pytest.mark.parametrize("path", sorted(RANK_HELPERS))
def test_rank_functions_import_nothing_of_the_jax_package(path):
    """What a spawned rank runs imports torch, numpy, the standard library
    and the port only: chip_smoke.py's rank functions and what they call,
    and the CPU tests' rank module as a whole."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    wanted = RANK_HELPERS[path]
    nodes = [tree] if wanted is None else [
        n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in wanted]
    assert wanted is None or {n.name for n in nodes} == set(wanted)
    roots = set()
    for fn in nodes:
        for node in ast.walk(fn):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                roots.add((node.module or "").split(".")[0])
    assert roots <= {"torch", "numpy", "os", "sys", "time", "typing", "__future__",
                     "rails_tpu_torch"}, roots


def test_distributed_entry_points_default_to_the_card(monkeypatch):
    """A rank's device is cuda:{LOCAL_RANK} unless named, and joining a run
    without naming a device goes to the card: on a CPU-only build it raises
    rather than running on the CPU."""
    from rails_tpu_torch.core import distributed

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert distributed.rank_device() == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.rank_device() == torch.device("cuda", 3)
    assert distributed.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        distributed.initialize()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_import_nothing_of_the_jax_package(script):
    tree = ast.parse(open(os.path.join(REPO, script)).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "flax", "jaxlib", "rails_tpu"}, roots
    assert "rails_tpu_torch" in roots


def test_config_copy_agrees_with_the_jax_package():
    names = jax_config.list_experiment_configs()
    assert port_config.list_experiment_configs() == names
    for name in names:
        assert (port_config.get_experiment_config(name).to_dict()
                == jax_config.get_experiment_config(name).to_dict()), name


def test_default_device_is_the_card(monkeypatch):
    """Entry points called without `device=` go to the card; without one they
    raise instead of running on the CPU."""
    from rails_tpu_torch.core import device
    from rails_tpu_torch.data.features import batch_from_rows
    from rails_tpu_torch.models.encoder import SequentialRecommender
    from rails_tpu_torch.train.loop import create_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        device.default_device()
    cfg = get_experiment_config("synthetic-small")
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        SequentialRecommender(cfg, num_items=10)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        create_train_state(cfg, 10, list(range(1, 11)))
    rows = [torch.zeros(2, dtype=torch.int32).numpy()] + [torch.zeros(2, 3).numpy()] * 3
    rows += [torch.zeros(2).numpy()] * 4
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        batch_from_rows(*rows, max_output_length=1)
    from rails_tpu_torch.ops import hash_dropout

    for fn in (hash_dropout.hash_keep_mask, hash_dropout.hash_keep_mask_reference):
        with pytest.raises(RuntimeError, match="CUDA device is required"):
            fn(2, 3, 4, 0, 0.2)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        hash_dropout.hash_keep_global_reference(0, hash_dropout.QI_SALT, 2, 3, 4, 0.2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device.default_device() == torch.device("cuda")
    assert device.resolve_device("cpu") == torch.device("cpu")


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    from rails_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    _build.load_library.cache_clear()
    yield _build
    _build.load_library.cache_clear()


def test_build_raises_without_nvcc(fresh_build, monkeypatch):
    monkeypatch.setattr(fresh_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fresh_build.load_library()


def test_build_raises_when_nvcc_fails(fresh_build, monkeypatch, tmp_path):
    monkeypatch.setattr(fresh_build, "find_nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fresh_build.load_library()
    assert not list(tmp_path.glob(f"*/{fresh_build.LIB_NAME}"))


def test_source_hash_covers_every_source(fresh_build):
    names = {p.name for p in fresh_build._sources()}
    assert {"hstu_block.cu", "mol_scoring.cu", "common.cuh", "hstu_block.cuh",
            "hstu_block_train.cu", "hash_dropout.cu", "hash_dropout.cuh",
            "fused_adamw.cu", "mol_loss_train.cu", "scatter_add.cu", "encode_probe.cu",
            "mol_probe.cu", "mol_scoring.cuh", "hstu_softmax_train.cu",
            "hstu_train.cuh", "mol_scoring_tc.cuh", "mma_sync.cuh"} <= names
    assert len(fresh_build.source_hash()) == 16


# The ctypes class of each C parameter or return type the entry points use.
_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "unsigned": ctypes.c_uint,
            "uint32_t": ctypes.c_uint32, "float": ctypes.c_float, "size_t": ctypes.c_size_t,
            "const char*": ctypes.c_char_p}


def _c_class(decl: str):
    """The ctypes class of one C parameter (`const float* x`) or return type."""
    if "*" in decl and decl.replace(" ", "") != "constchar*":
        return ctypes.c_void_p
    words = [w for w in decl.replace("*", "* ").split() if w != "const"]
    base = " ".join(words[:-1]) if len(words) > 1 and "*" not in decl else " ".join(words)
    return _C_TYPES["const char*" if "*" in decl else base]


def _extern_c_signatures() -> dict:
    """name -> (return class, [parameter classes]) of every `extern "C"`
    function in rails_tpu_torch/csrc/*.cu."""
    out = {}
    csrc = os.path.join(REPO, "rails_tpu_torch", "csrc")
    for fname in sorted(os.listdir(csrc)):
        if not fname.endswith(".cu"):
            continue
        text = open(os.path.join(csrc, fname)).read()
        for ret, name, params in re.findall(r'extern "C"\s+(.+?)\s*\b(rails_\w+)\s*\(([^)]*)\)',
                                            text, re.S):
            out[name] = (_c_class(ret), [_c_class(p) for p in params.split(",") if p.strip()])
    return out


def test_ctypes_bindings_match_the_c_signatures(fresh_build, monkeypatch):
    """Every `extern "C"` entry point is bound by `load_library` with its C
    signature: as many argtypes as parameters, position by position the
    class (int, long long, uint32_t, float, pointer, size_t), and its return
    type. An unlisted argument goes through ctypes as a 32-bit int, which cuts
    a pointer or a stream."""
    bound = {}

    class Recorder:
        def __init__(self, path):
            pass

        def __getattr__(self, name):
            return bound.setdefault(name, types.SimpleNamespace(argtypes=None, restype=None))

    monkeypatch.setattr(fresh_build, "build", lambda: "librails.so")
    monkeypatch.setattr(ctypes, "CDLL", Recorder)
    fresh_build.load_library()
    declared = _extern_c_signatures()
    assert len(declared) >= 29 and "rails_scatter_add_rows" in declared
    assert set(bound) == set(declared)
    for name, (ret, params) in declared.items():
        fn = bound[name]
        assert fn.restype is ret, (name, fn.restype, ret)
        assert len(fn.argtypes) == len(params), (name, len(fn.argtypes), len(params))
        for pos, (got, want) in enumerate(zip(fn.argtypes, params)):
            assert got is want, (name, pos, got, want)


@pytest.mark.parametrize(
    "change",
    [
        dict(model_type="SASRec"),
        dict(input_preprocessor_type="rated"),
        dict(embedding_module_type="categorical", num_item_categories=7),
    ],
    ids=lambda c: next(iter(c)),
)
def test_unported_model_configs_raise(change):
    """The model configurations that refused before this slice (SASRec, the
    rated preprocessor, the categorical embedding) now build, load a
    rails_tpu model's weights strictly and encode as it does (f32)."""
    import jax
    import numpy as np

    from rails_tpu.core.config import get_experiment_config as jax_experiment_config
    from rails_tpu.data import datasets as jax_datasets
    from rails_tpu.train import loop as jax_loop
    from rails_tpu_torch.compat.from_jax import state_dict_from_jax_params
    from rails_tpu_torch.data.features import SequentialFeatures
    from rails_tpu_torch.models.encoder import SequentialRecommender

    data = dict(synthetic_num_users=32, synthetic_num_items=90)
    cfg = jax_experiment_config("synthetic-small").replace(**change)
    cfg = cfg.replace(data=cfg.data.replace(**data))
    port_cfg = get_experiment_config("synthetic-small").replace(**change)
    port_cfg = port_cfg.replace(data=port_cfg.data.replace(**data))
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.eval_dataset.batches(
        batch_size=8, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    mapping = (np.arange(ds.max_item_id, dtype=np.int32) % 7
               if "embedding_module_type" in change else None)
    model, params = jax_loop.init_model(cfg, ds.max_item_id, jax.random.PRNGKey(0), batch,
                                        item_id_to_category_id=mapping)
    port = SequentialRecommender(port_cfg, ds.max_item_id, device="cpu",
                                 item_id_to_category_id=mapping)
    port.load_state_dict(
        state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params), port_cfg),
        strict=True)
    want = np.asarray(jax.jit(lambda p: model.apply(p, batch.features, method=model.encode))(
        params))
    with torch.no_grad():
        got = port.encode(SequentialFeatures(
            *(torch.from_numpy(np.array(f)) for f in batch.features))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "change",
    [
        dict(train=dict(loss_activation_checkpoint=True)),
        dict(train=dict(sampling_strategy="in-batch")),
        dict(train=dict(loss_module="BCELoss")),
    ],
    ids=["checkpoint", "in_batch", "bce"],
)
def test_unported_training_options_raise(change, monkeypatch):
    """The training options that refused before this slice (the loss's
    activation checkpoint, the in-batch sampler, BCE) now run one step whose
    loss matches `make_train_step`'s (every dropout off, the same draws;
    tests/test_torch_port_models_train.py holds the gradients too)."""
    import jax
    import numpy as np

    from tests.test_torch_port_models_train import _fix_draws
    from tests.test_torch_port_train_step import NO_DROPOUT, _configure, _port_batch

    from rails_tpu.core.config import get_experiment_config as jax_experiment_config
    from rails_tpu.data import datasets as jax_datasets
    from rails_tpu.train import loop as jax_loop
    from rails_tpu_torch.compat.from_jax import state_dict_from_jax_params
    from rails_tpu_torch.train.loop import create_train_state

    changes = {k: dict(NO_DROPOUT.get(k, {}), **change.get(k, {}))
               for k in set(NO_DROPOUT) | set(change)}
    changes["hstu"] = dict(changes["hstu"], fused_train=False)
    cfg = _configure(jax_experiment_config("synthetic-small"), changes)
    port_cfg = _configure(get_experiment_config("synthetic-small"), changes)
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.train_dataset.batches(
        batch_size=8, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    b, n = batch.features.ids.shape
    _fix_draws(monkeypatch, cfg, b * (n - 1), np.asarray(ds.all_item_ids))
    _, state, train_step, _ = jax_loop.create_train_state(
        cfg, ds.max_item_id, ds.all_item_ids, batch)
    port, port_state, port_step, _ = create_train_state(
        port_cfg, ds.max_item_id, ds.all_item_ids, device="cpu")
    port.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, state.params), port_cfg), strict=True)
    _, want = train_step(state, batch, jax.random.PRNGKey(0))
    _, got = port_step(port_state, _port_batch(batch), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-4)


def test_no_refusal_names_a_ported_queue_item():
    """No NotImplementedError of the package names a Queue 1 item that is
    ported (`losses`, `SASRec`, `preprocessors, embeddings and
    similarities`, `IVF`, `the training CLI`)."""
    ported = ("Queue 1: losses", "Queue 1: SASRec",
              "Queue 1: preprocessors, embeddings and similarities", "Queue 1: IVF",
              "Queue 1: the training CLI")
    hits = []
    for path in glob.glob(os.path.join(REPO, "rails_tpu_torch", "**", "*.py"), recursive=True):
        text = open(path).read()
        hits += [(path, label) for label in ported if label in text]
    assert not hits, hits


@pytest.mark.parametrize(
    "change,loss_rtol",
    [
        # The XLA block path (fused_train=False), f32.
        (dict(hstu=dict(fused_train=False)), 1e-4),
        # The bf16 -fast step: shared negatives through the bf16 K5.
        (dict(hstu=dict(fused_train=True), train=dict(shared_negatives=True, fused_mol_loss=True),
              mol=dict(bf16_training=True)), 1e-2),
    ],
    ids=["xla_train", "shared_negatives"],
)
def test_formerly_refused_training_options_run_and_match_jax(change, loss_rtol, monkeypatch):
    """Training options that refused before the Books slice now run one
    synthetic-small step whose loss matches `make_train_step`'s (every
    dropout off, the same fixed negatives; bf16 within the bf16 step's rtol 1e-2)."""
    import jax
    import numpy as np

    from rails_tpu.core.config import get_experiment_config as jax_experiment_config
    from rails_tpu.data import datasets as jax_datasets
    from rails_tpu.train import loop as jax_loop
    from tests.test_torch_port_train_step import (
        NO_DROPOUT,
        _configure,
        _fix_negatives,
        _port_batch,
        _port_state,
    )

    changes = {k: dict(NO_DROPOUT.get(k, {}), **change.get(k, {}))
               for k in set(NO_DROPOUT) | set(change)}
    cfg = _configure(jax_experiment_config("synthetic-small"), changes)
    port_cfg = _configure(get_experiment_config("synthetic-small"), changes)
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batch = next(ds.train_dataset.batches(
        batch_size=8, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    b, n = batch.features.ids.shape
    r = cfg.train.num_negatives
    shape = (r,) if cfg.train.shared_negatives else (b * (n - 1), r)
    negatives = np.random.default_rng(5).choice(ds.all_item_ids, size=shape).astype(np.int32)
    _fix_negatives(monkeypatch, negatives)
    model, state, train_step, _ = jax_loop.create_train_state(
        cfg, ds.max_item_id, ds.all_item_ids, batch)
    s = dict(port_cfg=port_cfg, ds=ds, params=jax.tree_util.tree_map(np.asarray, state.params),
             opt_state=jax.tree_util.tree_map(np.asarray, state.opt_state))
    _, want = train_step(state, batch, jax.random.PRNGKey(0))
    _, port_state, port_step = _port_state(s)
    _, got = port_step(port_state, _port_batch(batch), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=loss_rtol)


def test_unported_top_k_methods_raise():
    """Every top-k spelling of the JAX factory is served, IVF's included:
    no spelling raises NotImplementedError."""
    from rails_tpu_torch.index.factory import get_top_k_raw

    for method in ("MoLIVFTopK8", "MoLIVFTopK64"):
        assert callable(get_top_k_raw(method))


def _cpp_class(decl: str):
    """The ctypes class of one parameter or return type of
    native/sequence_loader.cpp: int64_t, const char*, void, or a pointer."""
    decl = decl.replace("const ", "").strip()
    if decl.startswith("char*"):
        return ctypes.c_char_p
    if "*" in decl:
        return "pointer"
    return {"int64_t": ctypes.c_int64, "void": None}[decl.split()[0]]


def test_native_loader_bindings_match_the_cpp_signatures(monkeypatch):
    """`data/native.py` declares every `extern "C"` function of
    native/sequence_loader.cpp with its signature (count and class by
    position, pointers as c_void_p or a ctypes pointer type), and its
    `_ParsedSequences` has the C struct's fields in order."""
    from rails_tpu_torch.data import native

    src = open(os.path.join(REPO, "native", "sequence_loader.cpp")).read()
    body = re.sub(r"//[^\n]*", "", src[src.index('extern "C" {'):])
    declared = {name: (_cpp_class(ret), [_cpp_class(p.strip().rsplit(" ", 1)[0])
                                         for p in params.split(",")])
                for ret, name, params in re.findall(r"\n(\w[\w ]*\*?)\s+(\w+)\(([^)]*)\)\s*\{",
                                                    body)}
    assert set(declared) == {"parse_sasrec_csv", "free_parsed_sequences", "assemble_batch"}

    bound = {}

    class Recorder:
        def __getattr__(self, name):
            return bound.setdefault(name, types.SimpleNamespace(argtypes=None, restype=None))

    native.declare(Recorder())
    assert set(bound) == set(declared)
    for name, (ret, params) in declared.items():
        fn = bound[name]
        got = [fn.restype] + list(fn.argtypes)
        for pos, (g, want) in enumerate(zip(got, [ret] + params)):
            if want == "pointer":
                assert g is ctypes.c_void_p or issubclass(g, ctypes._Pointer), (name, pos, g)
            else:
                assert g is want, (name, pos, g, want)
        assert len(fn.argtypes) == len(params), name
    struct = re.search(r"struct ParsedSequences \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*([\w*]+\*?)\s+(\w+);", struct, re.M)
    assert [n for _, n in fields] == [n for n, _ in native._ParsedSequences._fields_]
    for (ctype, _), (_, cls) in zip(fields, native._ParsedSequences._fields_):
        if ctype == "char*":
            assert cls is ctypes.c_char_p
        elif ctype.endswith("*"):
            base = {"int32_t*": ctypes.c_int32, "int64_t*": ctypes.c_int64}[ctype]
            assert cls._type_ is base, ctype
        else:
            assert cls is {"int64_t": ctypes.c_int64}[ctype], ctype
