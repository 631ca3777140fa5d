"""rails_tpu_torch package hygiene: no JAX, a build that fails loudly, and
unported paths that say so."""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from rails_tpu.core.config import get_experiment_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Every module of the package imports with jax and flax blocked."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        for name in ("jax", "flax"):
            sys.modules[name] = None      # any `import jax` now raises
        import rails_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(rails_tpu_torch.__path__, "rails_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "jaxlib")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print(len(mods))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


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
    assert {"hstu_block.cu", "mol_scoring.cu", "common.cuh"} <= names
    assert len(fresh_build.source_hash()) == 16


@pytest.mark.parametrize(
    "change",
    [
        dict(model_type="SASRec"),
        dict(input_preprocessor_type="rated"),
        dict(embedding_module_type="categorical"),
    ],
    ids=lambda c: next(iter(c)),
)
def test_unported_model_configs_raise(change):
    from rails_tpu_torch.models.encoder import SequentialRecommender

    cfg = get_experiment_config("synthetic-small").replace(**change)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        SequentialRecommender(cfg, num_items=10)


def test_unported_top_k_methods_raise():
    from rails_tpu_torch.index.factory import get_top_k_raw

    for method in ("MoLBruteForceTopKFusedInt8", "MoLNaiveTopK10", "MIPSBruteForceTopK"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            get_top_k_raw(method)
