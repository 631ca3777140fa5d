"""The port's training driver, eval harness, checkpoints, metrics log,
profiling, gin import and FLOP count vs rails_tpu, on the CPU.

- The eval harness: a `synthetic-small` model with JAX's weights (through
  `state_dict_from_jax_params`) over 600 items and 60 eval users in batches
  of 16, so the fourth batch wraps around and `num_examples` = 60 trims 4
  rows. `eval_metrics_from_batches` gives JAX's per-user arrays (ranks
  equal; the float32 NDCG/MRR within 1e-6 relative), the rating-filtered
  ones included; `summarize_metrics` and `recall_vs_exact(num_examples=)`
  agree to 1e-6.
- `run_training`: 3 epochs, and 2 epochs then a resume from the epoch-1
  checkpoint to epoch 3, end with bit-equal weights, moments, step,
  batch_id and generator state; the log and the checkpoint layout; a
  checkpoint of another config raises; 4 epochs on the clustered
  synthetic data raise hr@50 well above the untrained model's.
- The gin importer on binding texts written here (the reference's `.gin`
  files are not in the repository): the same config and `ignored` list as
  JAX's, and an error where JAX raises; `train_flops_per_user` equal to
  JAX's for every registry config.

TensorBoard is blocked here: its import pulls in TensorFlow (about 15 s on
a CPU host), and the JSONL log is the record under test.
"""

import glob
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.core.config import get_experiment_config
from rails_tpu.data import datasets as jax_datasets
from rails_tpu.train import evaluation as jax_eval
from rails_tpu.train.loop import create_train_state as jax_create_train_state
from rails_tpu_torch.compat.from_jax import state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.data.features import Batch, SequentialFeatures
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.train import evaluation as port_eval

NUM_ITEMS, NUM_USERS, B, K = 600, 60, 16, 50


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _small(cfg):
    return cfg.replace(
        data=cfg.data.replace(synthetic_num_users=NUM_USERS, synthetic_num_items=NUM_ITEMS),
        train=cfg.train.replace(local_batch_size=B, eval_batch_size=B, num_negatives=8),
    )


def _to_torch(batch) -> Batch:
    return Batch(SequentialFeatures(*(torch.from_numpy(np.array(f)) for f in batch.features)),
                 torch.from_numpy(np.array(batch.target_ids)),
                 torch.from_numpy(np.array(batch.target_ratings)))


@pytest.fixture(scope="module")
def harness():
    cfg = _small(get_experiment_config("synthetic-small"))
    port_cfg = _small(port_config.get_experiment_config("synthetic-small"))
    ds = jax_datasets.get_reco_dataset(cfg.data)
    batches = list(ds.eval_dataset.batches(
        batch_size=B, max_output_length=cfg.train.gr_output_length + 1, shuffle=False,
        drop_last=False))
    assert len(ds.eval_dataset) == NUM_USERS and len(batches) * B > NUM_USERS
    all_ids = np.arange(1, NUM_ITEMS + 1, dtype=np.int32)
    model, state, _, _ = jax_create_train_state(cfg, NUM_ITEMS, all_ids, batches[0])
    port = SequentialRecommender(port_cfg, NUM_ITEMS, device="cpu")
    port.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, state.params), port_cfg), strict=True)
    states = {}
    for method in ("MoLBruteForceTopK", "MoLAvgTopK40"):
        states[method] = (
            jax_eval.get_eval_state(model, state.params, all_ids, method, table_dtype=jnp.float32),
            port_eval.get_eval_state(port, all_ids, method, table_dtype=torch.float32,
                                     device="cpu"))
    return dict(model=model, params=state.params, port=port, batches=batches,
                t_batches=[_to_torch(b) for b in batches], states=states)


def _ranks(metrics):
    return np.rint(1.0 / metrics["mrr"]).astype(np.int64)


def test_eval_metrics_from_batches_matches_jax(harness):
    h = harness
    jes, pes = h["states"]["MoLBruteForceTopK"]
    want, _ = jax_eval.eval_metrics_from_batches(h["model"], h["params"], jes, h["batches"],
                                                 k=K, num_examples=NUM_USERS)
    got, lat = port_eval.eval_metrics_from_batches(h["port"], pes, h["t_batches"], k=K,
                                                   num_examples=NUM_USERS)
    assert lat is None
    assert set(got) == set(want) and "hr@10_>=4" in got
    assert len(got["hr@10"]) == NUM_USERS
    np.testing.assert_array_equal(_ranks(got), _ranks(want))
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-6, atol=0, err_msg=key)
    summary, jax_summary = port_eval.summarize_metrics(got), jax_eval.summarize_metrics(want)
    assert set(summary) == set(jax_summary)
    for key, w in jax_summary.items():
        assert summary[key] == pytest.approx(w, abs=1e-6), key
    # Without the trim the repeated tail rows count twice.
    untrimmed, _ = port_eval.eval_metrics_from_batches(h["port"], pes, h["t_batches"], k=K)
    assert len(untrimmed["hr@10"]) == len(h["batches"]) * B


def test_eval_metrics_latency_protocol(harness):
    """With timing every batch is timed (host clock here): k capped at 120
    and k' at 200, metrics as the untimed run's at k = 120."""
    h = harness
    _, pes = h["states"]["MoLBruteForceTopK"]
    timed, lat = port_eval.eval_metrics_from_batches(
        h["port"], pes, h["t_batches"], k=500, include_eval_time=True, timing_fraction=1.0,
        warmup_runs=1, timed_runs=2, num_examples=NUM_USERS)
    plain, _ = port_eval.eval_metrics_from_batches(h["port"], pes, h["t_batches"], k=120,
                                                   truncate_k_prime_to=200,
                                                   num_examples=NUM_USERS)
    assert lat.num_measurements == len(h["batches"]) and lat.mean_ms > 0
    for key, v in plain.items():
        np.testing.assert_array_equal(timed[key], v, err_msg=key)


def test_recall_vs_exact_trims_like_jax(harness):
    h = harness
    j_exact, p_exact = h["states"]["MoLBruteForceTopK"]
    j_approx, p_approx = h["states"]["MoLAvgTopK40"]
    want = jax_eval.recall_vs_exact(h["model"], h["params"], j_exact, j_approx, h["batches"],
                                    k=K, num_examples=NUM_USERS)
    got = port_eval.recall_vs_exact(h["port"], p_exact, p_approx, h["t_batches"], k=K,
                                    num_examples=NUM_USERS)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key] == pytest.approx(w, abs=1e-6), key
    assert 0.0 < got["recall@1"] < 1.0


# ---------------------------------------------------------------------------
# The driver.


def _driver_cfg(num_users=64, **train):
    c = port_config.get_experiment_config("synthetic-small")
    return c.replace(
        data=c.data.replace(synthetic_num_users=num_users, synthetic_num_items=150),
        train=c.train.replace(**dict(dict(
            local_batch_size=16, eval_batch_size=16, num_negatives=16, num_epochs=2,
            eval_interval=2, save_ckpt_every_n=1, partial_eval_num_iters=2,
            full_eval_every_n=2), **train)),
    )


def _payload(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _run_dir(workdir):
    (run_dir,) = glob.glob(os.path.join(workdir, "*"))
    return run_dir


@pytest.fixture
def one_thread():
    """Two runs of the same training on several CPU threads differ in the
    last bits of some reductions (the MoL qi MLP's gradients here); on one
    thread they are bit-equal, so a difference can only come from the
    resume."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_resume_is_exact_and_artifacts(tmp_path, one_thread):
    """3 epochs in one run equal 2 epochs and a resume from the epoch-1
    checkpoint, bit for bit; the log holds train and eval records and the
    checkpoints JAX's layout."""
    from rails_tpu_torch.train.driver import run_training

    cfg = _driver_cfg()
    run_training(cfg, workdir=str(tmp_path / "whole"), num_epochs=3, device="cpu")
    run_training(cfg, workdir=str(tmp_path / "first"), num_epochs=2, device="cpu")
    first = _run_dir(tmp_path / "first")
    resumed = run_training(cfg, workdir=str(tmp_path / "resumed"), num_epochs=3, device="cpu",
                           restore_from=os.path.join(first, "ckpts", "ep1"))
    assert np.isfinite(resumed.final_metrics["hr@10"])

    whole = _run_dir(tmp_path / "whole")
    assert sorted(os.listdir(os.path.join(whole, "ckpts"))) == [
        "config.json", "ep1", "ep1.meta.json", "ep2", "ep2.meta.json"]
    meta = json.load(open(os.path.join(whole, "ckpts", "ep2.meta.json")))
    assert meta == {"epoch": 2, "batch_id": 12, "debug_str": cfg.model_debug_str()}
    assert open(os.path.join(whole, "ckpts", "config.json")).read() == cfg.to_json()
    records = [json.loads(line) for line in open(os.path.join(whole, "metrics.jsonl"))]
    train_steps = [r["step"] for r in records if "train/loss" in r]
    assert train_steps == list(range(0, 12, 2))
    assert [r["step"] for r in records if "eval_epoch/hr@10" in r] == [0, 1, 2]

    want = _payload(os.path.join(whole, "ckpts", "ep2"))
    got = _payload(os.path.join(_run_dir(tmp_path / "resumed"), "ckpts", "ep2"))
    assert (got["step"], got["epoch"], got["batch_id"]) == (want["step"], 2, 12) == (12, 2, 12)
    assert torch.equal(got["generator"], want["generator"])
    assert got["opt_state"]["count"] == want["opt_state"]["count"] == 12
    for name, w in want["model"].items():
        assert torch.equal(got["model"][name], w), name
    for part in ("mu", "nu"):
        for name, w in want["opt_state"][part].items():
            assert torch.equal(got["opt_state"][part][name], w), (part, name)
    # The resume needs the saved stream: epoch 1's generator is not the seed's.
    ep1 = _payload(os.path.join(first, "ckpts", "ep1"))
    assert not torch.equal(ep1["generator"], torch.Generator().manual_seed(42).get_state())


def test_restore_raises_for_another_config_and_spans_the_optimizer_flag(tmp_path):
    from rails_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from rails_tpu_torch.train.loop import create_train_state

    cfg = _driver_cfg()
    ids = np.arange(1, 151, dtype=np.int32)
    _, state, step, _ = create_train_state(cfg, 150, ids, device="cpu")
    path = save_checkpoint(str(tmp_path), state, 0, 7)
    # One optimizer layout under both settings of `fused_optimizer`.
    other = cfg.replace(train=cfg.train.replace(fused_optimizer=False))
    _, fresh, _, _ = create_train_state(other, 150, ids, seed=1, device="cpu")
    fresh, epoch, batch_id = restore_checkpoint(path, fresh)
    assert (epoch, batch_id) == (0, 7)
    for name, p in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[name], p), name
    wider = cfg.replace(train=cfg.train.replace(item_embedding_dim=48))
    _, mismatched, _, _ = create_train_state(wider, 150, ids, device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        restore_checkpoint(path, mismatched)


LEARN_USERS, LEARN_ITEMS, LEARN_EPOCHS = 192, 150, 4
LEARN_SEEDS = (42, 43, 44)
# The spread of one run's hr@50 over training seeds: the larger of the two
# drivers' sample standard deviations over seeds 42-56 (JAX 0.0353, the
# port 0.0300; the sweep below).
SEED_SD = 0.0353


def _learn_cfg(cfg, seed):
    """JAX's `tests/test_driver.py:14-24` setting: 192 users over 150 items,
    a full eval every epoch, 4 epochs."""
    return cfg.replace(
        data=cfg.data.replace(synthetic_num_users=LEARN_USERS, synthetic_num_items=LEARN_ITEMS),
        train=cfg.train.replace(
            local_batch_size=16, eval_batch_size=16, num_negatives=16,
            num_epochs=LEARN_EPOCHS, eval_interval=5, save_ckpt_every_n=1,
            partial_eval_num_iters=2, full_eval_every_n=1, random_seed=seed))


def jax_hr50(seed):
    """hr@50 of JAX's driver after 4 epochs at training seed `seed`."""
    from rails_tpu.train.driver import run_training as jax_run_training

    cfg = _learn_cfg(get_experiment_config("synthetic-small"), seed)
    return jax_run_training(cfg, workdir=None, use_mesh=False).final_metrics["hr@50"]


def port_hr50(seed):
    """hr@50 of the port's driver after 4 epochs at training seed `seed`."""
    from rails_tpu_torch.train.driver import run_training

    cfg = _learn_cfg(port_config.get_experiment_config("synthetic-small"), seed)
    return run_training(cfg, device="cpu").final_metrics["hr@50"]


def test_training_learns_synthetic_structure(one_thread):
    """JAX's `tests/test_driver.py:57-64` run through both drivers on the same
    synthetic data, at training seeds 42-44. JAX's own test holds hr@50 above
    0.45 at seed 42 alone, which its driver clears at 4 of seeds 42-56 and
    the port's at 4 (`JAX_PLATFORMS=cpu PYTHONPATH=. python
    tests/test_torch_port_driver.py` prints both drivers' readings); the two
    generators draw different dropout masks and negatives, so one seed of
    each is two independent runs. The port's mean over the three seeds is
    held to JAX's less two standard errors of a difference of two such
    means (0.058), and above chance (50 of 150 items) by three standard
    errors of its own mean (0.061)."""
    want = float(np.mean([jax_hr50(seed) for seed in LEARN_SEEDS]))
    got = float(np.mean([port_hr50(seed) for seed in LEARN_SEEDS]))
    se = SEED_SD / np.sqrt(len(LEARN_SEEDS))
    assert got >= want - 2 * np.sqrt(2) * se, (got, want)
    assert got > 50 / LEARN_ITEMS + 3 * se, got


def test_metrics_writer_and_profiling(tmp_path):
    from rails_tpu_torch.train.metrics import MetricsWriter
    from rails_tpu_torch.train.profiling import benchmark, timed_ms, trace

    writer = MetricsWriter(str(tmp_path))
    writer.write(3, {"loss": torch.tensor(1.5), "note": "text"}, prefix="train")
    writer.close()
    (rec,) = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert rec["step"] == 3 and rec["train/loss"] == 1.5 and "train/note" not in rec
    MetricsWriter(None).write(0, {"loss": 1.0})
    with trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert json.load(open(tmp_path / "trace" / "trace.json"))["traceEvents"]
    out = benchmark(lambda x: x * 2, [torch.ones(4), torch.zeros(4)], warmup=1, repeats=2,
                    device="cpu")
    assert out["num_inputs"] == 2 and out["repeats"] == 2 and out["best_ms"] > 0
    calls = []
    assert timed_ms(lambda: calls.append(torch.ones(4).sum()), 3, torch.device("cpu")) > 0
    assert len(calls) == 4                          # one warm-up call, then the 3 timed


# ---------------------------------------------------------------------------
# Copies of framework-free JAX modules.

GIN_HSTU = """
# a comment
train_fn.dataset_name = "ml-20m"
train_fn.max_sequence_length = 200
train_fn.main_module = "HSTU"
train_fn.interaction_module_type = "MoL"
train_fn.item_embedding_dim = 256
train_fn.local_batch_size = 128
train_fn.num_epochs = 101
train_fn.loss_weights = {"uid_embedding_l2_norm": 0.1}
train_fn.enable_tf32 = True
create_data_loader.num_workers = 4
hstu_encoder.num_blocks = 16
hstu_encoder.num_heads = 8
create_mol_interaction_module.dot_product_dimension = 128
create_mol_interaction_module.uid_embedding_hash_sizes = [16384]
get_similarity_function.bf16_training = False
"""
GIN_SASREC = """
train_fn.dataset_name = "ml-1m"
train_fn.main_module = "SASRec"
train_fn.interaction_module_type = "DotProduct"
train_fn.item_embedding_dim = 50  # trailing comment
sasrec_encoder.num_blocks = 2
create_mol_interaction_module.uid_embedding_l2_weight_decay = 0.1
"""
GIN_BAD = {
    "unknown target": "nope.x = 1",
    "unknown train_fn": "train_fn.nope = 1",
    "unknown hstu": "hstu_encoder.nope = 1",
    "not a literal": "train_fn.num_epochs = some_macro",
    "no binding": "this is not gin",
    "similarity": "get_similarity_function.nope = 1",
}


@pytest.mark.parametrize("text", [GIN_HSTU, GIN_SASREC], ids=["hstu", "sasrec"])
def test_gin_import_matches_jax(text, tmp_path):
    from rails_tpu.compat import gin_import as jax_gin
    from rails_tpu_torch.compat import gin_import as port_gin

    assert port_gin.parse_gin_bindings(text) == jax_gin.parse_gin_bindings(text)
    path = tmp_path / "exp.gin"
    path.write_text(text)
    for source in (text, str(path)):
        want = jax_gin.experiment_config_from_gin(source)
        got = port_gin.experiment_config_from_gin(source)
        assert got.config.to_dict() == want.config.to_dict()
        assert got.ignored == want.ignored and got.bindings == want.bindings
    assert port_gin.experiment_config_from_gin(GIN_HSTU).config.hstu.fused_train


@pytest.mark.parametrize("case", sorted(GIN_BAD))
def test_gin_import_raises_where_jax_raises(case):
    from rails_tpu.compat import gin_import as jax_gin
    from rails_tpu_torch.compat import gin_import as port_gin

    with pytest.raises(ValueError):
        jax_gin.experiment_config_from_gin(GIN_BAD[case] + "\n")
    with pytest.raises(ValueError):
        port_gin.experiment_config_from_gin(GIN_BAD[case] + "\n")


def test_train_flops_per_user_matches_jax():
    from rails_tpu.cli.train_bench import train_flops_per_user as jax_flops
    from rails_tpu_torch.cli.train_bench import train_flops_per_user

    for name in port_config.list_experiment_configs():
        for shared in (False, True):
            got = train_flops_per_user(port_config.get_experiment_config(name), 211, 128, shared)
            assert got == jax_flops(get_experiment_config(name), 211, 128, shared), name


if __name__ == "__main__":
    # hr@50 after 4 epochs of both drivers over training seeds 42-56, one
    # JSON line a seed, under the suite's JAX settings and with the port on
    # one CPU thread, as the test runs them.
    import conftest  # noqa: F401

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None
    for seed in range(42, 57):
        print(json.dumps({"seed": seed, "jax": jax_hr50(seed), "port": port_hr50(seed)}),
              flush=True)
