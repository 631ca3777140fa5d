"""The port's train, eval, sweep and train_bench CLIs and the serving-state
store, on the CPU, at the tiny sizes of JAX's `tests/test_cli.py` (96
synthetic users, 120 items, batches of 16).

- The eval CLI against JAX's: one random `synthetic-small` model, saved by
  JAX's `save_checkpoint` (orbax) and, with the same weights and moments
  (`state_dict_from_jax_params`, `adamw_state_from_jax`), by the port's;
  both CLIs print the same CSV header, and their values differ by at most
  1/96 (one user's rank across a tie) plus the 4-decimal print, for
  `MoLBruteForceTopK`, `MoLBruteForceTopKFused` and `MoLAvgTopK100` with
  `--eval-against-brute-force`.
- `--item-parallel 2` on 2 gloo ranks prints `--item-parallel 1`'s metrics,
  and `cli.train --distributed` on them trains one replica;
  `--sort-by-length` prints the unsorted metrics; a batch that does not
  divide the users counts every user once (JAX `tests/test_cli.py:48-90,
  210`); the CLI's serving-state round trip prints the same line.
- `load_serving_state(save_serving_state(s))` returns s's top-k ids and
  scores bit for bit for the exact, Fused bf16, FusedInt8, IVF and MIPS
  states; `host=True` CPU tensors over the files feed `pad_and_shard_state`
  on the 2 ranks, whose merged top-k is the replicated path's.
- The train CLI (`--config` and `--gin-config-file`), the sweep (its CSV,
  the budget filter, `--menu`, `--extra-algorithms`) and train_bench (its
  JSON; `mfu_pct` against the named card's peak, null on the CPU).
"""

import json
import os
import sys

import numpy as np
import jax
import pytest
import torch

import torch_port_ranks as R
from rails_tpu_torch.core.distributed import run_ranks

TINY = [
    "--set", "data.synthetic_num_users=96",
    "--set", "data.synthetic_num_items=120",
    "--set", "train.local_batch_size=16",
    "--set", "train.eval_batch_size=16",
    "--set", "train.num_negatives=8",
    "--set", "train.num_epochs=1",
    "--set", "train.eval_interval=100",
    "--set", "train.partial_eval_num_iters=1",
]
N_EVAL = 96
CPU = ["--device", "cpu"]
RANK_TIMEOUT = 300.0


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The JSONL log is the record under test; TensorBoard's import pulls in
    TensorFlow (about 15 s on a CPU host)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _tiny_cfg(get_experiment_config, apply_override):
    cfg = get_experiment_config("synthetic-small")
    for key, _, val in (s.partition("=") for s in TINY[1::2]):
        cfg = apply_override(cfg, key, val)
    return cfg


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One random model's checkpoint in JAX's format and in the port's."""
    from rails_tpu.cli.train import apply_override as jax_override
    from rails_tpu.core.config import get_experiment_config as jax_config
    from rails_tpu.data.datasets import get_reco_dataset
    from rails_tpu.train.checkpoint import save_checkpoint as jax_save
    from rails_tpu.train.loop import create_train_state as jax_state
    from rails_tpu_torch.cli.train import apply_override
    from rails_tpu_torch.compat.from_jax import adamw_state_from_jax, state_dict_from_jax_params
    from rails_tpu_torch.core.config import get_experiment_config
    from rails_tpu_torch.train.checkpoint import save_checkpoint
    from rails_tpu_torch.train.loop import create_train_state

    d = tmp_path_factory.mktemp("ckpts")
    os.makedirs(d / "jax")
    os.makedirs(d / "port")
    cfg = _tiny_cfg(jax_config, jax_override)
    ds = get_reco_dataset(cfg.data)
    sample = next(ds.eval_dataset.batches(batch_size=16, max_output_length=3, shuffle=False))
    _, state, _, _ = jax_state(cfg, ds.max_item_id, ds.all_item_ids, sample)
    jax_path = jax_save(str(d / "jax"), state, 0, 6)
    port_cfg = _tiny_cfg(get_experiment_config, apply_override)
    model, pstate, _, _ = create_train_state(port_cfg, ds.max_item_id, ds.all_item_ids,
                                             device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, state.params), port_cfg), strict=True)
    pstate.optimizer.state = adamw_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                         state.opt_state))
    port_path = save_checkpoint(str(d / "port"), pstate, 0, 6)
    return dict(jax=jax_path, port=port_path, cfg=port_cfg, num_items=ds.max_item_id)


def _eval(argv):
    from rails_tpu_torch.cli import eval as eval_cli

    return eval_cli.main(["--config", "synthetic-small"] + argv + TINY + CPU)


def _values(line):
    return np.array([float(v) for v in line.split(",")])


@pytest.mark.parametrize("method", ["MoLBruteForceTopK", "MoLBruteForceTopKFused",
                                    "MoLAvgTopK100"])
def test_eval_cli_matches_jax(method, ckpts, capsys):
    from rails_tpu.cli import eval as jax_eval_cli

    argv = ["--top-k-method", method, "--k", "50", "--eval-against-brute-force"]
    jax_eval_cli.main(["--config", "synthetic-small", "--ckpt", ckpts["jax"]] + argv + TINY)
    want_header, want_values = capsys.readouterr().out.strip().splitlines()[-2:]
    header, values = _eval(["--ckpt", ckpts["port"]] + argv)
    assert header == want_header
    np.testing.assert_allclose(_values(values), _values(want_values), rtol=0,
                               atol=1.0 / N_EVAL + 1e-4, err_msg=header)


def test_eval_cli_counts_every_user_and_sorts_by_length():
    """36 users a batch (96 = 2 x 36 + 24, the tail wrapped) prints what 32
    (96 = 3 x 32) prints; length-sorted, truncated batches print the
    unsorted metrics."""
    base = ["--top-k-method", "MoLBruteForceTopK", "--k", "50"]
    plain = _values(_eval(base)[1])
    for extra in (["--set", "train.eval_batch_size=32"], ["--set", "train.eval_batch_size=36"],
                  ["--sort-by-length"]):
        np.testing.assert_allclose(_values(_eval(base + extra)[1]), plain, rtol=1e-5, atol=1e-6,
                                   err_msg=str(extra))


def test_eval_cli_serving_state_roundtrip(tmp_path):
    common = ["--top-k-method", "MoLBruteForceTopKFusedInt8", "--k", "20"]
    first = _eval(common + ["--save-serving-state", str(tmp_path / "ss")])
    second = _eval(common + ["--load-serving-state", str(tmp_path / "ss")])
    assert first == second


SERVING_METHODS = ["MoLBruteForceTopK", "MoLBruteForceTopKFused", "MoLBruteForceTopKFusedInt8",
                   "MoLIVFTopK4", "MIPSBruteForceTopK"]


@pytest.fixture(scope="module")
def served(ckpts):
    """The tiny model and one eval batch."""
    from rails_tpu_torch.data.datasets import get_reco_dataset
    from rails_tpu_torch.train.loop import create_train_state

    cfg = ckpts["cfg"]
    ds = get_reco_dataset(cfg.data)
    model = create_train_state(cfg, ds.max_item_id, ds.all_item_ids, device="cpu")[0]
    batch = next(ds.eval_dataset.batches(batch_size=16, max_output_length=3, shuffle=False,
                                         device="cpu"))
    return dict(model=model, ds=ds, batch=batch)


@pytest.mark.parametrize("method", SERVING_METHODS)
def test_serving_state_roundtrip_is_bit_equal(method, served, tmp_path):
    from rails_tpu_torch.index.factory import get_top_k_raw
    from rails_tpu_torch.index.serving_state import load_serving_state, save_serving_state
    from rails_tpu_torch.train.evaluation import get_eval_state

    model, feats = served["model"], served["batch"].features
    es = get_eval_state(model, served["ds"].all_item_ids, method, device="cpu")
    loaded = load_serving_state(save_serving_state(str(tmp_path / "ss"), es, chunk_items=48),
                                model)
    assert (loaded.top_k_method, loaded.num_objects) == (method, es.num_objects)
    raw = get_top_k_raw(method)
    with torch.inference_mode():
        q = model.encode(feats)
        want = raw(model, es.topk_state, q, 30, feats.user_ids, item_embeddings=es.item_embeddings)
        got = raw(model, loaded.topk_state, q, 30, feats.user_ids,
                  item_embeddings=loaded.item_embeddings)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
    host = load_serving_state(str(tmp_path / "ss"), model, host=True)
    assert host.topk_state.item_ids.device.type == "cpu"


def test_item_parallel_eval_and_host_state_on_two_ranks(served, tmp_path):
    """2 gloo ranks: the eval CLI with `--item-parallel 2` prints the
    one-process line; the train CLI with `--distributed` trains one replica
    on both and writes one log and checkpoint; a fused state loaded with `host=True` shards by
    `pad_and_shard_state` into slabs of 256 (the 120 items padded to two
    256-item tiles),
    and the merged top-k equals the replicated path's."""
    from rails_tpu_torch.index.factory import get_top_k_raw
    from rails_tpu_torch.index.serving_state import save_serving_state
    from rails_tpu_torch.train.evaluation import get_eval_state

    method, k = "MoLBruteForceTopKFused", 30
    model, feats = served["model"], served["batch"].features
    es = get_eval_state(model, served["ds"].all_item_ids, method, device="cpu")
    save_serving_state(str(tmp_path / "ss"), es)
    argv = ["--config", "synthetic-small", "--top-k-method", "MoLBruteForceTopK", "--k", "50"]
    train_argv = ["--config", "synthetic-small", "--distributed", "--num-epochs", "1",
                  "--workdir", str(tmp_path / "runs")] + TINY + CPU
    payload = dict(argv=argv + ["--item-parallel", "2"] + TINY + CPU, train_argv=train_argv,
                   cfg=served["model"].cfg,
                   num_items=served["ds"].max_item_id, serving_state=str(tmp_path / "ss"),
                   feats=tuple(t.numpy() for t in feats), k=k)
    torch.save(payload, tmp_path / "payload.pt")
    run_ranks(R.eval_cli_rank, 2, (2, str(tmp_path / "store"), str(tmp_path / "payload.pt"),
                                   str(tmp_path)), timeout=RANK_TIMEOUT)
    outs = R.load_results(str(tmp_path), 2)
    replicated = _eval(argv[2:])
    assert outs[1]["lines"] is None
    assert outs[0]["lines"][0] == replicated[0]
    np.testing.assert_allclose(_values(outs[0]["lines"][1]), _values(replicated[1]), rtol=1e-5,
                               atol=1e-6)
    with torch.inference_mode():
        want = get_top_k_raw(method)(model, es.topk_state, model.encode(feats), k,
                                     feats.user_ids)
    # The train CLI data-parallel over the 2 ranks: one replica, one log.
    assert outs[0]["train"]["final"] == outs[1]["train"]["final"]
    for name, p in outs[0]["train"]["params"].items():
        assert torch.equal(p, outs[1]["train"]["params"][name]), name
    (run,) = os.listdir(tmp_path / "runs")
    assert sorted(os.listdir(tmp_path / "runs" / run)) == ["ckpts", "metrics.jsonl"]
    assert "ep0" in os.listdir(tmp_path / "runs" / run / "ckpts")
    for o in outs:
        assert o["slab_items"] == 256
        np.testing.assert_array_equal(o["ids"], want.ids.numpy())
        np.testing.assert_allclose(o["scores"], want.scores.numpy(), rtol=1e-6, atol=1e-6)


def test_train_cli_with_config_or_gin_file(tmp_path):
    from rails_tpu_torch.cli import train

    result = train.main(["--config", "synthetic-small", "--workdir", str(tmp_path / "a")]
                        + TINY + CPU)
    assert np.isfinite(result.final_metrics["hr@10"])
    (run,) = os.listdir(tmp_path / "a")
    assert sorted(os.listdir(tmp_path / "a" / run / "ckpts")) == ["config.json", "ep0",
                                                                   "ep0.meta.json"]
    gin = tmp_path / "tiny.gin"
    gin.write_text("\n".join([
        'train_fn.dataset_name = "synthetic"', "train_fn.max_sequence_length = 32",
        "train_fn.item_embedding_dim = 32", "train_fn.local_batch_size = 16",
        "train_fn.eval_batch_size = 16", "train_fn.num_negatives = 8",
        "hstu_encoder.num_blocks = 1", "hstu_encoder.num_heads = 2", "hstu_encoder.dqk = 16",
        "hstu_encoder.dv = 16", "create_mol_interaction_module.dot_product_dimension = 16",
        "create_mol_interaction_module.query_dot_product_groups = 4",
        "create_mol_interaction_module.item_dot_product_groups = 2",
        "create_mol_interaction_module.uid_embedding_hash_sizes = [128]",
        "train_fn.enable_tf32 = True"]))
    result = train.main(["--gin-config-file", str(gin), "--workdir", str(tmp_path / "b"),
                         "--num-epochs", "1", "--set", "data.synthetic_num_users=48",
                         "--set", "data.synthetic_num_items=100"] + CPU)
    assert result.model.cfg.name == "tiny" and np.isfinite(result.final_metrics["mrr"])
    with pytest.raises(SystemExit):
        train.parse_config(["--config", "synthetic-small", "--gin-config-file", str(gin)])


def test_sweep_cli(tmp_path, capsys):
    from rails_tpu_torch.cli import sweep

    out_csv = tmp_path / "sweep.csv"
    rows = sweep.main(["--config", "synthetic-small", "--limit-users", "16", "--output-csv",
                       str(out_csv), "--extra-algorithms", "MoLCertTopK64"] + TINY + CPU)
    lines = out_csv.read_text().strip().splitlines()
    assert "algorithm" in lines[0].split(",") and len(lines) == len(rows) + 1
    got = [r["algorithm"] for r in rows]
    # The synthetic menu without the budgets above 120 items, then the extra.
    assert got == ["MoLBruteForceTopK", "MoLBruteForceTopKFused", "MoLBruteForceTopKFusedInt8",
                   "MoLNaiveTopK10", "MoLNaiveTopK50", "MoLIVFTopK4", "MoLTileTopK4",
                   "MoLCertTopK64"]
    assert rows[1]["recall@50"] > 0.9 and "recall@1" not in rows[0]
    assert all(r["EvalTimeAvgMs"] > 0 for r in rows)
    rows = sweep.main(["--config", "synthetic-small", "--limit-users", "16", "--menu", "ml-1m",
                       "--no-eval-time", "--set", "data.synthetic_num_items=600"]
                      + TINY[:2] + TINY[4:] + CPU)
    assert [r["algorithm"] for r in rows] == [
        "MoLBruteForceTopK", "MoLBruteForceTopKFused", "MoLBruteForceTopKFusedApprox",
        "MoLBruteForceTopKFusedInt8", "MoLNaiveTopK5", "MoLNaiveTopK10", "MoLNaiveTopK50",
        "MoLNaiveTopK100", "MoLAvgTopK200", "MoLAvgTopK500", "MoLCombTopK5_200",
        "MoLCombTopK50_500", "MoLIVFTopK8", "MoLTileTopK8"]
    assert "EvalTimeAvgMs" not in rows[0]


def test_train_bench_cli(monkeypatch):
    from rails_tpu_torch.cli import train_bench

    argv = ["--config", "synthetic-small", "--batch-size", "16", "--num-items", "200",
            "--runs", "2"] + CPU
    rec = train_bench.main(argv)
    assert rec["device"] == "cpu" and rec["mfu_pct"] is None and rec["peak_tflops"] is None
    assert rec["value"] > 0 and np.isfinite(rec["final_loss"])
    json.dumps(rec)
    monkeypatch.setattr(train_bench, "card", lambda device: ("NVIDIA H100 80GB HBM3", 700.0))
    rec = train_bench.main(argv + ["--bf16"])
    assert rec["compute_dtype"] == "bfloat16" and rec["peak_tflops"] == 989.0
    assert rec["mfu_pct"] == pytest.approx(100 * rec["achieved_tflops"] / 989.0)
    assert rec["power_limit_w"] == 700.0
