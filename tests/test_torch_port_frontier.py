"""The port's frontier CLI (`rails_tpu_torch.cli.frontier`) vs rails_tpu.

`apply_override` against `rails_tpu.cli.train.apply_override`; the study's
pieces on a `synthetic-small` model with the JAX weights (through
`state_dict_from_jax_params`) over a chunked clustered corpus of a few
thousand items, `BUILD_CHUNK` patched small on both sides and one numpy noise
function feeding both corpora; the CLI's summary on the CPU; and the IVF
spellings and flags, which the CLI accepts before any work.

The pieces run the model in f32 (`--set train.main_module_bf16=false`; the
corpus tables stay bf16, as the study builds them), so both sides build the
same table bytes up to a rare bf16 rounding tie and the oracles can be held
to equal ids. With a bf16 model the two item towers round differently in the
last bit (4% of the table entries at these widths) and near-tied items swap
places at the k-th boundary (98% of the oracle ids agree); the CLI test runs
the bf16 default.
"""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rails_tpu.cli import frontier as jax_frontier
from rails_tpu.cli.train import apply_override as jax_apply_override
from rails_tpu.core.config import get_experiment_config
from rails_tpu.data.datasets import SequenceDataset, generate_synthetic_sequences
from rails_tpu.index import factory as jax_factory
from rails_tpu.index import oracle as jax_oracle
from rails_tpu.index import top_k as jtk
from rails_tpu.train.loop import create_train_state
from rails_tpu_torch.cli import frontier
from rails_tpu_torch.cli.train import apply_override
from rails_tpu_torch.compat.from_jax import fused_tables_from_jax, state_dict_from_jax_params
from rails_tpu_torch.core import config as port_config
from rails_tpu_torch.index import top_k as ptk
from rails_tpu_torch.models.encoder import SequentialRecommender

NUM_ITEMS, CHUNK, K = 3000, 1024, 20
SMALL = ["--config", "synthetic-small", "--set", "hstu.fused_train=true",
         "--num-items", str(NUM_ITEMS), "--device", "cpu"]
METHODS = ("MoLBruteForceTopKFused", "MoLBruteForceTopKFusedApprox", "MoLTileTopK4",
           "MoLCertTopK512", "MoLAvgTopK256", "MoLCombTopK5_256", "MoLNaiveTopK10")
RECALL_TOL = 0.01


@pytest.mark.parametrize("raw", ["true", "False", "1e-3", "(1, 2)", "a_bare_string"])
def test_apply_override_matches_jax(raw):
    for key in ("train.main_module_bf16", "train.learning_rate", "data.dataset_name"):
        want = jax_apply_override(get_experiment_config("synthetic-small"), key, raw)
        got = apply_override(port_config.get_experiment_config("synthetic-small"), key, raw)
        assert got.to_dict() == want.to_dict(), (key, raw)


def _noise(start: int, shape) -> np.ndarray:
    return np.random.default_rng(start).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def study():
    """Both sides of the study on the same model, corpus, queries and chunks."""
    args = frontier.parse_args(SMALL + ["--set", "train.main_module_bf16=false"])
    port_cfg = frontier.configure(args)
    cfg = get_experiment_config("synthetic-small")
    cfg = cfg.replace(
        data=cfg.data.replace(dataset_name="synthetic", synthetic_num_users=256,
                              synthetic_num_items=NUM_ITEMS),
        train=cfg.train.replace(local_batch_size=32, num_negatives=8, main_module_bf16=False),
        hstu=cfg.hstu.replace(fused_train=True),
    )
    assert cfg.to_dict() == port_cfg.to_dict()
    seqs = generate_synthetic_sequences(
        num_users=256, num_items=NUM_ITEMS, max_len=cfg.data.max_sequence_length + 2, seed=0,
        length_distribution=cfg.data.synthetic_length_distribution)
    batch = next(SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1).batches(
        batch_size=32, max_output_length=cfg.train.gr_output_length + 1, shuffle=False))
    model, state, _, _ = create_train_state(
        cfg, NUM_ITEMS, np.arange(1, NUM_ITEMS + 1, dtype=np.int32), batch)
    params = state.params
    port = SequentialRecommender(port_cfg, NUM_ITEMS, compute_dtype=torch.float32, device="cpu")
    port.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), port_cfg), strict=True)
    sigma = args.cluster_sigma

    def jax_embed(start, cids):
        base = model.apply(params, (cids - 1) % NUM_ITEMS + 1, method=model.get_item_embeddings)
        scale = jnp.sqrt(jnp.mean(base.astype(jnp.float32) ** 2))
        noise = jnp.asarray(_noise(start, base.shape))
        return (base.astype(jnp.float32) + sigma * scale * noise).astype(base.dtype)

    ids = jnp.arange(1, NUM_ITEMS + 1, dtype=jnp.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtk, "BUILD_CHUNK", CHUNK)
        mp.setattr(ptk, "BUILD_CHUNK", CHUNK)
        jstate = jtk.build_fused_state_chunked_on_device(
            model, params, ids, embed_chunk_fn=jax_embed, chunk_size=CHUNK,
            table_dtype=jnp.bfloat16)
        jstate = jstate._replace(avg_component=jstate.avg_component.astype(jnp.bfloat16))
        q = model.apply(params, batch.features, method=model.encode)
        uids = batch.features.user_ids
        o_s, o_i = jax_oracle.streamed_exact_top_k(
            model, params, jstate, q, uids, K, embed_chunk_fn=jax_embed, item_ids_full=ids,
            chunk=CHUNK)
        embed = frontier.clustered_embed_fn(
            port, NUM_ITEMS, sigma,
            noise=lambda start, shape, device: torch.from_numpy(_noise(start, shape)))
        with torch.inference_mode():
            pstate = frontier.build_corpus(port, NUM_ITEMS, embed, False, torch.device("cpu"))
            pq = torch.from_numpy(np.array(q, np.float32))
            puids = torch.from_numpy(np.asarray(uids))
            oracle = frontier.exact_oracle(port, pstate, pq, puids, K, embed)
    return dict(model=model, params=params, jstate=jstate, q=q, uids=uids, port=port,
                pstate=pstate, pq=pq, puids=puids, oracle=oracle,
                j_oracle=(np.asarray(o_i), np.asarray(o_s)))


def test_corpus_tables_match_jax(study):
    want = fused_tables_from_jax(jax.tree_util.tree_map(np.asarray, study["jstate"].fused_tables))
    got = study["pstate"].fused_tables
    assert got.num_items == want.num_items == NUM_ITEMS
    for a, b in ((got.item_comp_t, want.item_comp_t), (got.item_partial_t, want.item_partial_t)):
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
        assert (a == b).float().mean().item() >= 0.999
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-2, atol=1e-2)
    avg = torch.from_numpy(np.asarray(study["jstate"].avg_component, np.float32))
    assert study["pstate"].avg_component.dtype == torch.bfloat16
    torch.testing.assert_close(study["pstate"].avg_component.float(), avg, rtol=1e-2, atol=1e-2)


def test_oracle_ids_equal_jax(study):
    want_ids, want_scores = study["j_oracle"]
    got = study["oracle"]
    assert got.ids.shape == want_ids.shape == (32, K)
    np.testing.assert_array_equal(np.sort(got.ids, axis=1), np.sort(want_ids, axis=1))
    np.testing.assert_allclose(got.scores, -np.sort(-want_scores, axis=1), rtol=1e-4,
                               atol=1e-4 * np.abs(want_scores).max())


@pytest.mark.parametrize("method", METHODS)
def test_method_rows_match_jax(study, method):
    """Each method's recall@k within 0.01 of JAX's get_top_k_raw on the same
    tables and queries; the certification rates equal."""
    s = study
    oracle_sets = [set(r.tolist()) for r in s["oracle"].ids]
    raw = jax_factory.get_top_k_raw(method)
    res = jax.jit(lambda p, st, q, u: raw(s["model"], p, st, q, K, user_ids=u))(
        s["params"], s["jstate"], s["q"], s["uids"])
    want_recall = float(np.mean([len(set(r.tolist()) & oracle_sets[i]) / K
                                 for i, r in enumerate(np.asarray(res.ids))]))
    with torch.inference_mode():
        row, _, cert = frontier.run_method(s["port"], s["pstate"], s["pq"], s["puids"], method,
                                           K, 1, False, s["oracle"], torch.device("cpu"))
    assert abs(row[f"recall@{K}"] - want_recall) <= RECALL_TOL, (row, want_recall)
    if method.startswith(("MoLCertTopK", "MoLTileTopK")):
        budgets = jax_factory.parse_top_k_budgets(method)
        if method.startswith("MoLTileTopK"):
            def certificate(p, st, q, u):
                return jtk.mol_tile_top_k_shared(
                    s["model"], p, st, q, K, tiles_per_group=budgets["tiles_per_group"],
                    user_ids=u, certified=True)[1]
        else:
            def certificate(p, st, q, u):
                return jtk.mol_certified_top_k(s["model"], p, st, q, K,
                                               cand_budget=budgets["cand_budget"], user_ids=u)[1]
        jcert = jax.jit(certificate)(s["params"], s["jstate"], s["q"], s["uids"])
        assert row["cert_rate"] == float(np.mean(np.asarray(jcert.certified)))
        assert cert is not None
    if method == "MoLBruteForceTopKFused":
        assert row["score_rel_dev_max"] < 2e-2


def test_cli_prints_the_jax_summary(capsys):
    argv = SMALL + ["--train-steps", "2", "--runs", "1", "--k", "10",
                    "--methods", "MoLBruteForceTopKFused,MoLCertTopK512,MoLTileTopK4"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        summary = frontier.main(argv)
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert last == json.loads(json.dumps(summary))
    assert set(last) == {"metric", "num_items", "batch_size", "k", "cluster_sigma",
                         "train_steps", "int8", "rows"}
    assert last["metric"] == "frontier" and last["train_steps"] == 2 and not last["int8"]
    jax_keys = {"method", "ms_per_batch", "qps", "recall@10", "score_rel_dev_max", "cert_rate",
                "gap_bound_p50", "gap_bound_max"}
    assert [r["method"] for r in last["rows"]] == ["MoLBruteForceTopKFused", "MoLCertTopK512",
                                                   "MoLTileTopK4"]
    for row in last["rows"]:
        assert set(row) <= jax_keys and {"ms_per_batch", "qps", "recall@10"} <= set(row)
        assert row["ms_per_batch"] > 0
    assert "score_rel_dev_max" in last["rows"][0] and "cert_rate" in last["rows"][1]
    assert frontier.DEFAULT_METHODS == jax_frontier.DEFAULT_METHODS


@pytest.mark.parametrize("extra", [["--methods", "MoLBruteForceTopKFused,MoLIVFTopK8"],
                                   ["--methods", "MoLIVFTopK128"], ["--cluster-order"],
                                   ["--ivf-nlist", "64"], ["--ivf-iters", "3"]],
                         ids=["ivf_in_list", "ivf_alone", "cluster_order", "nlist", "iters"])
def test_ivf_spellings_raise_before_any_work(extra, monkeypatch):
    """The IVF methods and flags, which refused before IVF was ported, pass
    the method check (`check_ported`) and the work starts; the flags parse
    to JAX's defaults where not given."""
    def no_work(*args, **kwargs):
        raise AssertionError("work started")

    monkeypatch.setattr(frontier, "pretrain", no_work)
    with pytest.raises(AssertionError, match="work started"):
        frontier.main(SMALL + extra)
    args = frontier.parse_args(SMALL + extra)
    assert frontier.check_ported(args) == [m for m in args.methods.split(",") if m]
    assert args.ivf_iters == (3 if "--ivf-iters" in extra else 10)
    assert frontier.ivf_nlist(args) == (64 if "--ivf-nlist" in extra else
                                        max(64, int(4 * np.sqrt(NUM_ITEMS))))
