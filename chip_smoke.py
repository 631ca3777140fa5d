"""Quickest proof that the PyTorch/CUDA port (`rails_tpu_torch`) runs on an
NVIDIA H100: builds the hand-written kernels, checks each against its plain
PyTorch version, and drives the exact-MoL serving path end to end.

Run from the root of a checkout with one CUDA card: `python3 chip_smoke.py`.
Phases (one line each, any failure raises and exits non-zero):
  1. device: card name, `nvidia-smi` name and power limit; TF32 off.
  2. build:  nvcc builds K1 and K2 for sm_90a into build/rails_tpu_torch/.
  3. K1 (`fused_hstu_block`) vs its plain version at ML-20M block shapes.
  4. K2 (`fused_mol_scores_t`) vs its plain version over 26,744 items.
  5. end to end: ml-20m-hstu-mol serving through get_eval_state and
     make_eval_step_fn, in bf16 (as served) and in f32, each with launch
     counts and against the same step through the plain versions.
The line before the last is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}. Without CUDA the script fails before printing
any result.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import time

import numpy as np

D, H, DQK, DV, MAX_SEQ_LEN = 256, 8, 32, 32, 211      # ml-20m-hstu-mol HSTU block
P_Q, P_X, D_P, TEMPERATURE = 8, 4, 128, 0.05          # ml-20m-hstu-mol MoL
NUM_ITEMS = 26_744                                    # ML-20M unique items
BATCH = 512
K1_TOL = {"float32": (1e-3, 1e-4), "bfloat16": (2e-2, 2e-2)}   # (rtol, atol)
K2_TOL_F32 = (1e-4, 1e-3)      # logits carry 1/T = 20
# (dtype name, min rank agreement, min top-120 overlap) of the serving step's
# kernel path against its plain path on the same model, tables and batches.
# In bf16 both paths round at the same points but sum in other orders, and
# one-ulp differences through 16 blocks reorder near-tied scores.
E2E_TOL = (("bfloat16", 0.99, 0.96), ("float32", 0.995, 0.99))
# The bf16 kernel path's top-120 overlap with the f32 plain path may trail
# the bf16 plain path's by at most this much.
BF16_VS_F32_SLACK = 0.01


def ptxas_summary(log: str) -> str:
    """`name<dtype,template ints> registers (spills)` per kernel from the
    `-Xptxas -v` build log."""
    out, label = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            name = re.search(r"(ln_gemm_kernel|hstu_attn_kernel|mol_scores_kernel)", mangled)
            args = ["bf16" if "bfloat16" in mangled else "f32"] + re.findall(r"Li(\d+)E", mangled)
            label = f"{name.group(1) if name else mangled}<{','.join(args)}>"
            spilled = "?"
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and label:
            spilled = spill.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        if regs and label:
            out.append(f"{label} {regs.group(1)} ({spilled})")
            label = None
    return ", ".join(out)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_inputs(b: int, n: int, dtype, device, seed: int = 0):
    """Random ML-20M-shaped K1 operands: ragged lengths, sorted int32
    timestamps, the layer's rel-pos slab for n <= MAX_SEQ_LEN."""
    import torch

    g = torch.Generator().manual_seed(seed)
    f = 2 * H * DV + 2 * H * DQK
    lengths = torch.randint(1, n, (b,), generator=g)
    colmask = (torch.arange(n)[None, :] < lengths[:, None]).float()
    ts = torch.cumsum(torch.randint(60, 600_000, (b, n), generator=g), dim=1).to(torch.int32)
    ext = torch.cat([ts, ts[:, n - 1 :]], dim=1)
    pos_w = 0.02 * torch.randn(2 * MAX_SEQ_LEN - 1, generator=g)
    i, j = torch.arange(n)[:, None], torch.arange(n)[None, :]
    args = (
        torch.randn(b, n, D, generator=g).to(dtype),
        colmask,
        (torch.randn(D, f, generator=g) / D ** 0.5).to(dtype),
        (torch.randn(H * DV, D, generator=g) / (H * DV) ** 0.5).to(dtype),
        0.02 * torch.randn(D, generator=g),
        pos_w[j - i + MAX_SEQ_LEN - 1].contiguous(),
        ext.contiguous(),
        0.1 * torch.randn(128, generator=g),
    )
    kw = dict(num_heads=H, dqk=DQK, dv=DV, inv_n=1.0 / MAX_SEQ_LEN, eps=1e-6, num_buckets=128)
    return tuple(a.to(device) for a in args), kw


def check_k1(b: int, n: int, dtype, device) -> dict:
    import torch

    from rails_tpu_torch.ops.hstu_block import fused_hstu_block, fused_hstu_block_reference

    args, kw = k1_inputs(b, n, dtype, device)
    got = fused_hstu_block(*args, **kw)
    ref = fused_hstu_block_reference(*args, **kw)
    rtol, atol = K1_TOL[str(dtype).split(".")[-1]]
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
    err = (got.float() - ref.float()).abs().max().item()
    ms = cuda_ms(lambda: fused_hstu_block(*args, **kw))
    plain_ms = cuda_ms(lambda: fused_hstu_block_reference(*args, **kw))
    print(f"[K1] {str(dtype)[6:]} B={b} n={n} D={D} h={H}: max|err| {err:.3e} "
          f"(rtol {rtol}, atol {atol}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def k2_inputs(b: int, x: int, dtype, device, seed: int = 1):
    import torch

    from rails_tpu_torch.ops.mol_scoring import MoLKernelWeights, prepare_fused_tables
    from rails_tpu_torch.similarity.layers import l2_normalize

    g = torch.Generator().manual_seed(seed)
    l, hd = P_Q * P_X, 128
    q = l2_normalize(torch.randn(b, P_Q, D_P, generator=g))
    items = l2_normalize(torch.randn(x, P_X, D_P, generator=g))
    tables = prepare_fused_tables(items.to(dtype), torch.randn(x, l, generator=g).to(dtype))
    w = MoLKernelWeights(
        torch.randn(l, hd, generator=g) / l ** 0.5, 0.1 * torch.randn(hd, generator=g),
        torch.randn(hd, l, generator=g) / hd ** 0.5, 0.1 * torch.randn(l, generator=g),
    )
    args = (
        q.to(dtype).to(device), torch.randn(b, l, generator=g).to(device),
        tables.item_comp_t.to(device), tables.item_partial_t.to(device),
        MoLKernelWeights(*(t.to(device) for t in w)), TEMPERATURE,
    )
    return args, tables.num_items


def id_overlap(ia, ib) -> float:
    """Mean share of each row of ia (B, k) that also appears in that row of ib."""
    return (ia[:, :, None] == ib[:, None, :]).any(dim=2).float().mean().item()


def topk_overlap(a, b, k: int) -> float:
    return id_overlap(a.topk(k, dim=1).indices, b.topk(k, dim=1).indices)


def check_k2(b: int, x: int, dtype, device) -> dict:
    import torch

    from rails_tpu_torch.ops.mol_scoring import fused_mol_scores_t, fused_mol_scores_t_reference

    args, x = k2_inputs(b, x, dtype, device)
    got = fused_mol_scores_t(*args)[:, :x]
    ref = fused_mol_scores_t_reference(*args)[:, :x]
    err = (got - ref).abs().max().item()
    if dtype == torch.float32:
        rtol, atol = K2_TOL_F32
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
        verdict = f"rtol {rtol}, atol {atol}"
    else:
        top1 = (got.argmax(dim=1) == ref.argmax(dim=1)).float().mean().item()
        overlap = topk_overlap(got, ref, 200)
        verdict = f"top-1 agree {top1:.4f} (>= 0.99), top-200 overlap {overlap:.4f} (>= 0.994)"
        if top1 < 0.99 or overlap < 0.994:
            raise AssertionError(f"K2 bf16 outside its contract: {verdict}")
    ms = cuda_ms(lambda: fused_mol_scores_t(*args))
    plain_ms = cuda_ms(lambda: fused_mol_scores_t_reference(*args), iters=3, warmup=1)
    print(f"[K2] {str(dtype)[6:]} tables B={b} X={x} MoL {P_Q}x{P_X}x{D_P}: max|err| "
          f"{err:.3e} ({verdict}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def serving_setup(compute_dtype, device, n_batches: int):
    """The ml-20m-hstu-mol model (seeded random weights), its exact fused eval
    state, the eval step and length-sorted ML-20M-shaped batches, each
    truncated to its 64-bucket."""
    import torch

    from rails_tpu.core.config import get_experiment_config
    from rails_tpu_torch.data.datasets import SequenceDataset, generate_synthetic_sequences
    from rails_tpu_torch.data.features import serving_pad_length, truncate_features
    from rails_tpu_torch.models.encoder import SequentialRecommender
    from rails_tpu_torch.train.evaluation import get_eval_state, make_eval_step_fn

    bf16 = compute_dtype == torch.bfloat16
    cfg = get_experiment_config("ml-20m-hstu-mol")
    cfg = cfg.replace(
        hstu=cfg.hstu.replace(fused_inference=True),
        train=cfg.train.replace(main_module_bf16=bf16, eval_bf16=bf16),
    )
    model = SequentialRecommender(
        cfg, NUM_ITEMS, compute_dtype=compute_dtype, device=device,
        generator=torch.Generator().manual_seed(0),
    )
    es = get_eval_state(
        model, np.arange(1, NUM_ITEMS + 1, dtype=np.int32), "MoLBruteForceTopKFused",
        table_dtype=compute_dtype, device=device,
    )
    step = make_eval_step_fn(
        model, es.top_k_method, k=120, num_objects=es.num_objects,
        filter_invalid_ids=True, truncate_k_prime_to=200,
    )
    seqs = generate_synthetic_sequences(
        num_users=BATCH * n_batches, num_items=NUM_ITEMS, max_len=200, seed=0,
        length_distribution="ml20m",
    )
    ds = SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1)
    batches = []
    for b in ds.batches(BATCH, cfg.train.gr_output_length + 1, shuffle=False,
                        sort_by_length=True, drop_last=True, device=device):
        n_full = b.features.ids.shape[1]
        n = min(n_full, serving_pad_length(int(b.features.lengths.max()), 64))
        batches.append((truncate_features(b.features, n), b.target_ids))
    return model, es, step, batches


def run_batches(fn, batches) -> tuple:
    """Outputs of fn over every batch and the host-clock ms per batch."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [fn(f, t) for f, t in batches]
    torch.cuda.synchronize()
    return outs, 1e3 * (time.perf_counter() - t0) / len(batches)


@contextlib.contextmanager
def plain_kernels():
    """The serving step with its two kernel calls bound to their plain
    versions, for comparison only; the launch counters must not move."""
    from unittest import mock

    from rails_tpu_torch.index import top_k
    from rails_tpu_torch.models import hstu
    from rails_tpu_torch.ops.hstu_block import fused_hstu_block, fused_hstu_block_reference
    from rails_tpu_torch.ops.mol_scoring import fused_mol_scores_t, fused_mol_scores_t_reference

    before = (fused_hstu_block.launches, fused_mol_scores_t.launches)
    with mock.patch.object(hstu, "fused_hstu_block", fused_hstu_block_reference), \
            mock.patch.object(top_k, "fused_mol_scores_t", fused_mol_scores_t_reference):
        yield
    if (fused_hstu_block.launches, fused_mol_scores_t.launches) != before:
        raise AssertionError("the plain path launched a kernel")


def check_outputs(outs, batches, k: int = 120) -> None:
    import torch

    for (ranks, ids, scores), (f, _) in zip(outs, batches):
        b = f.ids.shape[0]
        assert ranks.shape == (b,) and ids.shape == (b, k) and scores.shape == (b, k)
        assert bool(torch.isfinite(scores).all()), "non-finite scores"
        assert bool(((ids >= 1) & (ids <= NUM_ITEMS)).all()), "ids outside the corpus"
        assert bool((scores[:, 1:] <= scores[:, :-1]).all()), "scores not sorted"
        assert bool((((ranks >= 1) & (ranks <= k)) | (ranks == 1001)).all()), "bad ranks"


def end_to_end(device, name: str, smi: str, n_batches: int = 3) -> dict:
    """bf16 (the served path, `bench.py`'s settings) and f32: the kernel path
    with its launch counts and times, against the same step through the plain
    versions on the card; then both bf16 paths against the f32 plain path.
    Returns the bf16 run's launch counts."""
    import torch

    from rails_tpu_torch.ops.hstu_block import fused_hstu_block
    from rails_tpu_torch.ops.mol_scoring import fused_mol_scores_t

    launches, ids = {}, {}
    for dtype_name, min_rank_agree, min_overlap in E2E_TOL:
        dtype = getattr(torch, dtype_name)
        model, es, step, batches = serving_setup(dtype, device, n_batches)

        def serve(f, t):
            return step(es.topk_state, f, t)

        def plain(f, t):
            with plain_kernels():
                return step(es.topk_state, f, t)

        run_batches(serve, batches)                                       # warm-up
        fused_hstu_block.launches = 0
        fused_mol_scores_t.launches = 0
        outs_k, ms = run_batches(serve, batches)
        counts = {"K1": fused_hstu_block.launches, "K2": fused_mol_scores_t.launches}
        if counts["K1"] != model.cfg.hstu.num_blocks * len(batches) or counts["K2"] < len(batches):
            raise AssertionError(f"main path launches {counts} for {len(batches)} batches")
        launches[dtype_name] = counts
        check_outputs(outs_k, batches)
        ms_k = statistics.median([ms] + [run_batches(serve, batches)[1] for _ in range(2)])
        run_batches(plain, batches)                                       # warm-up
        outs_p, ms_p = run_batches(plain, batches)
        rk, rp = (torch.cat([o[0] for o in outs]) for outs in (outs_k, outs_p))
        ik, ip = (torch.cat([o[1] for o in outs]) for outs in (outs_k, outs_p))
        rank_agree = (rk == rp).float().mean().item()
        real = int(((rk <= 120) | (rp <= 120)).sum())
        overlap = id_overlap(ik, ip)
        ids[dtype_name] = (ik, ip)
        print(f"[e2e] {dtype_name} ml-20m-hstu-mol, {len(batches)} batches of {BATCH} "
              f"(n={[f.ids.shape[1] for f, _ in batches]}), {NUM_ITEMS} items, k=120, k'=200: "
              f"launches {counts}; kernel path median {ms_k:.3f} ms/batch = "
              f"{BATCH / ms_k * 1e3:.1f} q/s, plain path {ms_p:.3f} ms/batch = "
              f"{BATCH / ms_p * 1e3:.1f} q/s on {name} ({smi}); vs plain: ranks agree on "
              f"{rank_agree:.4f} of {rk.numel()} rows (>= {min_rank_agree}; {real} rows have a "
              f"rank <= 120), top-120 overlap {overlap:.4f} (>= {min_overlap})")
        if rank_agree < min_rank_agree or overlap < min_overlap:
            raise AssertionError(f"{dtype} kernel path disagrees with the plain path")
        del model, es, step, batches, outs_k, outs_p
    ref = ids["float32"][1]
    kernel_bf16, plain_bf16 = (id_overlap(i, ref) for i in ids["bfloat16"])
    print(f"[e2e] top-120 overlap with the f32 plain path: bf16 kernel path {kernel_bf16:.4f}, "
          f"bf16 plain path {plain_bf16:.4f} (kernel >= plain - {BF16_VS_F32_SLACK})")
    if kernel_bf16 < plain_bf16 - BF16_VS_F32_SLACK:
        raise AssertionError("the bf16 kernel path is further from f32 than the bf16 plain path")
    return launches["bfloat16"]


def main() -> None:
    import torch

    from rails_tpu_torch.core.device import require_cuda
    from rails_tpu_torch.ops import _build

    require_cuda()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off")
    print(smi)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"[build] K1 + K2 for sm_90a in {time.perf_counter() - t0:.1f} s -> {lib_path}")
    print(f"[build] registers per thread (spilled bytes): "
          f"{ptxas_summary((lib_path.parent / 'build.log').read_text())}")

    k1 = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n in (64, MAX_SEQ_LEN):
            k1[(dtype, n)] = check_k1(BATCH, n, dtype, device)
    k2 = {dtype: check_k2(BATCH, NUM_ITEMS, dtype, device)
          for dtype in (torch.float32, torch.bfloat16)}
    launches = end_to_end(device, name, smi)

    summary = [
        {"name": "fused_hstu_block", "route": "cuda", "source": "rails_tpu_torch/csrc/hstu_block.cu",
         "replaces": "rails_tpu/ops/pallas/hstu_block.py:432", "launches": launches["K1"],
         **k1[(torch.bfloat16, MAX_SEQ_LEN)]},
        {"name": "fused_mol_scores_t", "route": "cuda", "source": "rails_tpu_torch/csrc/mol_scoring.cu",
         "replaces": "rails_tpu/ops/pallas/mol_scoring.py:724", "launches": launches["K2"],
         **k2[torch.bfloat16]},
    ]
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
