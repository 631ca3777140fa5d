"""Where the time of the port's training step goes, on one CUDA card.

Run from the root of a checkout: `python3 profile_train.py [--config NAME]
[--pallas-scatter] [--main-module-bf16] [--frontier]`. It builds the
kernels, optionally times the frontier's bf16 pre-train, then trains
`--config` (default ml-20m-hstu-mol; ml-20m-hstu-mol-fast shares 128
negatives across the batch and scores them with K5) through
`rails_tpu_torch` (f32, or bf16 with `--main-module-bf16`, seeded random
weights, 26,744 items, one batch of 128 ML-20M-shaped users at N = 211;
`chip_smoke.train_setup`), with the item table's gradient through K6 when
`--pallas-scatter` is given. It prints
  - ms/step on the host clock (median of 30 steps after 3 warm-up steps) and
    the peak device memory of those steps;
  - the device busy share of 2 steps under `torch.profiler`: the union of the
    device-side kernel and memory-op intervals over their wall time;
  - device time per kernel name over those steps, largest first, and the
    share of the port's own kernels (K3-K7) in it.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import chip_smoke
from profile_serving import union_us

WARMUP, TIMED, PROFILED = 3, 30, 2
TOP_ROWS = 16
OWN_KERNELS = ("hash_keep_mask_kernel", "ln_gemm_kernel", "hstu_attn_kernel", "tc_proj_kernel",
               "tc_attn_kernel", "tc_softmax_kernel", "tc_out_kernel", "tc_bwd_rows_kernel",
               "tc_tf32_proj_kernel", "tc_tf32_attn_kernel", "tc_tf32_out_kernel",
               "tc_tf32_dq_kernel", "tc_tf32_dkv_kernel",
               "tc_bwd_dq_kernel", "tc_bwd_dkv_kernel", "mol_loss_tc_kernel",
               "attn_row_bwd_kernel", "hstu_attn_bwd_rows_kernel", "hstu_attn_bwd_cols_kernel",
               "adamw_leaves_kernel",
               "mol_loss_fwd_kernel", "mol_loss_bwd_kernel", "reduce_slots_kernel",
               "count_kernel", "scan_kernel", "rank_kernel", "place_kernel", "sum_kernel")


def frontier_pretrain(device, smi: str) -> None:
    """The frontier CLI's pre-train at its defaults (`cli/frontier.py`: 150
    bf16 steps of ml-20m-hstu-mol at B=32), twice: ms/step of the second."""
    import torch

    from rails_tpu_torch.cli import frontier as fr

    args = fr.parse_args([])
    cfg = fr.configure(args)
    ds = fr.synthetic_dataset(cfg)
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, losses = fr.pretrain(cfg, ds, args.train_steps, device)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / len(losses)
    print(f"[frontier-pretrain] {cfg.name} bf16, B={args.batch_size}, {len(losses)} steps: "
          f"{ms:.3f} ms/step (the second of two runs), last loss {losses[-1]:.4f} on {smi}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="ml-20m-hstu-mol")
    parser.add_argument("--pallas-scatter", action="store_true",
                        help="train.pallas_scatter_grad: the item table's gradient through K6")
    parser.add_argument("--main-module-bf16", action="store_true",
                        help="train.main_module_bf16: the encoder in bf16 (bf16 K4)")
    parser.add_argument("--frontier", action="store_true",
                        help="first time the frontier's bf16 pre-train (its defaults: 150 steps "
                             "at B=32), host clock")
    args = parser.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rails_tpu_torch.core.device import require_cuda
    from rails_tpu_torch.ops import _build

    require_cuda()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    _build.load_library()
    if args.frontier:
        frontier_pretrain(device, smi)
    cfg, _, state, step, batch = chip_smoke.train_setup(
        device, args.config, pallas_scatter_grad=args.pallas_scatter,
        main_module_bf16=args.main_module_bf16)
    gen = torch.Generator(device=device).manual_seed(0)

    def one_step():
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), loss

    for _ in range(WARMUP):
        one_step()
    torch.cuda.reset_peak_memory_stats()
    runs = [one_step() for _ in range(TIMED)]
    ms = statistics.median(t for t, _ in runs)
    peak = torch.cuda.max_memory_allocated()
    dt = "bf16" if args.main_module_bf16 else "f32"
    print(f"[train] {dt} {cfg.name} (shared_negatives={cfg.train.shared_negatives}, "
          f"fused_mol_loss={cfg.train.fused_mol_loss}, pallas_scatter_grad="
          f"{cfg.train.pallas_scatter_grad}) B={chip_smoke.TRAIN_BATCH} "
          f"N={batch.features.ids.shape[1]}: "
          f"{ms:.3f} ms/step (median of {TIMED}) = "
          f"{chip_smoke.TRAIN_BATCH / ms * 1e3:.1f} sequences/s, peak memory "
          f"{peak / 2**30:.2f} GiB, losses {[round(loss, 4) for _, loss in runs]} on {smi}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            one_step()
        wall_us = 1e6 * (time.perf_counter() - t0)
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device_events:
        raise RuntimeError("torch.profiler recorded no device events")
    busy_us = union_us((e.time_range.start, e.time_range.end) for e in device_events)
    print(f"[profile] {PROFILED} steps: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms (union of {len(device_events)} device intervals) = busy "
          f"share {busy_us / wall_us:.4f}")
    per_name: dict = {}
    for e in device_events:
        per_name[e.name] = per_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    own = sum(us for name, us in per_name.items() if any(k in name for k in OWN_KERNELS))
    print(f"[profile] the port's kernels (K3-K7): {own / 1e3 / PROFILED:.3f} ms/step "
          f"= {own / busy_us:.2%} of device time")
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP_ROWS]:
        print(f"[profile] {us / 1e3 / PROFILED:10.3f} ms/step {us / busy_us:7.2%}  {name[:140]}")


if __name__ == "__main__":
    main()
