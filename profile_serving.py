"""Where the time of the port's serving step goes, on one CUDA card.

Run from the root of a checkout: `python3 profile_serving.py
[--top-k-method NAME]`. It builds the kernels, then serves `bench.py`'s
protocol through `rails_tpu_torch`: ml-20m-hstu-mol in bf16 with seeded
random weights, 26,744 items, 12 length-sorted batches of 512 ML-20M-shaped
users, each truncated to its 64-bucket, k=120, k'=200, retrieving with
`--top-k-method` (default MoLBruteForceTopKFused, the exact fused path; any
spelling the port serves, e.g. MoLCertTopK4096). It prints
  - ms/batch and q/s on the host clock (median of 3 unprofiled sweeps);
  - the device busy share of one sweep under `torch.profiler`: the union of
    the device-side kernel and memory-op intervals over that sweep's wall time;
  - device time per kernel name over that sweep, largest first.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import chip_smoke

N_BATCHES = 12       # bench.py: synthetic_num_users = batch_size * 12
TOP_ROWS = 12


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--top-k-method", default="MoLBruteForceTopKFused")
    args = parser.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rails_tpu_torch.core.device import require_cuda
    from rails_tpu_torch.ops import _build

    require_cuda()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    _build.load_library()
    model, es, step, batches = chip_smoke.serving_setup(torch.bfloat16, device, N_BATCHES,
                                                        args.top_k_method)

    def serve(f, t):
        return step(es.topk_state, f, t, es.item_embeddings)

    chip_smoke.run_batches(serve, batches)                              # warm-up
    ms = statistics.median(chip_smoke.run_batches(serve, batches)[1] for _ in range(3))
    lens = [f.ids.shape[1] for f, _ in batches]
    print(f"[serve] bf16 ml-20m-hstu-mol, {args.top_k_method}, {len(batches)} batches of "
          f"{chip_smoke.BATCH} "
          f"(n={lens}): {ms:.3f} ms/batch = {chip_smoke.BATCH / ms * 1e3:.1f} q/s on {smi}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chip_smoke.run_batches(serve, batches)
        wall_us = 1e6 * (time.perf_counter() - t0)
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device_events:
        raise RuntimeError("torch.profiler recorded no device events")
    busy_us = union_us((e.time_range.start, e.time_range.end) for e in device_events)
    print(f"[profile] one sweep: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"(union of {len(device_events)} device intervals) = busy share "
          f"{busy_us / wall_us:.4f}")
    per_name: dict = {}
    for e in device_events:
        per_name[e.name] = per_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP_ROWS]:
        print(f"[profile] {us / 1e3:10.3f} ms {us / busy_us:7.2%}  {name[:140]}")


if __name__ == "__main__":
    main()
