"""Training-throughput benchmark: users/s of the train step on one card.

Counterpart of `rails_tpu/cli/train_bench.py`: the config's model geometry
and loss on synthetic users (`--num-items` items), `--runs` distinct
batches of `--batch-size` users; after one warm-up step, three passes over
the batches, each timed between CUDA events (the host clock on the CPU),
the best pass giving ms/step. `train_flops_per_user` is JAX's analytic
count (matmuls only, backward as 2x forward), from which the achieved
TFLOP/s and `mfu_pct` follow: the share of the card's dense peak for the
step's compute dtype (bf16 with `--bf16` or a bf16 config, else f32), from
`PEAK_TFLOPS`; a card the table does not know gets `mfu_pct: null`. The
JSON line names the peak, the card and its power limit.

Usage: python -m rails_tpu_torch.cli.train_bench [--batch-size 128] [--runs 10]
           [--bf16] [--remat] [--shared-negatives] [--fused-train]
           [--fused-mol-loss] [--pallas-scatter]
CPU smoke: add `--device cpu --config synthetic-small --num-items 200 --runs 2`.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
from typing import Optional, Tuple

import numpy as np
import torch

# Dense peaks in TFLOP/s of the step's compute dtype, by card name: NVIDIA's
# data sheet for the H100 SXM at 700 W, float32 outside the tensor cores.
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.0, "float32": 67.0},
}


def train_flops_per_user(cfg, n: int, r: int, shared: bool) -> float:
    """Analytic matmul FLOPs for one training-step user at padded length n
    with r sampled negatives (backward counted as 2x forward — the standard
    matmul accounting; elementwise, gathers and norms excluded)."""
    h_cfg = cfg.hstu
    d = h_cfg.embedding_dim
    h, dqk, dv = h_cfg.num_heads, h_cfg.dqk, h_cfg.dv
    f_uvqk = 2 * h * dv + 2 * h * dqk
    o_in = h * dv * (3 if h_cfg.concat_ua else 1)
    enc_block = (
        2 * n * d * f_uvqk
        + 2 * n * n * h * dqk
        + 2 * n * n * h * dv
        + 2 * n * o_in * d
    )
    enc = h_cfg.num_blocks * enc_block

    m = cfg.mol
    l = m.num_logits
    d_p = m.dot_product_dimension
    p_q, p_x = m.query_dot_product_groups, m.item_dot_product_groups
    qh = max(m.query_hidden_dim, 0)
    q_side = (
        (2 * m.query_embedding_dim * 2 * qh + 2 * qh * p_q * d_p)
        if qh > 0
        else 2 * m.query_embedding_dim * p_q * d_p
    )
    if m.gating_query_fn:
        q_side += 2 * m.query_embedding_dim * m.gating_query_hidden_dim
        q_side += 2 * m.gating_query_hidden_dim * l
    ih = max(m.item_hidden_dim, 0)
    i_side = (
        (2 * m.item_embedding_dim * 2 * ih + 2 * ih * p_x * d_p)
        if ih > 0
        else 2 * m.item_embedding_dim * p_x * d_p
    )
    if m.gating_item_fn:
        i_side += 2 * m.item_embedding_dim * m.gating_item_hidden_dim
        i_side += 2 * m.gating_item_hidden_dim * l
    gqih = max(m.gating_qi_hidden_dim, 0)
    per_pair = 2 * p_q * p_x * d_p
    per_pair += (2 * l * gqih + 2 * gqih * l) if gqih > 0 else 2 * l * l

    # Every padded position is a query; each scores its positive and the
    # sampled negatives (one set per position, or one shared set per user
    # with train.shared_negatives).
    pairs = n * (1 + r)
    items_built = n + (r if shared else n * r)
    fwd = enc + n * q_side + items_built * i_side + pairs * per_pair
    return 3.0 * float(fwd)


def card(device: torch.device) -> Tuple[str, Optional[float]]:
    """The card's name and power limit in W from `nvidia-smi`
    ("cpu" and None on the CPU)."""
    if device.type != "cuda":
        return "cpu", None
    index = device.index if device.index is not None else torch.cuda.current_device()
    line = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return name, float(limit.split()[0])


def main(argv=None) -> dict:
    """Run the benchmark; prints and returns its JSON record."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="ml-20m-hstu-mol")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--num-items", type=int, default=26744)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="activation-checkpoint the negatives scoring")
    p.add_argument("--shared-negatives", action="store_true",
                   help="one negative set per batch instead of per position")
    p.add_argument("--fused-train", action="store_true",
                   help="the fused HSTU train block (K4)")
    p.add_argument("--fused-mol-loss", action="store_true",
                   help="the fused MoL loss (K5; needs --shared-negatives)")
    p.add_argument("--pallas-scatter", action="store_true",
                   help="the binned scatter-add of the item table's gradient (K6)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card); cpu runs the kernels' "
                        "plain versions")
    args = p.parse_args(argv)

    from rails_tpu_torch.core.config import get_experiment_config
    from rails_tpu_torch.core.device import resolve_device
    from rails_tpu_torch.data.datasets import SequenceDataset, generate_synthetic_sequences
    from rails_tpu_torch.train.loop import create_train_state, model_dtype
    from rails_tpu_torch.train.profiling import Timer

    device = resolve_device(args.device)
    cfg = get_experiment_config(args.config)
    cfg = cfg.replace(
        data=cfg.data.replace(
            dataset_name="synthetic",
            synthetic_num_users=max(args.batch_size * (args.runs + 2), 1024),
            synthetic_num_items=args.num_items,
        ),
        train=cfg.train.replace(
            local_batch_size=args.batch_size,
            main_module_bf16=args.bf16 or cfg.train.main_module_bf16,
            loss_activation_checkpoint=args.remat,
            shared_negatives=args.shared_negatives or cfg.train.shared_negatives,
            fused_mol_loss=args.fused_mol_loss or cfg.train.fused_mol_loss,
            pallas_scatter_grad=args.pallas_scatter or cfg.train.pallas_scatter_grad,
        ),
    )
    if args.fused_train:
        cfg = cfg.replace(hstu=cfg.hstu.replace(fused_train=True))
    if cfg.train.fused_mol_loss and not cfg.train.shared_negatives:
        raise SystemExit("--fused-mol-loss requires --shared-negatives (the fused kernel "
                         "scores one shared negative set); without it the unfused loss would "
                         "run and its numbers would be misattributed to the fused kernel")
    seqs = generate_synthetic_sequences(
        num_users=cfg.data.synthetic_num_users, num_items=args.num_items,
        max_len=cfg.data.synthetic_max_len or cfg.data.max_sequence_length + 2, seed=0,
        length_distribution=cfg.data.synthetic_length_distribution)
    ds = SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1)
    batches = list(itertools.islice(ds.batches(
        batch_size=args.batch_size, max_output_length=cfg.train.gr_output_length + 1,
        shuffle=True, seed=1, drop_last=True, device=device), args.runs))
    all_ids = np.arange(1, args.num_items + 1, dtype=np.int32)
    model, state, train_step, _ = create_train_state(cfg, args.num_items, all_ids,
                                                     device=device)
    generator = torch.Generator(device=device).manual_seed(0)

    state, m = train_step(state, batches[0], generator)
    m["loss"].item()                                 # waits for the warm-up step
    best = float("inf")
    for _ in range(3):
        with Timer(device) as timer:
            for b in batches:
                state, m = train_step(state, b, generator)
        best = min(best, timer.ms / 1e3 / len(batches))
    n_padded = int(batches[0].features.ids.shape[1])
    fpu = train_flops_per_user(cfg, n_padded, cfg.train.num_negatives,
                               cfg.train.shared_negatives)
    achieved = fpu * args.batch_size / best
    dtype = str(model_dtype(cfg)).removeprefix("torch.")
    name, power_limit = card(device)
    peak = PEAK_TFLOPS.get(name, {}).get(dtype)
    record = {
        "metric": "train_step_users_per_sec",
        "config": args.config,
        "batch_size": args.batch_size,
        "value": args.batch_size / best,
        "unit": "users/sec/card",
        "ms_per_step": best * 1e3,
        "achieved_tflops": achieved / 1e12,
        "compute_dtype": dtype,
        "peak_tflops": peak,
        "mfu_pct": None if peak is None else 100.0 * achieved / (peak * 1e12),
        "device": name,
        "power_limit_w": power_limit,
        "final_loss": float(m["loss"]),
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
