"""Quickest proof that the PyTorch/CUDA port (`rails_tpu_torch`) runs on an
NVIDIA H100: builds the hand-written kernels, checks each against its plain
PyTorch version, and drives the exact-MoL serving path and the ml-20m-hstu-mol
training step end to end.

Run from the root of a checkout with one CUDA card: `python3 chip_smoke.py`.
Phases (one line each, any failure raises and exits non-zero):
  1. device: card name, `nvidia-smi` name and power limit; TF32 off.
  2. build:  nvcc builds every kernel for sm_90a into build/rails_tpu_torch/;
     the tensor-core instructions (HMMA, HGMMA) of each of K1's bf16 kernels
     (with their TRAIN instances, K4's bf16 forward), of K4's bf16 backward
     kernels (`tc_bwd_rows_kernel`, `tc_bwd_dq_kernel`, `tc_bwd_dkv_kernel`)
     and of every instance of K2's, K8/K9's and K5's tensor-core kernels
     (`mol_tc_kernel`, `mol_bounds_tc_kernel`, `mol_loss_tc_kernel`) and of
     K4's f32 route (`tc_tf32_*`, TF32 HMMA) in the library's SASS
     (`cuobjdump -sass`), none may have zero.
  3. K1 (`fused_hstu_block`) vs its plain version at ML-20M block shapes,
     with its route, each stage's device time and the instruction it
     multiplies with; its three bf16 stages (`project`, `attention_oinput`
     pointwise and softmax, `out_gemm`) each vs its plain stage version; the
     f32 route's stages (3xTF32: `tf32_project`, `tf32_attention` pointwise
     and softmax, `tf32_out_gemm`) each within K1_TF32_STAGE_TOL of its
     plain stage, two calls bit-equal, bounds at 3xTF32's 165 TFLOP/s, the
     CUDA cores' 67 and in bytes; `[K1-hash]`, the hashes of the outputs
     the f32 route must leave alone (`untouched_hashes`); K1 at the Amazon
     Books (D=64, h=8, dqk=dv=8, N=61) and ML-1M (D=50, h=2, dqk=dv=25,
     N=211) widths and the softmax variant at h=4, dqk=dv=16.
  4. K2 (`fused_mol_scores_t`) vs its plain version over 26,744 items: bf16
     and int8 tables on the tensor cores (`.tc_launches` printed), f32 on the
     CUDA cores. The K2, K10,
     K2-bmax and P2 bounds carry a MUFU term: one special-function result
     (ex2) for each SiLU and exp the function needs, at the SM clock
     `nvidia-smi` reads under load; their lines also give one call's device
     time under torch.profiler.
  5. e2e: ml-20m-hstu-mol serving through get_eval_state and
     make_eval_step_fn, in bf16 (as served) and in f32, each with launch
     counts (every K1 block on its route's stages: bf16 and f32 on the
     tensor cores) and against the same step through the plain versions. Here and
     in approx, int8, int8-e2e, books-e2e and frontier, every K2, K8, K9
     and K10 launch on bf16 or int8 tables must have taken the tensor-core
     route (`.tc_launches`).
  6. K3 (`hash_keep_mask`), the o_input mask at (128, 211, 256), bit-equal.
  7. K4 (`fused_train_block_forward`, `attn_backward`): one layer at B=128,
     n=211, f32 and bf16, forward and every gradient vs the plain versions
     (f32: the plain autograd version; bf16: the block's glue over the plain
     forward and attention backward), and the attention backward alone; the
     route of each direction (bf16: the tensor cores) with each stage's
     device us; f32 on the tensor cores by 3xTF32 in both directions, its
     bounds at 3xTF32's 165 TFLOP/s with the CUDA cores' 67 beside them.
     K4-stage: the bf16 route's four kernels (the TRAIN attention, the
     backward's rows, dq and dkv stages) and the f32 route's six stages
     (projection, attention, output GEMM, rows, dq, dkv) each vs its plain
     stage version, two calls bit-equal.
  8. K7 (`adamw_update_leaves`) on the two fused leaves of ml-20m in one
     launch, vs its plain version, with `torch._fused_adamw_` timed as a
     yardstick and the call's device operations under torch.profiler.
  9. train: create_train_state + train_step on ml-20m-hstu-mol (B=128,
     N=211, R=128, f32): step 1 through the kernels vs the same step through
     the plain versions, then 20 steps on one batch (the loss must fall),
     ms/step, peak memory and launch counts.
 10. K5 (`fused_mol_loss_forward`, `fused_mol_loss_backward`) at M=26,880,
     R=128 shared negatives, H=128: ML-20M's MoL 8x4x128 (dropout 0.2 / 0.1)
     and ML-1M's 8x4x64 (0.2 / 0), f32: forward and the 8 gradients vs the
     plain versions, each direction on the route `tc_route` names (the
     tensor cores, 3xTF32: `.tc_launches`), two backward calls bit-equal;
     the bound's operations at 3xTF32's rate and its MUFU term.
 11. K6 (`scatter_add_rows`): the (128, 211) ids of an ML-20M-shaped batch
     into (26,745, 256) f32, and a small case with duplicate, negative and
     out-of-range ids, vs its plain version, two calls bit-equal, with
     `index_add_` timed as a yardstick and the call's device operations under
     torch.profiler (only the kernel's own: no torch sort, search or scan);
     then the (64, 61) ids of an Amazon Books batch into (695,763, 64) f32.
 12. train-fast: ml-20m-hstu-mol-fast with pallas_scatter_grad (B=128, N=211,
     R=128 shared, f32), as in 9, through K3-K7.
 13. K8 (`fused_mol_ub_t`), K9 (`fused_mol_group_block_max`) and K10
     (`fused_mol_scores_tiles`, 1,024 tile ids with a duplicate and the last
     tile) at B=32 over 1,048,576 items, f32 and bf16 tables, vs their plain
     versions, each line with its route and `.tc_launches`; K10 bit-equal to
     K2's columns of the same tiles; K8's bound above K2's score of every
     (query, item) up to F32_MARGIN (the mixture's f32 rounding: where both
     take the tensor cores, K8 is the max of K2's logits bit for bit); K9's
     max over l equal to K8's per-tile max bit for bit.
 14. approx: the frontier protocol (`rails_tpu/cli/frontier.py`) at
     ml-20m-hstu-mol, bf16: a clustered synthetic corpus of 1,048,576 items
     (cut from the frontier's 8M for the script's time), B=32, k=200, every
     method through build_mol_topk_state + get_top_k_raw: ms/batch, launch
     counts, top-200 overlap with the exact (K2) ids, recall@200 of the exact
     top-1, and for the certified methods the certification rate (also at
     budgets of 65,536 and 262,144). It gates on soundness only: certified
     rows hold the exact top-k (see `check_certified`), and MoLCertTopK with
     a budget >= X certifies every row.
 15. approx-e2e: the 3 serving batches of 512 through get_eval_state and
     make_eval_step_fn with MoLCertTopK4096, MoLTileTopK8 and
     MoLCombTopK50_4096, vs the same steps through the plain versions, and
     recall_vs_exact against MoLBruteForceTopKFused.
int8 serving tables and the exact select at scale:
 16. K2 on int8 tables (quantize_fused_tables of phase 4's bf16 tables) at
     B=512 over 26,744 items, and K8, K9, K10 on int8 tables at B=32 over
     1,048,576 items (in phase 13's lines), each vs its plain version; K10
     bit-equal to K2's columns, K8 >= K2 on every pair, K9 = K8 per tile.
 17. K2-bmax: K2's emit_blockmax at B=32 over 1,048,575 items with mid-corpus
     valid=0 columns and the pad tail: the scores bit-equal to K2's with those
     columns at -1e30, the (B, X/256) maxima exact, vs the plain version.
 18. int8: the at-scale path at 4,194,304 items (the frontier's 4M size) of
     phase 14's clustered corpus, built bf16 and int8 by
     build_fused_state_chunked_on_device, with streamed_exact_top_k as the
     oracle: the exact bf16 path (K2-bmax + hierarchical_top_k) held to the
     oracle tie-aware and bit-equal to torch.topk of the same scores, and the
     Int8 spellings, Naive on the int8 fused_only state, their ms/batch,
     launches, overlap with the oracle and recall of its top-1; the certified
     int8 rows sound.
 19. int8-e2e: the serving step with MoLBruteForceTopKFusedInt8 and
     MoLCertTopK4096Int8, vs the plain path, recall_vs_exact and launches.
The frontier and its bf16 pre-train:
 20. train-bf16: as 9 with main_module_bf16 (bf16 K4, 16 + 16 launches per
     step, all on the tensor cores: `.tc_launches`, and each stage kernel 16
     a step), the kernel step vs the plain step at bf16 tolerances.
 21. frontier: `rails_tpu_torch.cli.frontier` through its functions at
     8,000,000 items (uncut): 150 bf16 pre-train steps at B=32 (the loss must
     fall), the chunked bf16 build, queries through the XLA-path encoder (no
     K1), the streamed oracle, every default method (one JSON row each, as
     the CLI prints it; before the first IVF method the `ivf_build` row with
     its seconds and nlist, and each MoLIVFTopK8/32/128 row with the JAX
     package's 8M recall beside it), then Fused, Cert4096 and Tile8 on the
     int8 build of the same corpus. Every bf16 K4 launch of the pre-train takes the
     tensor-core route. Gates: the exact bf16 path vs the oracle tie-aware, the
     exact int8 path equal to torch.topk of K2-int8's scores, certified rows
     holding K2's exact top-k. Recall is printed, not gated.
Amazon Books (amzn-books-hstu-mol[-fast]: MoL 8x8x32, L=64, H=128; bf16):
 22. K2, K8, K9, K10 at 8x8x32 on f32, bf16 and int8 tables and K2-bmax, at
     B=64 over the Books vocabulary of 695,762 items, with the checks of 4,
     13 and 17.
 23. K5 bf16 at M=3,840, R=512 (B=64, N=61), 8x8x32 on the tensor cores
     (mma.sync bf16): forward and the 8 gradients against the bf16 plain
     versions, as 10.
 24. books-e2e: the Books serving step at 16 blocks (the XLA-path encoder,
     no K1) over 695,762 items, B=64, through Fused, Cert4096 and Tile8 and
     their Int8 forms, against the plain path; launch counts.
 25. books-train and books-train-fast: as 9 at B=64, N=61, R=512 in bf16;
     the XLA block path launches no kernel, -fast the bf16 K5 1 + 1 per step.
K1's block variants and the cost probes:
 26. K1-var: each of K1_VAR_INSTANCES (concat_ua, activation none, softmax
     with the in-kernel bias, softmax with a precomputed raw bias,
     mask_in_bias, no bias, concat_ua + softmax) at B=512, n=211, f32 and
     bf16, vs its plain version, with its route (f32 but activation none on
     the 3xTF32 stages, each launched once).
 27. variants-e2e: ml-20m-hstu-mol in bf16 with fused_inference and each
     variant's `--set` overrides (int64 timestamps for the precomputed-bias
     modes): one batch of 512 through K1 + K2 vs the plain path, with 5's
     bf16 checks; 16 K1 launches per batch; then each SiLU instance in f32
     with 5's f32 checks, every block on the 3xTF32 stages (softmax on
     `serve_softmax_kernel`).
 28. P1: `rails_tpu_torch.cli.encode_probe`: every mode vs its plain version
     (one block, B=64, n=192), full vs K1's concat_ua instance, per-mode
     kernel, plain and bound ms at B=512, n=192, and the CLI's 16-block
     sweep of every mode with --runs cut to P1_RUNS.
 29. P2: `rails_tpu_torch.cli.mol_probe` at B=32 over 2,000,000 items (data
     drawn on the card): every mode vs its plain version over every column
     within `mol_probe_error_bound` (one bf16 flip of an MLP input), which
     the kernel on each seeded fault of P2_FAULTS must break,
     full vs K2 with the weights in K2's n-major order (K2's bf16 contract),
     per-mode kernel, plain and bound ms, and the CLI's timing of every mode
     and of the hierarchical select.
K4's variants (the fused train block's flags):
 30. K4-var: each of K4_VAR_INSTANCES (concat_ua, activation none, softmax,
     no bias, attention dropout 0.2, concat_ua + softmax + attention dropout,
     h=4 with dqk=dv=64) at B=128, n=211, f32 and bf16, as 7: forward, every
     gradient and the attention backward alone vs the plain versions;
     kernel, plain and bound ms of both directions.
 31. train-var: ml-20m-hstu-mol with fused_train and each instance's flags,
     f32 and bf16: step 1 kernels vs plain to 9's contract, then TRAIN_VAR_STEPS steps
     (ms/step, peak memory, launch counts: K4 forward and backward and the
     variant's own counters 16 per step).
IVF and the data pipeline (no kernel of their own: plain torch and host code):
 32. ivf (after 15): phase 14's corpus with bf16 standard and fused tables,
     nlist 4,096: k-means twice with one seed, bit-equal; every real
     position once in buckets + overflow; every list probed = the exact
     fused top-k (tie-aware); after `permute_state_items` in cluster order
     the exact method's scores bit-equal; IVF8/32 and Tile8 on both layouts
     (recall printed, not gated).
 33. data: an ML-1M-shaped ratings.dat at full size (6,040 users,
     3,706 items, ~1M events) through the pandas-free preprocessor and
     `get_reco_dataset` (the native parser must run, its arrays equal to the
     Python parser's, both timed); one ml-1m-hstu-mol eval batch through
     MoLBruteForceTopKFused (K2 once, on the tensor cores) vs the plain path;
     three ml-1m-hstu-mol-fast steps (K5) from `prefetch_batches`, step 1
     kernels vs plain, every step's launches checked.
 34. sharded: 4 ranks on the card (spawned, gloo, joined within
     SHARD_TIMEOUT) serve ml-20m-hstu-mol (bf16, K1 encode) over 2,097,152
     items sharded on the mesh's `item` axis, each rank building only its
     slab and its slab's IVF index: the exact methods return the
     single-process path's ids, Naive and Comb at full budget are exact,
     ids in range, every rank the same lists, each rank launched K1, K2
     with its tile maxima, K8, K9, K10; Avg, Cert, Tile and IVF32 ms/batch
     and recall@200 beside the unsharded method's (not gated).
 35. shard-bench: `cli/shard_bench.py`'s main at one rank (nccl) over
     8,000,000 items, MoLBruteForceTopKFused: build s and ms/batch.
 36. dp-train: 2 ranks on the card (gloo), 3 data-parallel steps of
     ml-20m-hstu-mol and ml-20m-hstu-mol-fast at a global batch of 128, vs
     the single-process step on the same batch (losses, step 1's gradients
     within each config's limit, the parameters), the ranks' parameters
     bit-equal, K3-K7 launched; a planted fault (the hash streams number a
     rank's rows from 0) must fall outside the gradient limit. Several
     ranks on one card check correctness only.
 37. cli: the training and eval CLIs at ml-20m-hstu-mol's full width over
     1,024 synthetic users and 26,744 items, every encode through K1:
     `cli.train` one epoch and a resume from its checkpoint for a second,
     `cli.eval` (MoLBruteForceTopKFused, latency, recall against the exact
     method) building and saving the serving state, then loading it (equal
     lines but for the timing columns), `cli.train_bench` at its defaults
     and with `-fast`'s flags and `--pallas-scatter` (users/s, ms/step,
     TFLOP/s, mfu_pct against the card's named peak), `cli.sweep` over the
     synthetic menu; K1, K2, K4, K5, K6 and K7 must launch.
 38. compat: the original torch repo's checkpoint format at the same width:
     `cli.export_checkpoint` of cli's ep1; a second payload with the
     AdamW state of `torch.optim.AdamW` after 3 seeded steps over that
     payload's parameters; `cli.import_checkpoint` of both. The first
     imports bit-equal to ep1, the second to torch's weights and moments
     (count 3); one more step through the port's `FusedAdamW` (K7) matches
     torch's fourth within rtol 2e-5, atol 1e-7; `cli.eval` of the import
     prints ep1's line but for the timing columns; `cli.train` resumes from
     the second for an epoch (finite losses; epoch, batch_id and step
     continue); export and import of the resumed checkpoint is the
     identity; K1, K2, K4 and K7 must launch.
The line before the last is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}. Without CUDA the script fails before printing
any result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

D, H, DQK, DV, MAX_SEQ_LEN = 256, 8, 32, 32, 211      # ml-20m-hstu-mol HSTU block
P_Q, P_X, D_P, TEMPERATURE = 8, 4, 128, 0.05          # ml-20m-hstu-mol MoL
NUM_ITEMS = 26_744                                    # ML-20M unique items
BATCH = 512
TRAIN_BATCH = 128                                     # ml-20m-hstu-mol local_batch_size
TRAIN_STEPS = 20
TRAIN_VAR_STEPS = 10           # [train-var]'s steps a run, cut from 20 to keep the script's time
# Published peaks of one H100 SXM (dense): f32 outside the tensor cores and
# bf16 on them; HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# f32 products as 3xTF32 on the tensor cores (K5's f32 route): three TF32
# products (495 TFLOP/s dense) for each.
TF32X3_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12
# Hopper's special-function units: 16 MUFU results (ex2, rcp, tanh) per SM
# per clock (four per SM sub-partition), at the SM clock the card holds.
SFU_PER_SM_CLOCK = 16
K4_TOL = (1e-3, 1e-4)          # (rtol, atol) of the f32 forward, as K1
# Gradients: max |kernel - plain| over max |plain|, per tensor or group. Both
# paths sum in other f32 orders (and index_add_ bins d tsw with atomics).
GRAD_REL_TOL = 1e-3
TRAIN_LOSS_RTOL = 1e-4
# Each stage of K4's f32 route (3xTF32) against its plain version alone:
# max |kernel - plain| over max |plain| per output. Measured 0.9-3.2e-6 on an
# H100 (the sums run in other f32 orders); the same kernels with the lo terms
# dropped (1xTF32, `profile_k4_f32.py --variant 1xtf32`) reach 6.2e-4 to
# 2.3e-3 in every TF32 stage, which GRAD_REL_TOL = 1e-3 would partly pass.
K4_TF32_STAGE_TOL = 2e-5
# bf16 K4 against its plain version: the forward and each gradient within
# this share of its largest value (both round to bf16 at the same points and
# sum in other f32 orders), as the CPU test holds the plain version to JAX.
K4_BF16_TOL = 2e-2
# The bf16 training step, kernels vs plain: loss rtol and gradient share.
# One-ulp differences of the bf16 blocks grow through 16 layers and the bf16
# loss: measured 1.9e-5 on the loss and up to 4.4e-2 (hstu) on the gradients
# (NVIDIA H100 80GB HBM3, 700 W).
BF16_TRAIN_TOL = (1e-2, 1e-1)
# K6: max |kernel - plain| over max(1, max |plain|). Both sum in f32, in other
# orders where ids repeat.
K6_TOL = 1e-6
K5_RATES = (0.2, 0.1)          # ml-20m-hstu-mol: softmax, gating-qi dropout
NUM_NEGATIVES = 128            # ml-20m-hstu-mol num_negatives
K1_TOL = {"float32": (1e-3, 1e-4), "bfloat16": (2e-2, 2e-2)}   # (rtol, atol)
# K1 geometries (D, h, dqk, dv, max_seq_len): ml-20m-hstu-mol, amzn-books-hstu-mol,
# ml-1m's HSTU, and h=4 with dqk=dv=16 (a softmax map over h*dqk = 64).
K1_GEOMS = {"ml-20m": (256, 8, 32, 32, 211), "books": (64, 8, 8, 8, 61),
            "ml-1m": (50, 2, 25, 25, 211), "h=4": (64, 4, 16, 16, 211),
            # ml-20m-hstu-mol's block under the rated preprocessor (D = 256 + 8)
            # and under the combined one (items and ratings interleaved: n = 2 x 211).
            "rated": (264, 8, 32, 32, 211), "combined": (256, 8, 32, 32, 422)}
# K1's bf16 tensor-core kernels (csrc/hstu_block_tc.cuh) and the instruction
# each multiplies with; every other K1 kernel runs FFMA on the CUDA cores.
TC_KERNELS = ("tc_proj_kernel", "tc_attn_kernel", "tc_softmax_kernel", "tc_out_kernel")
# K4's bf16 backward on the tensor cores (csrc/hstu_train_tc.cuh); its forward
# runs the TRAIN instances of K1's attention kernels.
K4_TC_KERNELS = ("tc_bwd_rows_kernel", "tc_bwd_dq_kernel", "tc_bwd_dkv_kernel")
# Their launch counters: the train attention stage and the backward's three.
K4_STAGES = ("K4 attn", "K4 bwd rows", "K4 bwd dq", "K4 bwd dkv")
# K4's f32 route on the tensor cores, 3xTF32 (csrc/hstu_train_tf32.cuh), and
# the launch counters of its six stages (the backward's rows stage is
# attn_row_bwd_kernel of csrc/hstu_train.cuh).
K4_TF32_KERNELS = ("tc_tf32_proj_kernel", "tc_tf32_attn_kernel", "tc_tf32_out_kernel",
                   "tc_tf32_dq_kernel", "tc_tf32_dkv_kernel")
K4_TF32_STAGES = ("K4 f32 proj", "K4 f32 attn", "K4 f32 out", "K4 f32 bwd rows",
                  "K4 f32 bwd dq", "K4 f32 bwd dkv")
TC_INSTRUCTION = "mma.sync.m16n8k16 bf16 (HMMA)"
TF32_INSTRUCTION = "mma.sync.m16n8k8 3xTF32 (HMMA)"
K1_STAGES = ("K1 proj", "K1 attn", "K1 out")   # their launch counters
# K1's f32 route on the tensor cores, 3xTF32 (csrc/hstu_serve_tf32.cuh), and
# the launch counters of its stages ("K1 f32 attn" counts both attention
# kernels' launches, "K1 f32 softmax" the softmax kernel's).
K1_TF32_KERNELS = ("serve_proj_kernel", "serve_attn_kernel", "serve_softmax_kernel",
                   "serve_out_kernel")
K1_TF32_STAGES = ("K1 f32 proj", "K1 f32 attn", "K1 f32 out")
# Each stage of K1's f32 route against its plain version alone: max |err|
# over max |plain| per output, the CPU test's limit
# (tests/test_torch_port_k1_tf32.py), as K4_TF32_STAGE_TOL is for K4.
K1_TF32_STAGE_TOL = 2e-5
K2_TOL_F32 = (1e-4, 1e-3)      # logits carry 1/T = 20
# (dtype name, min rank agreement, min top-120 overlap) of the serving step's
# kernel path against its plain path on the same model, tables and batches.
# In bf16 both paths round at the same points but sum in other orders, and
# one-ulp differences through 16 blocks reorder near-tied scores.
E2E_TOL = (("bfloat16", 0.99, 0.96), ("float32", 0.995, 0.99))
# The bf16 kernel path's top-120 overlap with the f32 plain path may trail
# the bf16 plain path's by at most this much.
BF16_VS_F32_SLACK = 0.01
APPROX_ITEMS = 1 << 20         # the frontier's clustered corpus, cut from 8M items
APPROX_BATCH, APPROX_K = 32, 200
CLUSTER_SIGMA = 0.5            # cluster spread over the centroid rms (frontier default)
K10_TILES = 1024
APPROX_METHODS = (
    "MoLBruteForceTopKFused", "MoLBruteForceTopKFusedApprox", "MoLCertTopK4096",
    "MoLTileTopK8", "MoLTileTopK8B512", "MoLNaiveTopK50", "MoLAvgTopK4096",
    "MoLCombTopK50_4096", "MIPSBruteForceTopK",
)
E2E_APPROX_METHODS = ("MoLCertTopK4096", "MoLTileTopK8", "MoLCombTopK50_4096")
INT8_ITEMS = 1 << 22           # the frontier's 4M corpus
INT8_METHODS = ("MoLBruteForceTopKFusedInt8", "MoLBruteForceTopKFusedInt8Approx",
                "MoLCertTopK4096Int8", "MoLTileTopK8B512Int8", "MoLNaiveTopK50")
E2E_INT8_METHODS = ("MoLBruteForceTopKFusedInt8", "MoLCertTopK4096Int8")
FRONTIER_ITEMS = 8_000_000     # the frontier's default corpus, uncut
FRONTIER_STEPS = 150           # its default pre-train
FRONTIER_RUNS = 8              # its default timed calls per method
FRONTIER_INT8_METHODS = ("MoLBruteForceTopKFused", "MoLCertTopK4096", "MoLTileTopK8")
# recall@200 of the JAX package's IVF rows in its own 8M frontier record
# (docs/frontier_8m.json); its MoLIVFTopK128 row is a compile error.
JAX_IVF_RECALL = {"MoLIVFTopK8": 0.1195, "MoLIVFTopK32": 0.2969, "MoLIVFTopK128": None}
# `[data]`: an ML-1M-shaped ratings.dat at full size (GroupLens ML-1M README:
# 1,000,209 ratings of 3,706 movies by 6,040 users, at least 20 each; ids up
# to 3,952). Per-user counts: a lognormal with ML-1M's median 96 and mean
# 165.6, clamped to [20, 2,314].
ML1M_USERS, ML1M_MAX_ID = 6_040, 3_952
ML1M_MEDIAN, ML1M_MEAN, ML1M_MAX_LEN = 96.0, 165.6, 2_314
BMAX_INVALID = (5, 77, 300_000, 777_777)   # mid-corpus valid=0 columns of [K2-bmax]
ML20M_GEOM = (P_Q, P_X, D_P)
# amzn-books-hstu-mol (`rails_tpu_torch/core/config.py`): MoL 8x8x32 (L=64,
# H=128), the 5-core Amazon Books vocabulary, eval and train batch 64.
BOOKS_GEOM = (8, 8, 32)
BOOKS_ITEMS = 695_762
BOOKS_BATCH = 64
BOOKS_INVALID = (5, 77, 300_000, 695_000)  # mid-corpus valid=0 columns of the Books [K2-bmax]
BOOKS_METHODS = ("MoLBruteForceTopKFused", "MoLBruteForceTopKFusedInt8", "MoLCertTopK4096",
                 "MoLCertTopK4096Int8", "MoLTileTopK8", "MoLTileTopK8Int8")
# The bf16 K5 against its plain version: the forward and each gradient within
# this share of its largest value (both round to bf16 at the same points and
# sum in other f32 orders).
K5_BF16_TOL = (2e-2, 3e-2)
# K1's variant instances (bias mode, activation, normalization, concat_ua):
# the bias built in-kernel ("internal"), precomputed in x's dtype raw ("raw")
# or with the -30000 penalty folded in ("penalty", mask_in_bias), or none.
K1_VAR_INSTANCES = {
    "concat_ua": ("internal", "silu", "rel_bias", True),
    "activation none": ("internal", "none", "rel_bias", False),
    "softmax": ("internal", "silu", "softmax_rel_bias", False),
    "softmax, precomputed bias": ("raw", "silu", "softmax_rel_bias", False),
    "mask_in_bias": ("penalty", "silu", "rel_bias", False),
    "no bias": ("none", "silu", "rel_bias", False),
    "concat_ua+softmax": ("internal", "silu", "softmax_rel_bias", True),
}
# K4's variant instances: the ml-20m-hstu-mol `hstu` fields each sets. `[K4-var]`
# checks each instance's kernels, `[train-var]` trains with its flags.
K4_VAR_INSTANCES = {
    "concat_ua": dict(concat_ua=True),
    "activation none": dict(linear_activation="none"),
    "softmax": dict(normalization="softmax_rel_bias"),
    "no bias": dict(enable_relative_attention_bias=False),
    "attention dropout": dict(attn_dropout_rate=0.2),
    "concat_ua+softmax+attention dropout": dict(
        concat_ua=True, normalization="softmax_rel_bias", attn_dropout_rate=0.2),
    "h=4, dqk=dv=64": dict(num_heads=4, dqk=64, dv=64),
}
# Instances of K4's CUDA-core attention backward (`hstu_attn_bwd_kernel`) that
# K4_VAR_INSTANCES does not name: `untouched_hashes` holds their bits and
# profile_k4_bwd.py times them. No phase trains with them.
K4_BWD_INSTANCES = {
    "activation none+attention dropout": dict(linear_activation="none", attn_dropout_rate=0.2),
    "h=4, dqk=dv=64+attention dropout": dict(num_heads=4, dqk=64, dv=64, attn_dropout_rate=0.2),
    "h=5, dqk=dv=16, activation none": dict(num_heads=5, dqk=16, dv=16, linear_activation="none"),
}
# The registry configs this slice ports beyond `[sasrec-*]` and `[dot-*]`'s
# ml-20m-sasrec-mol and ml-20m-hstu-dot: one eval batch each in `[models]`.
MODEL_CONFIGS = ("ml-1m-sasrec-mol", "amzn-books-sasrec-mol", "ml-1m-hstu-dot",
                 "amzn-books-hstu-dot", "ml-1m-sasrec-dot", "ml-20m-sasrec-dot",
                 "amzn-books-sasrec-dot")
ML1M_ITEMS = 3_706             # ML-1M movies with a rating
# ML-20M's genre labels, the categories of `[models-var]`'s categorical table.
NUM_CATEGORIES = 20
# The options no registry config sets, each one train step on ml-20m-hstu-mol
# in `[models-var]` (`configure`'s changes).
VAR_OPTIONS = {
    "in-batch": dict(train=dict(sampling_strategy="in-batch")),
    "BCE": dict(train=dict(loss_module="BCELoss")),
    "BCE with ratings": dict(train=dict(loss_module="BCELossWithRatings")),
    "checkpoint": dict(train=dict(loss_activation_checkpoint=True)),
    "rated": dict(input_preprocessor_type="rated"),
    "combined": dict(input_preprocessor_type="combined"),
    "categorical": dict(embedding_module_type="categorical", num_item_categories=NUM_CATEGORIES,
                        train=dict(pallas_scatter_grad=True)),
    "glu_silu_ln": dict(mol=dict(gating_combination_type="glu_silu_ln")),
    "none": dict(mol=dict(gating_combination_type="none", gating_item_fn=False)),
}
# P1 (encode_probe): the probe's longest default length, the batch of an
# extra kernel-vs-plain check at a second shape, and its --runs cut for the
# script's time.
P1_LENGTH, P1_CHECK_BATCH, P1_RUNS = 192, 64, 2
# P2 (mol_probe): its default corpus and its --runs cut. Kernel vs plain is
# held per score to `mol_probe_error_bound`, derived from one bf16 rounding
# flip of an MLP input (`ops/mol_probe.py`); it must reject each of
# P2_FAULTS, the kernel run on seeded wrong weights.
P2_ITEMS, P2_RUNS = 2_000_000, 2
P2_FAULTS = ("W2 rows 0 and 1 swapped", "logit 5 dropped from the MLP")
# f32 rounding of K2's softmax mixture: K8's bound may sit this far (relative)
# below K2's score when the mixture weights all fall on the largest logit.
F32_MARGIN = 2.0 ** -20


def ptxas_summary(log: str) -> str:
    """`name<dtype,template ints> registers (spills)` per kernel from the
    `-Xptxas -v` build log."""
    out, label = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            name = re.search(r"(serve_proj_kernel|serve_out_kernel|serve_attn_kernel|"
                             r"serve_softmax_kernel|"
                             r"tc_tf32_proj_kernel|tc_tf32_attn_kernel|tc_tf32_out_kernel|"
                             r"tc_tf32_dq_kernel|tc_tf32_dkv_kernel|"
                             r"tc_proj_kernel|tc_attn_kernel|tc_softmax_kernel|tc_out_kernel|"
                             r"tc_bwd_rows_kernel|tc_bwd_dq_kernel|tc_bwd_dkv_kernel|"
                             r"ln_gemm_kernel|ln_stats_kernel|hstu_attn_bwd_rows_kernel|"
                             r"hstu_attn_bwd_cols_kernel|"
                             r"hstu_attn_chunked_kernel|"
                             r"hstu_attn_kernel|"
                             r"softmax_bwd_rows_kernel|softmax_bwd_cols_kernel|"
                             r"hstu_softmax_attn_kernel|mol_probe_kernel|mol_loss_tc_kernel|"
                             r"attn_row_bwd_kernel|mol_scores_kernel|mol_tc_kernel|hash_keep_mask_kernel|"
                             r"adamw_leaves_kernel|mol_loss_fwd_kernel|mol_loss_bwd_kernel|"
                             r"reduce_slots_kernel|count_kernel|scan_kernel|place_kernel|"
                             r"sum_kernel|mol_ub_kernel|mol_bounds_tc_kernel|"
                             r"mol_group_block_max_kernel)", mangled)
            # An int8 instance's first template argument is `signed char` ("Ia");
            # its bf16 query type puts "bfloat16" in the name too.
            tc = bool(name) and name.group(1).startswith("tc_") and "tf32" not in name.group(1)
            dtype = ("int8" if re.search(r"kernelIaL", mangled) else
                     "bf16" if "bfloat16" in mangled or tc else "f32")
            args = [dtype] + re.findall(r"L[ib](\d+)E", mangled)
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


def tensor_core_sass(lib_path) -> dict:
    """HMMA and HGMMA instruction counts of each instance of the tensor-core
    kernels (K1's bf16 kernels with their TRAIN instances, K4's bf16 backward
    kernels, K4's and K1's f32 routes' 3xTF32 kernels, K2's `mol_tc_kernel` and
    K8/K9's `mol_bounds_tc_kernel`) in the
    built library's SASS (`cuobjdump -sass`), by "kernel<int8 if so, template
    ints> (source)". Raises if a kernel is missing or an instance has
    neither."""
    from rails_tpu_torch.ops import _build

    cuobjdump = str(Path(_build.find_nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    sources = {"encode_probe_cu": "encode_probe.cu", "mol_probe_cu": "mol_probe.cu",
               "mol_loss_tc_cu": "mol_loss_tc.cu", "mol_bounds_cu": "mol_bounds.cu",
               "mol_scoring_cu": "mol_scoring.cu", "hstu_block_train_cu": "hstu_block_train.cu",
               "hstu_train_tf32_cu": "hstu_train_tf32.cu",
               "hstu_serve_tf32_cu": "hstu_serve_tf32.cu"}
    counts, label = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            # The digit is the mangled name's length prefix: "tc_" inside a
            # file name (mol_loss_tc_cu) is no kernel.
            m = re.search(r"\d(mol_loss_tc_kernel|mol_bounds_tc_kernel|mol_tc_kernel|"
                          r"serve_[a-z]+_kernel|tc_[a-z0-9_]+?_kernel)"
                          r"(I(a)?\w*?((?:L[ib]\d+E)+)E)?", line)
            src = next((v for k, v in sources.items() if k in line), "hstu_block.cu")
            args = ",".join(["int8"] * bool(m and m.group(3))
                            + (re.findall(r"\d+", m.group(4)) if m and m.group(4) else []))
            label = f"{m.group(1)}{'<' + args + '>' if args else ''} ({src})" if m else None
            if label:
                counts[label] = [0, 0]
        elif label:
            counts[label][0] += len(re.findall(r"\bHMMA\.", line))
            counts[label][1] += len(re.findall(r"\bHGMMA\.", line))
    missing = [k for k in TC_KERNELS + K4_TC_KERNELS + K4_TF32_KERNELS + K1_TF32_KERNELS
               + ("mol_tc_kernel", "mol_bounds_tc_kernel", "mol_loss_tc_kernel")
               if not any(label.startswith(k) for label in counts)]
    empty = [label for label, (hmma, hgmma) in counts.items() if hmma + hgmma == 0]
    if missing or empty:
        raise AssertionError(f"tensor-core kernels missing {missing} or without HMMA/HGMMA {empty}")
    return counts


def host_us(fn, iters: int = 200) -> float:
    """Mean host time of one call of fn in us, `iters` calls enqueued without
    waiting for the card (the host does not wait for it; the device keeps up
    or falls behind)."""
    import time

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / iters


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


def busy_sm_clock_hz(fn, ms: float, busy_ms: float = 300.0) -> float:
    """The SM clock in Hz that `nvidia-smi --query-gpu=clocks.sm` reads while
    fn (one call: about ms) runs back to back on the card for about busy_ms:
    the calls are queued first, so the card is under this load when the
    query runs."""
    import torch

    for _ in range(max(1, min(5000, int(busy_ms / max(ms, 1e-3))))):
        fn()
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0]
    torch.cuda.synchronize()
    return float(mhz) * 1e6


def bound(flops: float, nbytes: float, dtype_name: str, sfu_ops: float = 0.0,
          sm_clock_hz: Optional[float] = None) -> dict:
    """The least time the card could take: the largest of the operations
    over the peak rate for their type, the bytes over the HBM rate and, where
    `sfu_ops` special-function (MUFU: ex2, rcp, tanh) results are needed, those
    over SFU_PER_SM_CLOCK per SM per clock at `sm_clock_hz` (the clock under
    load, `busy_sm_clock_hz`). `dtype_name` "tf32x3" prices f32 products made
    as 3xTF32 on the tensor cores (TF32X3_FLOPS)."""
    import torch

    peak = TF32X3_FLOPS if dtype_name == "tf32x3" else PEAK_FLOPS[dtype_name]
    terms = {"operations": flops / peak * 1e3,
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    if sfu_ops:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        terms["sfu"] = sfu_ops / (SFU_PER_SM_CLOCK * sms * sm_clock_hz) * 1e3
    by = max(terms, key=terms.get)
    return {"bound_ms": terms[by], "bound_by": by}


def mol_sfu_per_pair(l: int, hd: int, mode: str = "full") -> int:
    """MUFU results one (query, item) pair of K2 (or of a P2 `mode`) needs at
    the least, whatever forms a kernel picks: one ex2 for each SiLU v / (1 +
    e^-v), H hidden and L gating ones, and for each of the L softmax exps,
    with every reciprocal on the FMA units (Newton steps). The kernels issue
    more (`mol_scoring_tc.cuh` states its counts)."""
    return {"full": hd + 2 * l, "nosilu": hd + l, "noexp": hd + l, "nomlp": 2 * l,
            "nocombine": 0, "writeonly": 0}[mode]


def mol_bound(fn, ms: float, pairs: int, per_pair_flops: int, nbytes: float,
              dtype_name: str, sfu_per_pair: int) -> dict:
    """`bound` of a MoL scorer over `pairs` (query, item) pairs, its MUFU term
    at the SM clock read while fn (one call: ms) runs, and the device us of
    the scoring kernel in one call (`device_us`, NaN where three profiled
    calls recorded no such kernel: the profiler sometimes misses it)."""
    for _ in range(3):
        kernel = [t[2] for t in device_timeline(fn) if "mol_" in t[1]]
        if kernel:
            break
    device_us = sum(kernel) if kernel else float("nan")
    return {**bound(pairs * per_pair_flops, nbytes, dtype_name, pairs * sfu_per_pair,
                    busy_sm_clock_hz(fn, ms)), "device_us": device_us}


def k1_inputs(b: int, n: int, dtype, device, seed: int = 0, geom: tuple = K1_GEOMS["ml-20m"]):
    """Random K1 operands at a geometry of K1_GEOMS (ML-20M by default):
    ragged lengths, sorted int32 timestamps, the layer's rel-pos slab for
    n <= max_seq_len."""
    import torch

    d, h, dqk, dv, max_seq_len = geom
    g = torch.Generator().manual_seed(seed)
    f = 2 * h * dv + 2 * h * dqk
    lengths = torch.randint(1, n, (b,), generator=g)
    colmask = (torch.arange(n)[None, :] < lengths[:, None]).float()
    ts = torch.cumsum(torch.randint(60, 600_000, (b, n), generator=g), dim=1).to(torch.int32)
    ext = torch.cat([ts, ts[:, n - 1 :]], dim=1)
    pos_w = 0.02 * torch.randn(2 * max_seq_len - 1, generator=g)
    i, j = torch.arange(n)[:, None], torch.arange(n)[None, :]
    args = (
        torch.randn(b, n, d, generator=g).to(dtype),
        colmask,
        (torch.randn(d, f, generator=g) / d ** 0.5).to(dtype),
        (torch.randn(h * dv, d, generator=g) / (h * dv) ** 0.5).to(dtype),
        0.02 * torch.randn(d, generator=g),
        pos_w[j - i + max_seq_len - 1].contiguous(),
        ext.contiguous(),
        0.1 * torch.randn(128, generator=g),
    )
    kw = dict(num_heads=h, dqk=dqk, dv=dv, inv_n=1.0 / max_seq_len, eps=1e-6, num_buckets=128)
    return tuple(a.to(device) for a in args), kw


def stage_split(fn, fma_flops: tuple = ()) -> str:
    """One call of fn under torch.profiler: each device operation's us and
    the instruction its products run on. `fma_flops`, for a run of K1's
    CUDA-core kernels, gives the FLOPs of its GEMM and attention launches in
    launch order (`ln_stats_kernel` has none of note); each of those stages
    then also shows its bound at the CUDA cores' FMA rate and the share of
    that rate it reaches."""
    timeline = device_timeline(fn)
    if not timeline:
        return "not recorded by torch.profiler"
    parts, left = [], list(fma_flops)
    for _, name, us, _ in timeline:
        short = re.search(r"(tc_\w+?_kernel|serve_\w+?_kernel(?:<\d+(?:, \d+)?>)?|ln_gemm_kernel|"
                          r"ln_stats_kernel|hstu_\w*attn\w*_kernel|attn_row_bwd_kernel|"
                          r"softmax_bwd_\w+?_kernel)", name)
        label = short.group(1) if short else name[:40]
        unit = (TF32_INSTRUCTION if label.startswith(("tc_tf32", "serve_")) else
                TC_INSTRUCTION if label.startswith("tc_") else "FFMA (CUDA cores)")
        share = ""
        if left and label != "ln_stats_kernel":
            fma_us = left.pop(0) / PEAK_FLOPS["float32"] * 1e6
            share = f", FMA-rate bound {fma_us:.2f} us, {fma_us / us:.3f} of the rate"
        parts.append(f"{label} {us:.2f} us [{unit}{share}]")
    return " + ".join(parts) + f" = {sum(t[2] for t in timeline):.2f} us device"


K1_TF32_ROUTE = "3xTF32 tensor cores"


def k1_route(dtype, d: int, n: int, h: int, dqk: int, dv: int, activation: str,
             softmax: bool = False) -> str:
    """The route `fused_hstu_block` takes for these operands."""
    from rails_tpu_torch.ops import hstu_block as hb

    if hb.tf32_block(dtype, d, n, h, dqk, dv, activation, softmax):
        return K1_TF32_ROUTE
    if hb.tc_block(dtype, d, h, dqk, dv, activation):
        return "bf16 tensor cores"
    return "CUDA cores"


def tf32_launched(call, route: str):
    """call() (one K1 block), checking that it launched each of the f32
    route's three stages once on that route and none off it."""
    from rails_tpu_torch.ops import hstu_block as hb

    stages = (hb.tf32_project, hb.tf32_attention, hb.tf32_out_gemm)
    before = [f.launches for f in stages]
    out = call()
    made = [f.launches - c for f, c in zip(stages, before)]
    if made != [int(route == K1_TF32_ROUTE)] * 3:
        raise AssertionError(f"K1 on the {route} route launched the f32 stages {made} times")
    return out


def bound_terms(flops: float, nbytes: float, route: str) -> str:
    """The bound's terms spelled out: the operations at 3xTF32's 165 TFLOP/s
    and at the CUDA cores' 67 (the f32 route), or at the route's own peak,
    and the bytes at HBM's rate."""
    if route == K1_TF32_ROUTE:
        ops = (f"operations {flops / TF32X3_FLOPS * 1e3:.4f} ms at 3xTF32's 165 TFLOP/s, "
               f"{flops / PEAK_FLOPS['float32'] * 1e3:.4f} at 67")
    else:
        peak = PEAK_FLOPS["bfloat16" if route.startswith("bf16") else "float32"]
        ops = f"operations {flops / peak * 1e3:.4f} ms"
    return f"{ops}; bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms"


def check_k1(b: int, n: int, dtype, device, geom_name: str = "ml-20m",
             normalization: str = "rel_bias") -> dict:
    """K1 against its plain version at a geometry of K1_GEOMS; kernel, plain
    and bound ms, and one call's device time per stage."""
    import torch

    from rails_tpu_torch.ops.hstu_block import fused_hstu_block, fused_hstu_block_reference

    geom = K1_GEOMS[geom_name]
    d, h, dqk, dv, _ = geom
    args, kw = k1_inputs(b, n, dtype, device, geom=geom)
    kw["normalization"] = normalization
    route = k1_route(dtype, d, n, h, dqk, dv, "silu", normalization == "softmax_rel_bias")
    got = tf32_launched(lambda: fused_hstu_block(*args, **kw), route)
    ref = fused_hstu_block_reference(*args, **kw)
    rtol, atol = K1_TOL[str(dtype).split(".")[-1]]
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
    err = (got.float() - ref.float()).abs().max().item()
    ms = cuda_ms(lambda: fused_hstu_block(*args, **kw))
    plain_ms = cuda_ms(lambda: fused_hstu_block_reference(*args, **kw))
    dt = str(dtype)[6:]
    softmax = normalization == "softmax_rel_bias"
    flops = k1_variant_flops(b, n, softmax, h * dv, geom=geom)
    nbytes = k1_variant_bytes(b, n, args[0].element_size(), h * dv, "internal", geom=geom)
    bd = bound(flops, nbytes, "tf32x3" if route == K1_TF32_ROUTE else dt)
    label = "" if geom_name == "ml-20m" else f" {geom_name}"
    print(f"[K1]{label} {dt} B={b} n={n} D={d} h={h} dqk={dqk} dv={dv}"
          f"{' softmax' if softmax else ''} ({route}): max|err| {err:.3e} (rtol {rtol}, atol "
          f"{atol}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']}; {bound_terms(flops, nbytes, route)}); "
          f"stages {stage_split(lambda: fused_hstu_block(*args, **kw))}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None}


def check_k1_stages(b: int, n: int, device) -> dict:
    """K1's three bf16 tensor-core stages at ML-20M widths, each against its
    plain stage version on the same inputs (the attention and the output GEMM
    fed the plain stages' outputs): error, kernel, plain and bound ms. The
    attention twice: pointwise and softmax. Returns the four by name."""
    import torch

    from rails_tpu_torch.ops import hstu_block as hb

    d, h, dqk, dv, _ = K1_GEOMS["ml-20m"]
    rtol, atol = K1_TOL["bfloat16"]
    (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw), kw = k1_inputs(
        b, n, torch.bfloat16, device)
    layout = dict(num_heads=h, dqk=dqk, dv=dv)
    m, hv, width = b * n, h * dv, hb.vqk_layout(h, dqk, dv)[2]
    out = {}

    def report(name, got, want, kernel, plain, flops, nbytes):
        err = 0.0
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_.float(), w_.float(), rtol=rtol, atol=atol)
            err = max(err, (g_.float() - w_.float()).abs().max().item())
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, iters=3, warmup=1)
        bd = bound(flops, nbytes, "bfloat16")
        print(f"[K1-stage] {name} bf16 B={b} n={n}: max|err| {err:.3e} (rtol {rtol}, atol "
              f"{atol}); kernel {ms:.3f} ms [{TC_INSTRUCTION}], plain {plain_ms:.3f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None}

    for softmax in (False, True):
        pkw = dict(layout, inv_n=kw["inv_n"], softmax=softmax)
        u_p, v_p, q_p, k_p = hb.project_reference(x, uvqk, **pkw)
        vqk_p = hb.pack_vqk(v_p, q_p, k_p, **layout).contiguous()
        if not softmax:
            report("project", hb.project(x, uvqk, **pkw), (u_p, vqk_p),
                   lambda: hb.project(x, uvqk, **pkw), lambda: hb.project_reference(x, uvqk, **pkw),
                   2 * m * d * 4 * hv, 2 * (m * d + d * 4 * hv) + 4 * m * hv + 2 * m * width)
        akw = dict(layout, softmax=softmax)
        args = (u_p.contiguous(), vqk_p, colmask, rel_pos, ext, tsw)

        def plain(akw=akw):
            return hb.attention_oinput_reference(u_p, v_p, q_p, k_p, colmask, rel_pos, ext, tsw,
                                                 **akw)

        pairs = n * (n + 1) // 2
        flops = (b * (2 * n * n * h * dqk + 2 * pairs * h * dv) if softmax
                 else b * h * pairs * 2 * (dqk + dv))
        report("attention softmax" if softmax else "attention",
               (hb.attention_oinput(*args, **akw),), (plain(),),
               lambda args=args, akw=akw: hb.attention_oinput(*args, **akw), plain, flops,
               2 * m * width + 4 * m * hv + 2 * m * hv + 4 * (2 * m + b + n * n + 128))
        if not softmax:
            o_ref = plain()
    report("out_gemm", (hb.out_gemm(o_ref, o_kernel, o_bias, x),),
           (hb.out_gemm_reference(o_ref, o_kernel, o_bias, x),),
           lambda: hb.out_gemm(o_ref, o_kernel, o_bias, x),
           lambda: hb.out_gemm_reference(o_ref, o_kernel, o_bias, x), 2 * m * hv * d,
           2 * (m * hv + hv * d + 2 * m * d) + 4 * d)
    return out


def check_k1_tf32_stages(b: int, n: int, device) -> dict:
    """K1's f32 route (3xTF32, csrc/hstu_serve_tf32.cuh) at ML-20M widths,
    stage by stage on the same inputs: the projection, the pointwise and the
    softmax attention over the plain y, the output GEMM over the plain y and
    attn. Each twice, bit-equal, within K1_TF32_STAGE_TOL of its largest
    value; kernel and plain ms, one call's device us, and the bound with its
    terms (operations at 3xTF32's 165 TFLOP/s and the CUDA cores' 67, bytes:
    each input read once, each output written once). Returns them by name."""
    import torch

    from rails_tpu_torch.ops import hstu_block as hb

    d, h, dqk, dv, _ = K1_GEOMS["ml-20m"]
    (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw), kw = k1_inputs(
        b, n, torch.float32, device)
    lay = dict(num_heads=h, dqk=dqk, dv=dv)
    akw = dict(lay, inv_n=kw["inv_n"])
    m, hdv, hq = b * n, h * dv, h * dqk
    f, causal = 2 * hdv + 2 * hq, n * (n + 1) // 2
    y = hb.tf32_project_reference(x, uvqk)
    attn = hb.tf32_attention_reference(y, colmask, rel_pos, ext, tsw, **akw)
    att_bytes = 4 * (m * (hdv + 2 * hq) + m * hdv + n * n + 128 + b * (n + 1) + m)
    cases = (
        ("project", lambda: hb.tf32_project(x, uvqk, **lay),
         lambda: hb.tf32_project_reference(x, uvqk), 2 * m * d * f, 4 * (m * d + d * f + m * f)),
        ("attention", lambda: hb.tf32_attention(y, colmask, rel_pos, ext, tsw, **akw),
         lambda: hb.tf32_attention_reference(y, colmask, rel_pos, ext, tsw, **akw),
         2 * b * h * causal * (dqk + dv), att_bytes),
        ("attention softmax",
         lambda: hb.tf32_attention(y, colmask, rel_pos, ext, tsw, **akw, softmax=True),
         lambda: hb.tf32_attention_reference(y, colmask, rel_pos, ext, tsw, **akw, softmax=True),
         b * (2 * n * n * hq + 2 * causal * hdv), att_bytes),
        ("out_gemm", lambda: hb.tf32_out_gemm(x, y, attn, o_kernel, o_bias, **lay),
         lambda: hb.tf32_out_gemm_reference(x, y, attn, o_kernel, o_bias, num_heads=h, dv=dv),
         2 * m * hdv * d, 4 * (2 * m * hdv + hdv * d + d + 2 * m * d)),
    )
    out = {}
    for name, kernel, plain, flops, nbytes in cases:
        got, again, want = kernel(), kernel(), plain()
        share = rel_err(got, want)
        if not torch.equal(got, again):
            raise AssertionError(f"[K1-stage] {name} f32: two calls differ")
        if share > K1_TF32_STAGE_TOL:
            raise AssertionError(f"[K1-stage] {name} f32 outside {K1_TF32_STAGE_TOL}: {share}")
        err = (got - want).abs().max().item()
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, iters=3, warmup=1)
        bd = bound(flops, nbytes, "tf32x3")
        print(f"[K1-stage] {name} f32 B={b} n={n}: max|err|/max|plain| {share:.2e} (<= "
              f"{K1_TF32_STAGE_TOL}), max|err| {err:.3e}, two calls bit-equal; kernel {ms:.3f} "
              f"ms [{TF32_INSTRUCTION}], plain {plain_ms:.3f} ms, bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']}; {bound_terms(flops, nbytes, K1_TF32_ROUTE)}); "
              f"{stage_split(kernel)}")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None}
    return out


def digest(*tensors) -> str:
    """sha256 prefix of the tensors' bytes (None skipped)."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def untouched_hashes(device) -> dict:
    """`[K1-hash]`: sha256 prefixes of the outputs K1's f32 route leaves
    alone, on operands from fixed seeds: bf16 K1 and each bf16 variant
    instance; the K1 instances off both routes (activation none, also at B*n
    = 111 rows, f32 n = 513, h = 4 with dqk = dv = 64, D = 273, and the
    chunked attention's n = 285 at dqk = dv = 64 and dqk = dv = 96); K4's forward
    and attention backward (f32 on its 3xTF32 route, its off-route softmax,
    activation none and h = 4, dqk = dv = 64 instances, and bf16, also at h =
    4, dqk = dv = 64 and activation none; each of K4_BWD_INSTANCES in both
    dtypes; the default block in f32 at n = 513); P1's modes in f32 and bf16.
    Only calls an
    older tree has: the lines of a tree unpacked by `git archive` (with this
    file copied in) compare bit for bit. Returns them by name."""
    import numpy as np
    import torch

    from rails_tpu_torch.cli import encode_probe as p1cli
    from rails_tpu_torch.ops import encode_probe as ep
    from rails_tpu_torch.ops import hstu_block_train as hbt
    from rails_tpu_torch.ops.hstu_block import fused_hstu_block, ln

    f32, bf16 = torch.float32, torch.bfloat16
    out = {}
    b, n = 64, MAX_SEQ_LEN
    args, kw = k1_inputs(b, n, bf16, device)
    out["K1 bf16"] = digest(fused_hstu_block(*args, **kw))
    for inst in K1_VAR_INSTANCES:
        vargs, vkw = k1_variant_inputs(b, n, bf16, device, inst)
        out[f"K1 bf16 {inst}"] = digest(fused_hstu_block(**vargs, **vkw))
    vargs, vkw = k1_variant_inputs(b, n, f32, device, "activation none")
    out["K1 f32 activation none"] = digest(fused_hstu_block(**vargs, **vkw))
    # Activation none at a batch whose B*n rows end inside a GEMM row tile.
    for dtype in (f32, bf16):
        vargs, vkw = k1_variant_inputs(3, 37, dtype, device, "activation none")
        out[f"K1 {'f32' if dtype == f32 else 'bf16'} activation none, B*n=111"] = digest(
            fused_hstu_block(**vargs, **vkw))
    # Off the f32 route: past its length, and wider heads; off both routes: D
    # past 272 (ragged K of the projection, ragged N of the output GEMM), and
    # the heads whose attention runs hstu_attn_chunked_kernel: staging past a
    # block's shared memory at n = 285, and dv past 64.
    for label, geom, dtypes in (("n=513", (D, H, DQK, DV, 513), (f32,)),
                                ("h=4, dqk=dv=64", (D, 4, 64, 64, n), (f32, bf16)),
                                ("D=273", (273, H, DQK, DV, n), (f32, bf16)),
                                ("n=285, h=4, dqk=dv=64", (D, 4, 64, 64, 285), (f32, bf16)),
                                ("h=2, dqk=dv=96", (D, 2, 96, 96, 128), (f32, bf16))):
        for dtype in dtypes:
            gargs, gkw = k1_inputs(8, geom[4], dtype, device, geom=geom)
            out[f"K1 {'f32' if dtype == f32 else 'bf16'} {label}"] = digest(
                fused_hstu_block(*gargs, **gkw))
    seed = 987_654_321
    # K4's CUDA-core attention backward also at bf16 activation none, each of
    # K4_BWD_INSTANCES, and f32 n = 513 (narrow heads past the f32 route; the
    # line's name ends in its n).
    k4_cases = [(None, f32, n), ("softmax", f32, n), ("activation none", f32, n),
                ("h=4, dqk=dv=64", f32, n), (None, bf16, n), ("h=4, dqk=dv=64", bf16, n),
                ("activation none", bf16, n)]
    k4_cases += [(inst, dtype, n) for inst in K4_BWD_INSTANCES for dtype in (f32, bf16)]
    k4_cases.append((None, f32, 513))
    for inst, dtype, kn in k4_cases:
        meta, has_bias = k4_meta(inst, kn)
        geom = (D, meta.num_heads, meta.dqk, meta.dv, kn)
        (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw), _ = k1_inputs(
            32, kn, dtype, device, seed=3, geom=geom)
        x = x * colmask[..., None].to(dtype)
        if not has_bias:
            rel_pos = ext = tsw = None
        fwd, attn = hbt.fused_train_block_forward(x, colmask, uvqk, o_kernel, o_bias, rel_pos,
                                                  ext, tsw, seed, meta)
        z = ln(x.float(), meta.eps).to(dtype).float() @ uvqk.float()
        y = (z * torch.sigmoid(z) if meta.activation == "silu" else z).to(dtype)
        g = torch.Generator(device=device).manual_seed(13)
        d_o = torch.randn(32, kn, meta.o_width, generator=g, device=device).to(dtype)
        bwd = hbt.attn_backward(y, d_o, None if dtype == bf16 else attn, colmask, rel_pos, ext,
                                tsw, meta, seed)
        name = f"K4 {inst or 'default'} {str(dtype)[6:]}" + (f" n={kn}" if kn != n else "")
        out[f"{name} forward"], out[f"{name} attention backward"] = digest(fwd, attn), digest(*bwd)
    for dtype in (f32, bf16):
        d = p1cli.probe_data(16, P1_LENGTH, 1, np.random.default_rng(2), device)
        pargs = (d["x0"].to(dtype), d["colmask"], d["uvqk"][0].to(dtype), d["ow"][0].to(dtype),
                 d["ob"][0], d["rel_pos"], d["ext"], d["tsw"])
        pkw = dict(num_heads=H, dqk=DQK, dv=DV, inv_n=1.0 / P1_LENGTH)
        for mode in ep.MODES:
            out[f"P1 {mode} {str(dtype)[6:]}"] = digest(ep.encode_probe_block(mode, *pargs, **pkw))
    for name, value in out.items():
        print(f"[K1-hash] {name}: {value}")
    return out


def chunked_hashes(device) -> dict:
    """`[K1-hash]` lines of K1 at n = 1,024 (ML-20M's heads, activation none,
    f32 and bf16), a length only `hstu_attn_chunked_kernel` admits, so that
    a later tree is held to them bit for bit (an older tree refuses them)."""
    import torch

    from rails_tpu_torch.ops.hstu_block import fused_hstu_block

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        args, kw = k1_inputs(4, 1_024, dtype, device, geom=(D, H, DQK, DV, 1_024))
        out[f"K1 {str(dtype)[6:]} activation none, n=1024"] = digest(
            fused_hstu_block(*args, **kw, activation="none"))
    for name, value in out.items():
        print(f"[K1-hash] {name}: {value}")
    return out


def preprocessor_hashes(device) -> dict:
    """`[K1-hash]` lines of the instances that moved onto the tensor cores
    for the rated (D = 264) and combined (n = 422) preprocessors, so that a
    later tree is held to them bit for bit: K1 in f32 (3xTF32) and bf16 at
    B = 8, and K4's f32 forward and attention backward at B = 4, the
    combined one on the 32-row attention blocks."""
    import torch

    from rails_tpu_torch.ops import hstu_block_train as hbt
    from rails_tpu_torch.ops.hstu_block import fused_hstu_block, ln

    f32, bf16 = torch.float32, torch.bfloat16
    out = {}
    for geom in ("rated", "combined"):
        g = K1_GEOMS[geom]
        for dtype in (f32, bf16):
            args, kw = k1_inputs(8, g[4], dtype, device, geom=g)
            out[f"K1 {str(dtype)[6:]} {geom}"] = digest(fused_hstu_block(*args, **kw))
        meta, _ = k4_meta(None, g[4])
        (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw), _ = k1_inputs(
            4, g[4], f32, device, seed=3, geom=g)
        x = x * colmask[..., None]
        seed = 987_654_321
        fwd, attn = hbt.fused_train_block_forward(x, colmask, uvqk, o_kernel, o_bias, rel_pos,
                                                  ext, tsw, seed, meta)
        z = ln(x, meta.eps) @ uvqk
        y = z * torch.sigmoid(z)
        g_ = torch.Generator(device=device).manual_seed(13)
        d_o = torch.randn(4, g[4], meta.o_width, generator=g_, device=device)
        bwd = hbt.attn_backward(y, d_o, attn, colmask, rel_pos, ext, tsw, meta, seed)
        out[f"K4 f32 {geom} forward"] = digest(fwd, attn)
        out[f"K4 f32 {geom} attention backward"] = digest(*bwd)
    for name, value in out.items():
        print(f"[K1-hash] {name}: {value}")
    return out


def id_overlap(ia, ib) -> float:
    """Mean share of each row of ia (B, k) that also appears in that row of ib."""
    return (ia[:, :, None] == ib[:, None, :]).any(dim=2).float().mean().item()


def topk_overlap(a, b, k: int) -> float:
    return id_overlap(a.topk(k, dim=1).indices, b.topk(k, dim=1).indices)


def bf16_contract(got, ref, what: str) -> str:
    """K2's contract where its MLP rounds to bf16: the top-1 on >= 99% of
    rows and top-200 overlap >= 0.994 with the plain version."""
    top1 = (got.argmax(dim=1) == ref.argmax(dim=1)).float().mean().item()
    overlap = topk_overlap(got, ref, 200)
    verdict = f"top-1 agree {top1:.4f} (>= 0.99), top-200 overlap {overlap:.4f} (>= 0.994)"
    if top1 < 0.99 or overlap < 0.994:
        raise AssertionError(f"{what} outside K2's bf16 contract: {verdict}")
    return verdict


def quantized(args: tuple) -> tuple:
    """K2's operands (q, qp, items, ip, w, T) with the tables quantized to
    int8 by the port's quantize_fused_tables, the scales appended."""
    from rails_tpu_torch.ops.mol_scoring import FusedCorpusTables, quantize_fused_tables

    q, qp, items, ip, w, t = args
    ft = quantize_fused_tables(FusedCorpusTables(items, ip, items.shape[-1]))
    return (q, qp, ft.item_comp_t, ft.item_partial_t, w, t, ft.comp_scale, ft.partial_scale)


def table_bytes(args: tuple) -> int:
    """Bytes of K2's tables (and an int8 table's scales) and its queries."""
    q, items, ip = args[0], args[2], args[3]
    scales = sum(4 * a.numel() for a in args[6:8])
    return (q.numel() * q.element_size() + items.numel() * items.element_size()
            + ip.numel() * ip.element_size() + scales)


def mol_route(geom: tuple, dtype) -> str:
    """The route K2, K10 and P2 take for tables of `dtype` at `geom`."""
    from rails_tpu_torch.ops import mol_scoring

    route = getattr(mol_scoring, "tc_route", None)     # absent on a tree before it
    return "tensor cores" if route is not None and route(dtype, *geom, 128) else "CUDA cores"


def bounds_route(geom: tuple, dtype) -> str:
    """The route K8 and K9 take for tables of `dtype` at `geom`."""
    from rails_tpu_torch.ops import mol_scoring

    route = getattr(mol_scoring, "bounds_tc_route", None)   # absent on a tree before it
    return "tensor cores" if route is not None and route(dtype, *geom) else "CUDA cores"


def tc_launched(fn, call):
    """call()'s result and the tensor-core launches of wrapper fn it made."""
    before = getattr(fn, "tc_launches", 0)
    out = call()
    return out, getattr(fn, "tc_launches", 0) - before


def check_k2(b: int, x: int, kind: str, device, geom: tuple = ML20M_GEOM,
             plain: bool = True) -> dict:
    """K2 at B x X over f32, bf16 or int8 tables (bf16 ones quantized), MoL
    `geom` = (P_Q, P_X, d_P); without `plain`, no plain version (its check,
    error and time NaN), for corpora whose plain scores do not fit."""
    import torch

    from rails_tpu_torch.ops.mol_scoring import fused_mol_scores_t, fused_mol_scores_t_reference

    args = bound_inputs(b, x, torch.float32 if kind == "float32" else torch.bfloat16, device,
                        seed=1, geom=geom)
    if kind == "int8":
        args = quantized(args)
    err, plain_ms, verdict = float("nan"), float("nan"), "no plain run"
    _, tc = tc_launched(fused_mol_scores_t, lambda: fused_mol_scores_t(*args))
    if tc != (mol_route(geom, args[2].dtype) == "tensor cores"):
        raise AssertionError(f"K2 {kind}: {tc} tensor-core launches off its route")
    if plain:
        got = fused_mol_scores_t(*args)[:, :x]
        ref = fused_mol_scores_t_reference(*args)[:, :x]
        err = (got - ref).abs().max().item()
        if kind == "float32":
            rtol, atol = K2_TOL_F32
            torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
            verdict = f"rtol {rtol}, atol {atol}"
        else:
            verdict = bf16_contract(got, ref, f"K2 {kind}")
        del got, ref
        plain_ms = cuda_ms(lambda: fused_mol_scores_t_reference(*args), iters=3, warmup=1)
    ms = cuda_ms(lambda: fused_mol_scores_t(*args))
    p_q, p_x, d_p = geom
    l, hd = p_q * p_x, 128
    nbytes = table_bytes(args) + 4 * (b * l + 2 * l * hd + hd + l) + 4 * b * args[2].shape[-1]
    # Per pair the logits and the qi MLP. The int8 path's products and MLP run
    # in bf16, so its peak is bf16's.
    bd = mol_bound(lambda: fused_mol_scores_t(*args), ms, b * x, 2 * l * d_p + 4 * l * hd,
                   nbytes, "float32" if kind == "float32" else "bfloat16",
                   mol_sfu_per_pair(l, hd))
    print(f"[K2] {kind} tables B={b} X={x} MoL {p_q}x{p_x}x{d_p}, "
          f"{mol_route(geom, args[2].dtype)} (.tc_launches +{tc} a call): max|err| {err:.3e} "
          f"({verdict}); kernel {ms:.3f} "
          f"ms, device {bd['device_us']:.2f} us, plain {plain_ms:.3f} ms, bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None}


def serving_setup(compute_dtype, device, n_batches: int,
                  top_k_method: str = "MoLBruteForceTopKFused", overrides: tuple = ()):
    """The ml-20m-hstu-mol model (seeded random weights), its eval state for
    `top_k_method` (by default the exact fused one), the eval step and
    length-sorted ML-20M-shaped batches, each truncated to its 64-bucket.
    `overrides` are `section.field=value` strings, applied as the CLIs'
    `--set` applies them."""
    import torch

    from rails_tpu_torch.core.config import get_experiment_config
    from rails_tpu_torch.data.datasets import SequenceDataset, generate_synthetic_sequences
    from rails_tpu_torch.data.features import serving_pad_length, truncate_features
    from rails_tpu_torch.models.encoder import SequentialRecommender
    from rails_tpu_torch.train.evaluation import get_eval_state, make_eval_step_fn

    from rails_tpu_torch.cli.train import apply_override

    bf16 = compute_dtype == torch.bfloat16
    cfg = get_experiment_config("ml-20m-hstu-mol")
    for dotted in overrides:
        cfg = apply_override(cfg, *dotted.split("=", 1))
    cfg = cfg.replace(
        hstu=cfg.hstu.replace(fused_inference=True),
        train=cfg.train.replace(main_module_bf16=bf16, eval_bf16=bf16),
    )
    model = SequentialRecommender(
        cfg, NUM_ITEMS, compute_dtype=compute_dtype, device=device,
        generator=torch.Generator().manual_seed(0),
    )
    es = get_eval_state(
        model, np.arange(1, NUM_ITEMS + 1, dtype=np.int32), top_k_method,
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


def kernel_counters() -> dict:
    """Every launch counter of the port by its summary name: (wrapper,
    attribute). A variant's launches (int8 tables, K2's blockmax) count on its
    own attribute as well as on `launches`."""
    from rails_tpu_torch.ops import (
        encode_probe,
        hash_dropout,
        hstu_block,
        hstu_block_train,
        mol_loss_train,
        mol_probe,
        mol_scoring,
        scatter_add,
    )
    from rails_tpu_torch.train import fused_adamw

    wrappers = {
        "K1": hstu_block.fused_hstu_block, "K2": mol_scoring.fused_mol_scores_t,
        "K3": hash_dropout.hash_keep_mask,
        "K4 fwd": hstu_block_train.fused_train_block_forward,
        "K4 bwd": hstu_block_train.attn_backward,
        "K5 fwd": mol_loss_train.fused_mol_loss_forward,
        "K5 bwd": mol_loss_train.fused_mol_loss_backward,
        "K6": scatter_add.scatter_add_rows, "K7": fused_adamw.adamw_update_leaves,
        "K8": mol_scoring.fused_mol_ub_t, "K9": mol_scoring.fused_mol_group_block_max,
        "K10": mol_scoring.fused_mol_scores_tiles,
        "P1": encode_probe.encode_probe_block, "P2": mol_probe.mol_probe_scores,
        "K1 proj": hstu_block.project, "K1 attn": hstu_block.attention_oinput,
        "K1 out": hstu_block.out_gemm,
        **dict(zip(K1_TF32_STAGES, (hstu_block.tf32_project, hstu_block.tf32_attention,
                                    hstu_block.tf32_out_gemm))),
        "K4 attn": hstu_block_train.train_attention_oinput,
        "K4 bwd rows": hstu_block_train.attn_bwd_rows, "K4 bwd dq": hstu_block_train.attn_bwd_dq,
        "K4 bwd dkv": hstu_block_train.attn_bwd_dkv,
        **dict(zip(K4_TF32_STAGES, (
            hstu_block_train.tf32_project, hstu_block_train.tf32_attention,
            hstu_block_train.tf32_out_gemm, hstu_block_train.tf32_bwd_rows,
            hstu_block_train.tf32_bwd_dq, hstu_block_train.tf32_bwd_dkv))),
    }
    counters = {name: (fn, "launches") for name, fn in wrappers.items()}
    counters["K2-bmax"] = (mol_scoring.fused_mol_scores_t, "blockmax_launches")
    counters["K1 f32 softmax"] = (hstu_block.tf32_attention, "softmax_launches")
    for k in ("K2", "K8", "K9", "K10"):
        counters[f"{k}-int8"] = (wrappers[k], "int8_launches")
    for k in ("K2", "K8", "K9", "K10", "P2", "K4 fwd", "K4 bwd", "K5 fwd", "K5 bwd"):
        counters[f"{k}-tc"] = (wrappers[k], "tc_launches")
    for k in ("K4 fwd", "K4 bwd", "K5 fwd", "K5 bwd"):
        counters[f"{k} (bf16)"] = (wrappers[k], "bf16_launches")
    return counters


def k4_wrappers() -> dict:
    from rails_tpu_torch.ops import hstu_block_train

    return {"K4 fwd": hstu_block_train.fused_train_block_forward,
            "K4 bwd": hstu_block_train.attn_backward}


def reset_launches() -> None:
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)
    for fn in k4_wrappers().values():
        fn.variant_launches.clear()


def launch_counts() -> dict:
    """Every counter of `kernel_counters`, and K4's launches per variant
    other than the default as "K4 fwd [variant]" and "K4 bwd [variant]"."""
    counts = {name: getattr(fn, attr) for name, (fn, attr) in kernel_counters().items()}
    for name, fn in k4_wrappers().items():
        counts.update({f"{name} [{v}]": c for v, c in fn.variant_launches.items()})
    return counts


def check_tc_route(counts: dict, what: str) -> None:
    """Every launch of K2, K8, K9 and K10 in `counts` took the tensor-core
    route: the serving paths build bf16 and int8 tables at registry widths
    (no f32 tables), so their `.tc_launches` equal them."""
    for k in ("K2", "K8", "K9", "K10"):
        if counts.get(f"{k}-tc", 0) != counts.get(k, 0):
            raise AssertionError(f"{what}: {counts.get(k, 0)} {k} launches, "
                                 f"{counts.get(f'{k}-tc', 0)} of them on the tensor cores")


def k4_variant(cfg) -> str:
    """The K4 variant name (`variant_name`) a config's fused train step runs."""
    from rails_tpu_torch.models.hstu import train_block_meta
    from rails_tpu_torch.ops.hstu_block_train import variant_name

    return variant_name(train_block_meta(cfg.hstu, cfg.max_seq_len_padded),
                        cfg.hstu.enable_relative_attention_bias)


@contextlib.contextmanager
def plain_kernels():
    """The serving and training steps with every kernel call bound to its
    plain version, for comparison only; the launch counters must not move."""
    from unittest import mock

    from rails_tpu_torch.index import top_k
    from rails_tpu_torch.models import hstu
    from rails_tpu_torch.ops import (
        hash_dropout,
        hstu_block,
        hstu_block_train,
        mol_loss_train,
        mol_scoring,
        scatter_add,
    )
    from rails_tpu_torch.train import fused_adamw

    before = launch_counts()
    with mock.patch.object(hstu, "fused_hstu_block", hstu_block.fused_hstu_block_reference), \
            mock.patch.object(top_k, "fused_mol_scores_t",
                              mol_scoring.fused_mol_scores_t_reference), \
            mock.patch.object(top_k, "fused_mol_ub_t", mol_scoring.fused_mol_ub_t_reference), \
            mock.patch.object(top_k, "fused_mol_group_block_max",
                              mol_scoring.fused_mol_group_block_max_reference), \
            mock.patch.object(top_k, "fused_mol_scores_tiles",
                              mol_scoring.fused_mol_scores_tiles_reference), \
            mock.patch.object(hstu_block_train, "fused_train_block_forward",
                              hstu_block_train.fused_train_block_forward_reference), \
            mock.patch.object(hstu_block_train, "attn_backward",
                              hstu_block_train.attn_backward_reference), \
            mock.patch.object(hstu_block_train, "hash_keep_mask",
                              hash_dropout.hash_keep_mask_reference), \
            mock.patch.object(fused_adamw, "adamw_update_leaves",
                              fused_adamw.adamw_update_leaves_reference), \
            mock.patch.object(mol_loss_train, "fused_mol_loss_forward",
                              mol_loss_train.fused_mol_loss_forward_reference), \
            mock.patch.object(mol_loss_train, "fused_mol_loss_backward",
                              mol_loss_train.fused_mol_loss_backward_reference), \
            mock.patch.object(scatter_add, "scatter_add_rows",
                              scatter_add.scatter_add_rows_reference):
        yield
    if launch_counts() != before:
        raise AssertionError("the plain path launched a kernel")


def check_outputs(outs, batches, k: int = 120, num_items: int = NUM_ITEMS) -> None:
    import torch

    for (ranks, ids, scores), (f, _) in zip(outs, batches):
        b = f.ids.shape[0]
        assert ranks.shape == (b,) and ids.shape == (b, k) and scores.shape == (b, k)
        assert bool(torch.isfinite(scores).all()), "non-finite scores"
        assert bool(((ids >= 1) & (ids <= num_items)).all()), "ids outside the corpus"
        assert bool((scores[:, 1:] <= scores[:, :-1]).all()), "scores not sorted"
        assert bool((((ranks >= 1) & (ranks <= k)) | (ranks == 1001)).all()), "bad ranks"


def end_to_end(device, name: str, smi: str, n_batches: int = 3) -> dict:
    """bf16 (the served path, `bench.py`'s settings) and f32: the kernel path
    with its launch counts and times, against the same step through the plain
    versions on the card; then both bf16 paths against the f32 plain path.
    Returns each run's launch counts by dtype name."""
    import torch

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
        reset_launches()
        outs_k, ms = run_batches(serve, batches)
        counts = {k: v for k, v in launch_counts().items()
                  if k in ("K1", "K2", "K2-tc", "K1 f32 softmax") + K1_STAGES + K1_TF32_STAGES}
        bf16 = dtype == torch.bfloat16
        # bf16: K1's bf16 tensor-core stages; f32: its 3xTF32 stages (the
        # pointwise attention) and the CUDA-core K2 on f32 tables.
        stages, stages32 = (counts["K1"], 0) if bf16 else (0, counts["K1"])
        if (counts["K1"] != model.cfg.hstu.num_blocks * len(batches) or counts["K2"] < len(batches)
                or any(counts[k] != stages for k in K1_STAGES)
                or any(counts[k] != stages32 for k in K1_TF32_STAGES)
                or counts["K1 f32 softmax"] != 0
                or counts["K2-tc"] != (counts["K2"] if bf16 else 0)):
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
    return launches


def check_k3(device) -> dict:
    """The o_input keep mask of one ml-20m layer, bit-equal to its plain version."""
    import torch

    from rails_tpu_torch.ops.hash_dropout import hash_keep_mask, hash_keep_mask_reference

    shape, rate, seed0 = (TRAIN_BATCH, MAX_SEQ_LEN, H * DV), 0.2, -1_234_567_891
    got = hash_keep_mask(*shape, seed0, rate, device)
    ref = hash_keep_mask_reference(*shape, seed0, rate, device)
    if not torch.equal(got, ref):
        raise AssertionError(f"K3 differs from its plain version in {(got != ref).sum().item()} bits")
    err = (got - ref).abs().max().item()
    kept = (got > 0).float().mean().item()
    ms = cuda_ms(lambda: hash_keep_mask(*shape, seed0, rate, device))
    plain_ms = cuda_ms(lambda: hash_keep_mask_reference(*shape, seed0, rate, device))
    bd = bound(0, 4 * got.numel(), "float32")
    print(f"[K3] o_input mask {tuple(shape)} rate {rate}: bit-equal to the plain version, "
          f"kept {kept:.4f}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None}


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def k4_meta(instance: Optional[str], max_seq_len: int = MAX_SEQ_LEN) -> tuple:
    """The BlockMeta of ml-20m-hstu-mol's train block with the fields of one
    of K4_VAR_INSTANCES or K4_BWD_INSTANCES (None: the default block) at
    `max_seq_len`, and whether it has the bias."""
    from rails_tpu_torch.core.config import get_experiment_config
    from rails_tpu_torch.models.hstu import train_block_meta

    hstu = get_experiment_config("ml-20m-hstu-mol").hstu.replace(
        **{**K4_VAR_INSTANCES, **K4_BWD_INSTANCES}.get(instance, {}))
    return train_block_meta(hstu, max_seq_len), hstu.enable_relative_attention_bias


def k4_bwd_flops(b: int, n: int, meta, bf16: bool) -> int:
    """FLOPs the attention backward needs at ml-20m widths (h*dqk = h*dv =
    256 in every instance). Pointwise: s, d_a, d_q, d_k, d_v over the causal
    pairs (bf16 also recomputes attn: s and a v). Softmax: s, d_q and d_k
    over every pair (the mask follows the normalisation), d_a and d_v over
    the causal ones (bf16: + s over every pair and a v)."""
    hq, hv = meta.num_heads * meta.dqk, meta.num_heads * meta.dv
    pairs = n * (n + 1) // 2
    if meta.softmax:
        flops = 2 * b * (3 * n * n * hq + 2 * pairs * hv)
        return flops + (2 * b * (n * n * hq + pairs * hv) if bf16 else 0)
    return (7 if bf16 else 5) * 2 * b * pairs * hq


def check_k4(device, dtype, instance: Optional[str] = None, geom_name: str = "ml-20m") -> tuple:
    """One train block at B=128, n=211 with o_input dropout 0.2, f32 or bf16
    operands, the default block (`[K4]`; at another geometry of K1_GEOMS, its
    D and n = its max_seq_len) or one of K4_VAR_INSTANCES
    (`[K4-var]`): the kernels' forward and every gradient against the plain
    versions (f32: autograd of the plain forward; bf16: the block's own glue
    with the plain forward and attention backward, which round where the
    kernels round); the attention backward alone; then forward and
    attention-backward times of both, and their bounds."""
    import torch

    from rails_tpu_torch.ops import hstu_block_train as hbt
    from rails_tpu_torch.ops.hash_dropout import hash_keep_mask
    from rails_tpu_torch.ops.hstu_block import ln

    bf16 = dtype == torch.bfloat16
    dt = "bf16" if bf16 else "f32"
    tag = ("[K4]" if geom_name == "ml-20m" else f"[K4] {geom_name}") if instance is None else (
        f"[K4-var] {instance}")
    geom = K1_GEOMS[geom_name]
    d, n = geom[0], geom[4]
    b = TRAIN_BATCH
    (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw), kw = k1_inputs(
        b, n, dtype, device, seed=3, geom=geom)
    x = x * colmask[..., None].to(dtype)
    meta, has_bias = k4_meta(instance, n)
    if meta.concat_ua:
        g = torch.Generator().manual_seed(3)
        o_kernel = (torch.randn(meta.o_width, d, generator=g) / (H * DV) ** 0.5).to(dtype).to(device)
    if not has_bias:
        rel_pos = ext = tsw = None
    seed = 987_654_321
    w = torch.cos(torch.arange(x.numel(), device=device, dtype=torch.float32) * 0.01).reshape(x.shape)
    names = ("x", "rel_pos", "tsw", "uvqk", "o_kernel", "o_bias") if has_bias else (
        "x", "uvqk", "o_kernel", "o_bias")
    operands = dict(x=x, rel_pos=rel_pos, tsw=tsw, uvqk=uvqk, o_kernel=o_kernel, o_bias=o_bias)
    results = {}
    for label in ("kernel", "plain"):
        fn = hbt.fused_train_block
        if label == "plain" and not bf16:
            fn = hbt.fused_train_block_autograd_reference
        leaves = {k: operands[k].clone().requires_grad_(True) for k in names}
        with plain_kernels() if label == "plain" and bf16 else contextlib.nullcontext():
            out = fn(leaves["x"], leaves.get("rel_pos"), leaves.get("tsw"), leaves["uvqk"],
                     leaves["o_kernel"], leaves["o_bias"], colmask, ext, seed, meta)
            (out.float() * w).sum().backward()
        results[label] = (out.detach().float(), {k: t.grad.float() for k, t in leaves.items()})
    (out_k, g_k), (out_p, g_p) = results["kernel"], results["plain"]
    grad_tol = K4_BF16_TOL if bf16 else GRAD_REL_TOL
    if bf16:
        err_share = rel_err(out_k, out_p)
        if err_share > K4_BF16_TOL:
            raise AssertionError(f"{tag} bf16 forward outside {K4_BF16_TOL}: {err_share}")
        verdict = f"max|err|/max|plain| {err_share:.2e} <= {K4_BF16_TOL}"
    else:
        rtol, atol = K4_TOL
        torch.testing.assert_close(out_k, out_p, rtol=rtol, atol=atol)
        verdict = f"rtol {rtol}, atol {atol}"
    err = (out_k - out_p).abs().max().item()
    grad_errs = {k: rel_err(g_k[k], g_p[k]) for k in names}
    worst = max(grad_errs.values())
    if worst > grad_tol:
        raise AssertionError(f"{tag} {dt} gradients outside {grad_tol}: {grad_errs}")

    args = (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, seed, meta)
    fwd_ms = cuda_ms(lambda: hbt.fused_train_block_forward(*args))
    fwd_plain_ms = cuda_ms(lambda: hbt.fused_train_block_forward_reference(*args), iters=3)
    _, attn = hbt.fused_train_block_forward(*args)
    n0 = ln(x.float(), meta.eps)
    z = n0.to(dtype).float() @ uvqk.float()
    y = (z * torch.sigmoid(z) if meta.activation == "silu" else z).to(dtype)
    d_o = ((w.to(dtype).float() @ o_kernel.float().T)
           * hash_keep_mask(b, n, meta.o_width, seed, meta.rate, device)).to(dtype)
    # The bf16 backward recomputes attn from its bf16 y, as the JAX backward does.
    bargs = (y, d_o, None if bf16 else attn, colmask, rel_pos, ext, tsw, meta, seed)
    d_y_k, dbias_k, _ = hbt.attn_backward(*bargs)
    d_y_p, dbias_p, _ = hbt.attn_backward_reference(*bargs)
    bwd_err = rel_err(d_y_k, d_y_p)
    if has_bias:
        bwd_err = max(bwd_err, rel_err(dbias_k, dbias_p))
    elif dbias_k is not None:
        raise AssertionError(f"{tag}: a dbias without the bias")
    if bwd_err > grad_tol:
        raise AssertionError(f"{tag} {dt} attention backward outside {grad_tol}: {bwd_err}")
    bwd_ms = cuda_ms(lambda: hbt.attn_backward(*bargs))
    bwd_plain_ms = cuda_ms(lambda: hbt.attn_backward_reference(*bargs), iters=3)
    isz = x.element_size()
    # f32 on the tensor cores (3xTF32): both directions, bounds at 3xTF32's
    # rate with the CUDA cores' 67 TFLOP/s beside them.
    tf32 = hbt.tf32_fwd_route(dtype, d, n, meta)
    peak = "bfloat16" if bf16 else "tf32x3" if tf32 else "float32"
    bias_kind = "internal" if has_bias else "none"
    fwd_flops = k1_variant_flops(b, n, meta.softmax, meta.o_width, geom=geom)
    fwd_bd = bound(fwd_flops,
                   k1_variant_bytes(b, n, isz, meta.o_width, bias_kind, geom=geom)
                   + 4 * b * n * H * DV, peak)
    f = 2 * H * DV + 2 * H * DQK
    # y and d_o in; d_y, attn (f32: in; bf16: out) and dbias out; the bias tables.
    bwd_bytes = (isz * (b * n * f + b * n * meta.o_width)
                 + 4 * (b * n * f + b * n * H * DV + b * n + 128))
    if has_bias:
        bwd_bytes += 4 * (b * n * n + n * n + b * (n + 1))
    bwd_bd = bound(k4_bwd_flops(b, n, meta, bf16), bwd_bytes, peak)
    label = f"{tag} {dt} B={b} n={n} D={d} h={meta.num_heads} dqk={meta.dqk} dv={meta.dv}"
    routes = [f"{what} {'tensor cores' if tc else 'CUDA cores'}" for what, tc in (
        ("forward", hbt.tc_fwd_route(dtype, d, meta) or tf32),
        ("backward", hbt.tc_bwd_route(dtype, meta) or hbt.tf32_bwd_route(dtype, n, meta)))]
    f32_cores = ""
    if tf32:
        f32_cores = (f" (3xTF32 at {TF32X3_FLOPS / 1e12:.0f} TFLOP/s; at the CUDA cores' 67 "
                     f"TFLOP/s forward {fwd_flops / PEAK_FLOPS['float32'] * 1e3:.4f} ms, backward "
                     f"{k4_bwd_flops(b, n, meta, bf16) / PEAK_FLOPS['float32'] * 1e3:.4f} ms)")
    print(f"{tag} {dt} route: {', '.join(routes)}; forward stages "
          f"{stage_split(lambda: hbt.fused_train_block_forward(*args))}; attention backward "
          f"stages {stage_split(lambda: hbt.attn_backward(*bargs))}")
    print(f"{label} dropout {meta.rate} / attention {meta.attn_rate} "
          f"({hbt.variant_name(meta, has_bias)}): forward max|err| {err:.3e} ({verdict}); "
          f"gradient max|err|/max|plain| " + ", ".join(f"{k} {v:.2e}" for k, v in grad_errs.items())
          + f" (<= {grad_tol}); attention backward alone {bwd_err:.2e}")
    print(f"{tag} {dt} forward kernel {fwd_ms:.3f} ms, plain {fwd_plain_ms:.3f} ms, bound "
          f"{fwd_bd['bound_ms']:.4f} ms ({fwd_bd['bound_by']}); attention backward kernel "
          f"{bwd_ms:.3f} ms, plain {bwd_plain_ms:.3f} ms, bound {bwd_bd['bound_ms']:.4f} ms "
          f"({bwd_bd['bound_by']}){f32_cores}")
    fwd = {"max_abs_err": err, "ms": fwd_ms, "plain_ms": fwd_plain_ms, **fwd_bd,
           "library_ms": None}
    bwd = {"max_abs_err": (d_y_k - d_y_p).abs().max().item(), "ms": bwd_ms,
           "plain_ms": bwd_plain_ms, **bwd_bd, "library_ms": None}
    return fwd, bwd


def check_k4_stages(device) -> dict:
    """K4's bf16 tensor-core kernels at ml-20m-hstu-mol's train block (B=128,
    n=211, o_input dropout 0.2), each against its plain stage version on the
    same inputs within K4_BF16_TOL of its largest value: the TRAIN attention
    over K1's projection (o_input, attn), then the backward's rows (d_u,
    d_attn, attn), dq (d_q, dbias) and dkv (d_v, d_k) stages on a seeded bf16
    y and d(o_input), dq and dkv fed the plain d_attn; each kernel twice,
    bit-equal; error, kernel, plain and bound ms. Returns the four by
    counter name (K4_STAGES)."""
    import torch

    from rails_tpu_torch.ops import hstu_block as hb
    from rails_tpu_torch.ops import hstu_block_train as hbt

    b, n = TRAIN_BATCH, MAX_SEQ_LEN
    (x, colmask, uvqk, _, _, rel_pos, ext, tsw), _ = k1_inputs(b, n, torch.bfloat16, device,
                                                               seed=3)
    x = x * colmask[..., None].to(x.dtype)
    meta, _ = k4_meta(None)
    seed, tables = 987_654_321, (rel_pos, ext, tsw)
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    hdv, hq, f = h * dv, h * dqk, 2 * H * DV + 2 * H * DQK
    m, pairs = b * n, b * h * (n * (n + 1) // 2)
    u, vqk = hb.project(x, uvqk, num_heads=h, dqk=dqk, dv=dv, inv_n=meta.inv_n, eps=meta.eps)
    v, q, k = hb.split_vqk(vqk, num_heads=h, dqk=dqk, dv=dv)
    g = torch.Generator(device=device).manual_seed(13)
    y = torch.randn(b, n, f, generator=g, device=device).bfloat16()
    d_o = torch.randn(b, n, meta.o_width, generator=g, device=device).bfloat16()
    bargs = (colmask, *tables, meta, seed)
    _, d_attn_p, _ = hbt.attn_bwd_rows_reference(y, d_o, *bargs)
    out = {}

    def report(name, kernel, plain, cols, flops, nbytes, timed=None):
        # `timed`: the kernel writing into a d_y allocated once, as the
        # composed backward does (a new d_y is zeroed first).
        timed = timed or kernel
        got, again, want = kernel(), kernel(), plain()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"[K4-stage] {name}: two calls differ")
        shares = [rel_err(got[i][..., c].float(), want[i][..., c].float()) for i, c in cols]
        if max(shares) > K4_BF16_TOL:
            raise AssertionError(f"[K4-stage] {name} outside {K4_BF16_TOL}: {shares}")
        err = max((got[i][..., c].float() - want[i][..., c].float()).abs().max().item()
                  for i, c in cols)
        ms, plain_ms = cuda_ms(timed), cuda_ms(plain, iters=3, warmup=1)
        bd = bound(flops, nbytes, "bfloat16")
        print(f"[K4-stage] {name} bf16 B={b} n={n}: max|err|/max|plain| per output "
              f"{[float(f'{x_:.2e}') for x_ in shares]} (<= {K4_BF16_TOL}), two calls bit-equal; "
              f"kernel {ms:.3f} ms [{TC_INSTRUCTION}], plain {plain_ms:.3f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}); "
              f"{stage_split(timed)}")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None}

    every = slice(None)
    report("K4 attn", lambda: hbt.train_attention_oinput(u, vqk, colmask, *tables, seed, meta),
           lambda: hbt.train_attention_oinput_reference(u, v, q, k, colmask, *tables, seed, meta),
           [(0, every), (1, every)], 4 * pairs * dqk,
           4 * m * hdv + 2 * m * vqk.shape[-1] + 2 * m * meta.o_width + 4 * m * hdv)
    buf = torch.empty(b, n, f, device=device)
    report("K4 bwd rows", lambda: hbt.attn_bwd_rows(y, d_o, *bargs),
           lambda: hbt.attn_bwd_rows_reference(y, d_o, *bargs),
           [(0, slice(0, hdv)), (1, every), (2, every)], 4 * pairs * dqk,
           2 * m * (f + meta.o_width) + 4 * m * hdv + 2 * m * hdv + 4 * m * hdv,
           lambda: hbt.attn_bwd_rows(y, d_o, *bargs, d_y=buf))
    report("K4 bwd dq", lambda: hbt.attn_bwd_dq(y, d_attn_p, *bargs),
           lambda: hbt.attn_bwd_dq_reference(y, d_attn_p, *bargs),
           [(0, slice(2 * hdv, 2 * hdv + hq)), (1, every)], 6 * pairs * dqk,
           2 * m * (f + hdv) + 4 * m * hq + 4 * b * n * n,
           lambda: hbt.attn_bwd_dq(y, d_attn_p, *bargs, d_y=buf))
    report("K4 bwd dkv", lambda: (hbt.attn_bwd_dkv(y, d_attn_p, *bargs),),
           lambda: (hbt.attn_bwd_dkv_reference(y, d_attn_p, *bargs),),
           [(0, slice(hdv, 2 * hdv)), (0, slice(2 * hdv + hq, None))], 8 * pairs * dqk,
           2 * m * (f + hdv) + 4 * m * (hq + hdv),
           lambda: hbt.attn_bwd_dkv(y, d_attn_p, *bargs, d_y=buf))
    return out


def k4_tf32_stage_cases(device) -> list:
    """K4's f32 route (3xTF32, csrc/hstu_train_tf32.cuh) at ml-20m-hstu-mol's
    train block (B=128, n=211, o_input dropout 0.2), stage by stage on the
    same inputs: the projection, the attention over the plain y, the output
    GEMM over the plain y and attn, then the backward's rows (d_u, d_attn),
    dq (d_q, dbias) and dkv (d_v, d_k) stages over the plain y and d_attn.
    Each case is (counter name, kernel, plain, the (output, columns) compared,
    FLOPs, bytes moved (each input read once, each output written once), the
    call timed)."""
    import torch

    from rails_tpu_torch.ops import hstu_block_train as hbt

    b, n = TRAIN_BATCH, MAX_SEQ_LEN
    (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw), _ = k1_inputs(b, n, torch.float32,
                                                                           device, seed=3)
    x = x * colmask[..., None]
    meta, _ = k4_meta(None)
    seed, tables = 987_654_321, (rel_pos, ext, tsw)
    h, dqk, dv = meta.num_heads, meta.dqk, meta.dv
    hdv, hq, f = h * dv, h * dqk, 2 * H * DV + 2 * H * DQK
    m, pairs = b * n, b * h * (n * (n + 1) // 2)
    y = hbt.tf32_project_reference(x, uvqk, meta)
    attn = hbt.tf32_attention_reference(y, colmask, *tables, seed, meta)
    g = torch.Generator(device=device).manual_seed(13)
    d_o = torch.randn(b, n, meta.o_width, generator=g, device=device)
    _, d_attn = hbt.tf32_bwd_rows_reference(y, d_o, attn, meta)
    bargs = (colmask, *tables, meta, seed)
    buf = torch.empty(b, n, f, device=device)
    every = slice(None)
    return [
        ("K4 f32 proj", lambda: (hbt.tf32_project(x, uvqk, meta),),
         lambda: (hbt.tf32_project_reference(x, uvqk, meta),), [(0, every)],
         2 * m * D * f, 4 * (m * D + D * f + m * f), None),
        ("K4 f32 attn", lambda: (hbt.tf32_attention(y, colmask, *tables, seed, meta),),
         lambda: (hbt.tf32_attention_reference(y, colmask, *tables, seed, meta),), [(0, every)],
         4 * pairs * dqk, 4 * (m * (hdv + 2 * hq) + m * hdv + n * n + b * (n + 1)), None),
        # u and attn read once each (concat_ua's three parts are built from them).
        ("K4 f32 out", lambda: (hbt.tf32_out_gemm(x, y, attn, o_kernel, o_bias, seed, meta),),
         lambda: (hbt.tf32_out_gemm_reference(x, y, attn, o_kernel, o_bias, seed, meta),),
         [(0, every)], 2 * m * meta.o_width * D,
         4 * (2 * m * hdv + meta.o_width * D + 2 * m * D), None),
        ("K4 f32 bwd rows", lambda: hbt.tf32_bwd_rows(y, d_o, attn, meta),
         lambda: hbt.tf32_bwd_rows_reference(y, d_o, attn, meta),
         [(0, slice(0, hdv)), (1, every)], 0, 4 * m * (3 * hdv + meta.o_width + hdv),
         lambda: hbt.tf32_bwd_rows(y, d_o, attn, meta, buf)),
        ("K4 f32 bwd dq", lambda: hbt.tf32_bwd_dq(y, d_attn, *bargs),
         lambda: hbt.attn_bwd_dq_reference(y, d_attn, *bargs),
         [(0, slice(2 * hdv, 2 * hdv + hq)), (1, every)], 6 * pairs * dqk,
         4 * (m * (f - hdv) + m * hdv + m * hq + b * n * n),
         lambda: hbt.tf32_bwd_dq(y, d_attn, *bargs, d_y=buf)),
        ("K4 f32 bwd dkv", lambda: (hbt.tf32_bwd_dkv(y, d_attn, *bargs),),
         lambda: (hbt.attn_bwd_dkv_reference(y, d_attn, *bargs),),
         [(0, slice(hdv, 2 * hdv)), (0, slice(2 * hdv + hq, None))], 8 * pairs * dqk,
         4 * (m * (f - hdv) + m * hdv + m * (hq + hdv)),
         lambda: hbt.tf32_bwd_dkv(y, d_attn, *bargs, d_y=buf)),
    ]


def k4_tf32_stage_shares(kernel, plain, cols) -> tuple:
    """One stage case's outputs against its plain version: (max |err| / max
    |plain| per compared output, max |err|, whether two kernel calls gave the
    same bits)."""
    import torch

    got, again, want = kernel(), kernel(), plain()
    shares = [rel_err(got[i][..., c], want[i][..., c]) for i, c in cols]
    err = max((got[i][..., c] - want[i][..., c]).abs().max().item() for i, c in cols)
    return shares, err, all(torch.equal(a, c) for a, c in zip(got, again))


def check_k4_tf32_stages(device) -> dict:
    """Each case of `k4_tf32_stage_cases` twice, bit-equal, within
    K4_TF32_STAGE_TOL of its largest value; error, kernel, plain and bound ms
    (operations at 3xTF32's rate, bytes at HBM's). Returns them by counter
    name (K4_TF32_STAGES)."""
    b, n = TRAIN_BATCH, MAX_SEQ_LEN
    out = {}
    for name, kernel, plain, cols, flops, nbytes, timed in k4_tf32_stage_cases(device):
        timed = timed or kernel
        shares, err, same = k4_tf32_stage_shares(kernel, plain, cols)
        if not same:
            raise AssertionError(f"[K4-stage] {name}: two calls differ")
        if max(shares) > K4_TF32_STAGE_TOL:
            raise AssertionError(f"[K4-stage] {name} outside {K4_TF32_STAGE_TOL}: {shares}")
        ms, plain_ms = cuda_ms(timed), cuda_ms(plain, iters=3, warmup=1)
        bd = bound(flops, nbytes, "tf32x3")
        unit = "FFMA (CUDA cores)" if name.endswith("rows") else TF32_INSTRUCTION
        print(f"[K4-stage] {name} B={b} n={n}: max|err|/max|plain| per output "
              f"{[float(f'{x_:.2e}') for x_ in shares]} (<= {K4_TF32_STAGE_TOL}), two calls "
              f"bit-equal; kernel {ms:.3f} ms [{unit}], plain {plain_ms:.3f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}; {flops / PEAK_FLOPS['float32'] * 1e3:.4f}"
              f" ms at the CUDA cores' 67 TFLOP/s); {stage_split(timed)}")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None}
    return out


def device_timeline(fn) -> list:
    """One call of fn (after warm-up) under torch.profiler: its device
    operations in launch order as (issuer, name, device us, idle us before
    it), the issuer being the torch op that launched it or "ctypes" for an
    entry point of the kernel library. The profiler slows the host, so the
    idle gaps are upper bounds of the unprofiled ones. Empty when three
    profiled calls recorded no device operation (the profiler sometimes
    misses a session's device activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    label = "timed call"
    for _ in range(3):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(label):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        device = sorted((e for e in events
                         if e.device_type == DeviceType.CUDA and e.name != label),
                        key=lambda e: e.time_range.start)
        if device:
            break
    else:
        return []
    launches = sorted((e for e in events if e.device_type == DeviceType.CPU
                       and e.name.startswith("cu")
                       and any(k in e.name for k in ("Launch", "Memset", "Memcpy"))),
                      key=lambda e: e.time_range.start)

    def issuer(launch) -> str:
        op = launch
        while op.cpu_parent is not None and op.cpu_parent.name != label:
            op = op.cpu_parent
        return "ctypes" if op is launch else op.name

    names = ([issuer(e) for e in launches] if len(launches) == len(device)
             else ["?"] * len(device))
    ends = [device[0].time_range.start] + [e.time_range.end for e in device[:-1]]
    return [(who, e.name, e.time_range.end - e.time_range.start,
             max(0.0, e.time_range.start - end)) for who, e, end in zip(names, device, ends)]


def torch_calls(fn) -> list:
    """Names of the torch functions and tensor methods that one call of fn
    makes (a TorchFunctionMode record, which needs no profiler)."""
    from torch.overrides import TorchFunctionMode

    class Record(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.names.append(getattr(func, "__name__", str(func)))
            return func(*args, **(kwargs or {}))

    with Record() as record:
        fn()
    return record.names


# What K6's plain route ran on the card and its kernel must not (a torch sort,
# search, scan, select or cast); any name containing one of the first three.
K6_FORBIDDEN = ("sort", "search", "cumsum", "where", "to", "index", "index_put_", "index_add_",
                "__getitem__", "long", "unique", "bincount", "nonzero")


def own_stages(timeline, kernels: tuple) -> str:
    """The timeline as "name us + ... = total us device"; raises if any
    device operation is neither one of `kernels` nor a memset, or was issued
    by a torch op (where the profiler pairs operations with their launches:
    "?" where it does not, and then the names alone decide; a torch sort,
    search or scan runs kernels of its own)."""
    if not timeline:
        return "device operations not recorded by torch.profiler"
    parts = []
    for who, name, us, _ in timeline:
        short = next((k for k in kernels if k in name), None)
        if who not in ("ctypes", "?") or (short is None and not name.startswith("Memset")):
            raise AssertionError(f"a device operation outside the kernel: {who}: {name}")
        parts.append(f"{short or 'memset'} {us:.2f}")
    return " + ".join(parts) + f" = {sum(t[2] for t in timeline):.2f} us device"


def check_k7(device) -> dict:
    """AdamW on ml-20m's two fused leaves (the item table and the uid table)
    in one launch: the kernel against its plain version, and
    torch._fused_adamw_ timed on the same tensors as a yardstick (the port
    never calls it)."""
    import torch

    from rails_tpu_torch.train.fused_adamw import (
        adamw_update_leaves,
        adamw_update_leaves_reference,
    )

    g = torch.Generator(device=device).manual_seed(7)
    shapes = ((NUM_ITEMS + 1, D), (16_385, D_P))
    leaves = [tuple(torch.randn(s, generator=g, device=device) * sc
                    for sc in (1e-3, 1.0, 1e-4, 1e-8)) for s in shapes]   # g, p, mu, nu
    leaves = [(gr, p, mu, nu.abs()) for gr, p, mu, nu in leaves]
    kw = dict(lr=1e-3, c1=10.0, c2=50.5, b1=0.9, b2=0.98, eps=1e-8, wd=1e-3)
    got = [(gr, *(t.clone() for t in rest)) for gr, *rest in leaves]
    ref = [(gr, *(t.clone() for t in rest)) for gr, *rest in leaves]
    before = adamw_update_leaves.launches
    adamw_update_leaves(got, **kw)
    if adamw_update_leaves.launches != before + 1:
        raise AssertionError("K7: one call over both leaves must be one launch")
    adamw_update_leaves_reference(ref, **kw)
    err = max((a - b).abs().max().item()
              for lg, lr_ in zip(got, ref) for a, b in zip(lg[1:], lr_[1:]))
    # The kernel keeps the plain version's rounding order: every leaf's p, mu
    # and nu must be bit-equal to it.
    for n, (lg, lr_) in enumerate(zip(got, ref)):
        for name, a, b in zip(("p", "mu", "nu"), lg[1:], lr_[1:]):
            if not torch.equal(a, b):
                raise AssertionError(f"K7 leaf {n} {name} differs from its plain version by "
                                     f"{(a - b).abs().max().item()}")
    work = [(gr, *(t.clone() for t in rest)) for gr, *rest in leaves]
    ms = cuda_ms(lambda: adamw_update_leaves(work, **kw))
    plain_ms = cuda_ms(lambda: adamw_update_leaves_reference(work, **kw))
    stages = own_stages(device_timeline(lambda: adamw_update_leaves(work, **kw)),
                        ("adamw_leaves_kernel",))
    lib = [[t.clone() for t in leaf] for leaf in leaves]
    steps = [torch.tensor(3.0, device=device) for _ in lib]

    def library():
        torch._fused_adamw_(
            [lf[1] for lf in lib], [lf[0] for lf in lib], [lf[2] for lf in lib],
            [lf[3] for lf in lib], [], steps, lr=1e-3, beta1=0.9, beta2=0.98, weight_decay=1e-3,
            eps=1e-8, amsgrad=False, maximize=False)

    library_ms = cuda_ms(library)
    host, library_host = host_us(lambda: adamw_update_leaves(work, **kw)), host_us(library)
    numel = sum(leaf[0].numel() for leaf in leaves)
    bd = bound(12 * numel, 28 * numel, "float32")
    print(f"[K7] AdamW leaves {[tuple(s) for s in shapes]} ({numel} elements), one launch: "
          f"p, mu and nu bit-equal to the plain version (max|err| {err:.3e}); kernel {ms:.4f} ms ({stages}; host "
          f"{host:.1f} us a call), plain {plain_ms:.4f} ms, torch._fused_adamw_ "
          f"{library_ms:.4f} ms (host {library_host:.1f} us a call), bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": library_ms}


def configure(cfg, changes: Optional[dict] = None):
    """`cfg` with `changes` applied: a dict value replaces fields of that
    section (`train`, `hstu`, `mol`, ...), any other a top-level field."""
    changes = changes or {}
    sections = {k: getattr(cfg, k).replace(**v) for k, v in changes.items() if isinstance(v, dict)}
    return cfg.replace(**sections, **{k: v for k, v in changes.items() if not isinstance(v, dict)})


def category_map(cfg, num_items: int) -> Optional[np.ndarray]:
    """The id -> category remap of a categorical-embedding config: item i in
    category (i - 1) % num_item_categories; None for the local table."""
    if cfg.embedding_module_type != "categorical":
        return None
    return np.arange(num_items, dtype=np.int32) % cfg.num_item_categories


def train_setup(device, config: str = "ml-20m-hstu-mol", batch: int = TRAIN_BATCH,
                num_items: int = NUM_ITEMS, lengths: str = "ml20m",
                hstu: Optional[dict] = None, changes: Optional[dict] = None,
                **train_overrides):
    """`config` training (seeded random weights over `num_items` items, the
    config's dtype) with `changes` applied (`configure`), the `hstu` fields
    in `hstu` and the `train` fields in `train_overrides` replaced, and one
    batch of synthetic users at the config's N (ML-20M-shaped lengths by
    default)."""
    from rails_tpu_torch.core.config import get_experiment_config
    from rails_tpu_torch.train.loop import create_train_state

    cfg = configure(get_experiment_config(config), changes)
    cfg = cfg.replace(train=cfg.train.replace(**train_overrides),
                      hstu=cfg.hstu.replace(**(hstu or {})))
    model, state, step, _ = create_train_state(
        cfg, num_items, np.arange(1, num_items + 1, dtype=np.int32), seed=0, device=device,
        item_id_to_category_id=category_map(cfg, num_items))
    return cfg, model, state, step, train_batch(cfg, device, batch, num_items, lengths)


def train_batch(cfg, device, batch: int = TRAIN_BATCH, num_items: int = NUM_ITEMS,
                lengths: str = "ml20m"):
    """One training batch of synthetic users at the config's N, with
    `lengths` ("ml20m" or "uniform") history lengths."""
    from rails_tpu_torch.data.datasets import SequenceDataset, generate_synthetic_sequences

    seqs = generate_synthetic_sequences(num_users=4 * batch, num_items=num_items,
                                        max_len=cfg.data.max_sequence_length + 2, seed=1,
                                        length_distribution=lengths)
    ds = SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1)
    return next(ds.batches(batch, cfg.train.gr_output_length + 1, shuffle=True, seed=0,
                           drop_last=True, device=device))


def zipf_ids(device, shape: tuple, num_items: int, seed: int = 11):
    """Item ids 1..num_items of `shape`, drawn with Zipf popularity (item r
    with probability proportional to 1 / r), made on the card."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    weight = 1.0 / torch.arange(1, num_items + 1, device=device, dtype=torch.float32)
    n = 1
    for size in shape:
        n *= size
    return (torch.multinomial(weight, n, replacement=True, generator=g) + 1).int().view(shape)


def step_launches(cfg, model, optimizer) -> dict:
    """The kernel launches one training step of `cfg` makes: with an HSTU
    encoder and `fused_train` K3 and K4 once per block at the encoder's
    width and length (its bf16 instance in bf16, at
    the tensor-core widths on the tensor cores: `tc_fwd_route`,
    `tc_bwd_route`; f32 there by 3xTF32: `tf32_fwd_route`, `tf32_bwd_route`), none
    on the XLA block path; K7 once where the optimizer fuses a leaf; with the
    fused shared-negatives loss K5 forward and backward once (its bf16
    instance in bf16); with pallas_scatter_grad K6 once per gather from the
    item table (the tokens, the encoder's input, and the local sampler's
    negatives unless the loss is BCE with ratings, which draws none); no
    serving kernel."""
    import torch

    from rails_tpu_torch.models.hstu import train_block_meta
    from rails_tpu_torch.ops.hstu_block_train import (
        tc_bwd_route,
        tc_fwd_route,
        tf32_bwd_route,
        tf32_fwd_route,
    )
    from rails_tpu_torch.ops.mol_loss_train import tc_route as k5_tc_route

    blocks = cfg.hstu.num_blocks if cfg.model_type == "HSTU" and cfg.hstu.fused_train else 0
    # K5 where the JAX loss takes its fused route (`sampled_softmax.py:190-200`):
    # the local sampler, the sampled softmax with shared negatives and the
    # fused loss, over a glu_silu MoL with both gating partials and a qi MLP.
    t, mol = cfg.train, cfg.mol
    fused = int(t.sampling_strategy == "local" and t.loss_module == "SampledSoftmaxLoss"
                and t.shared_negatives and t.fused_mol_loss and cfg.similarity_type == "MoL"
                and mol.gating_combination_type == "glu_silu" and mol.gating_query_fn
                and mol.gating_item_fn and mol.gating_qi_hidden_dim > 0)
    k5_tc = fused * int(k5_tc_route(model.compute_dtype, mol.query_dot_product_groups,
                                    mol.item_dot_product_groups, mol.dot_product_dimension,
                                    mol.gating_qi_hidden_dim))
    bf16 = model.compute_dtype == torch.bfloat16
    variant = k4_variant(cfg)
    per_variant = {} if variant == "default" or not blocks else {
        f"K4 fwd [{variant}]": blocks, f"K4 bwd [{variant}]": blocks}
    # bf16 K4 on the tensor cores: the forward through K1's projection and
    # output GEMM around the train attention stage, the pointwise backward's
    # three stages; f32 K4 on them (3xTF32): the six f32 stages.
    n, d = model.n_enc, model.d_model
    meta = train_block_meta(cfg.hstu, n)
    fwd_tc = blocks * int(tc_fwd_route(model.compute_dtype, d, meta))
    bwd_tc = blocks * int(tc_bwd_route(model.compute_dtype, meta))
    fwd_32 = blocks * int(tf32_fwd_route(model.compute_dtype, d, n, meta))
    bwd_32 = blocks * int(tf32_bwd_route(model.compute_dtype, n, meta))
    gathers = 3 if (cfg.train.sampling_strategy == "local"
                    and cfg.train.loss_module != "BCELossWithRatings") else 2
    tc = {"K4 fwd-tc": fwd_tc + fwd_32, "K1 proj": fwd_tc, "K4 attn": fwd_tc, "K1 out": fwd_tc,
          "K4 bwd-tc": bwd_tc + bwd_32, "K4 bwd rows": bwd_tc, "K4 bwd dq": bwd_tc,
          "K4 bwd dkv": bwd_tc,
          **{k: fwd_32 for k in K4_TF32_STAGES[:3]}, **{k: bwd_32 for k in K4_TF32_STAGES[3:]}}
    return {**{k: 0 for k in kernel_counters()}, **per_variant, **tc, "K3": blocks,
            "K4 fwd": blocks, "K4 bwd": blocks, "K4 fwd (bf16)": blocks * bf16,
            "K4 bwd (bf16)": blocks * bf16,
            "K5 fwd": fused, "K5 bwd": fused, "K5 fwd-tc": k5_tc, "K5 bwd-tc": k5_tc,
            "K5 fwd (bf16)": fused * bf16,
            "K5 bwd (bf16)": fused * bf16, "K6": gathers if cfg.train.pallas_scatter_grad else 0,
            "K7": int(any(optimizer.fused(p.numel()) for p in model.parameters()))}


def first_step_vs_plain(cfg, model, state, step, batch, gen, tag: str, what: str = "") -> tuple:
    """Step 1 through the kernels (its launches checked against
    `step_launches`) vs the same step through the plain versions from the
    same weights, moments and generator state; prints the line. Returns the
    state after the plain step, step 1's launches and the expected ones."""
    import torch

    batch_size, n = batch.features.ids.shape
    params = dict(model.named_parameters())
    opt = state.optimizer
    p0 = {k: p.detach().clone() for k, p in params.items()}
    mu0 = {k: t.clone() for k, t in opt.state.mu.items()}
    nu0 = {k: t.clone() for k, t in opt.state.nu.items()}
    g0 = gen.get_state()

    reset_launches()
    state, m_k = step(state, batch, gen)
    per_step = launch_counts()
    grads_k = {k: p.grad.detach().clone() for k, p in params.items()}
    want = step_launches(cfg, model, opt)
    if per_step != want:
        raise AssertionError(f"train step launches {per_step}, want {want}")
    for k, p in params.items():
        p.data.copy_(p0[k])
        opt.state.mu[k].copy_(mu0[k])
        opt.state.nu[k].copy_(nu0[k])
    opt.state.count = 0
    gen.set_state(g0)
    with plain_kernels():
        state, m_p = step(state, batch, gen)
    loss_err = abs(m_k["loss"].item() - m_p["loss"].item()) / abs(m_p["loss"].item())
    dt = "bf16" if model.compute_dtype == torch.bfloat16 else "f32"
    loss_tol, grad_tol = BF16_TRAIN_TOL if dt == "bf16" else (TRAIN_LOSS_RTOL, GRAD_REL_TOL)
    groups: dict = {}
    for k, p in params.items():
        group = k.split(".")[0]
        groups[group] = max(groups.get(group, 0.0), rel_err(grads_k[k], p.grad))
    negatives = "shared" if cfg.train.shared_negatives else "per position"
    variant = "" if k4_variant(cfg) == "default" else f" (K4 variant {k4_variant(cfg)})"
    what = f" {what}" if what else ""
    print(f"[{tag}]{what} step 1 kernels vs plain, {cfg.name}{variant} B={batch_size} N={n} "
          f"R={cfg.train.num_negatives} {negatives}, pallas_scatter_grad="
          f"{cfg.train.pallas_scatter_grad}, {dt}: loss {m_k['loss'].item():.6f} vs "
          f"{m_p['loss'].item():.6f} (rel {loss_err:.2e} <= {loss_tol}); gradient "
          f"max|err|/max|plain| per group "
          + ", ".join(f"{k} {v:.2e}" for k, v in groups.items())
          + f" (<= {grad_tol}); launches per step {per_step}")
    if loss_err > loss_tol or max(groups.values()) > grad_tol:
        raise AssertionError("the kernel step disagrees with the plain step")
    return state, per_step, want


def train_phase(device, name: str, smi: str, config: str = "ml-20m-hstu-mol",
                tag: str = "train", batch_size: int = TRAIN_BATCH, num_items: int = NUM_ITEMS,
                lengths: str = "ml20m", hstu: Optional[dict] = None,
                changes: Optional[dict] = None, what: str = "", steps: int = TRAIN_STEPS,
                **train_overrides) -> dict:
    """Step 1 through the kernels vs through the plain versions from the same
    state and generator; then `steps` steps on the batch. Returns the launch
    counts of every kernel over those steps, or of step 1 when `steps` is
    0. `what` names the run after the tag."""
    import torch

    cfg, model, state, step, batch = train_setup(device, config, batch_size, num_items, lengths,
                                                 hstu, changes, **train_overrides)
    gen = torch.Generator(device=device).manual_seed(0)
    state, per_step, want = first_step_vs_plain(cfg, model, state, step, batch, gen, tag, what)
    what = f" {what}" if what else ""
    if not steps:
        return per_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(m["loss"].item())
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    falls = np.mean(losses[-5:]) < np.mean(losses[:5]) and losses[-1] < losses[0]
    ms = statistics.median(times[2:])
    print(f"[{tag}]{what} {steps} steps on one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(first 5 mean {np.mean(losses[:5]):.4f}, last 5 mean {np.mean(losses[-5:]):.4f}); "
          f"median of steps 3-{steps} {ms:.3f} ms/step = "
          f"{batch_size / ms * 1e3:.1f} sequences/s; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {counts} on {name} ({smi})")
    if not falls:
        raise AssertionError(f"the training loss did not fall: {losses}")
    want_all = {k: v * steps for k, v in want.items()}
    if counts != want_all:
        raise AssertionError(f"train launches {counts}, want {want_all}")
    return counts


K5_NAMES = ("q_comp", "qp", "item_comp", "ip", "w1", "b1", "w2", "b2")


def k5_inputs(device, m: int, r: int, geom: tuple, dtype, seed: int = 5):
    """K5 operands: M queries' l2-normalised P_Q x d_P components and L gating
    partials, R shared negatives' P_X x d_P components and partials (in
    `dtype`), and an f32 qi MLP of 128 hidden units."""
    import torch

    from rails_tpu_torch.similarity.layers import l2_normalize

    g = torch.Generator(device=device).manual_seed(seed)
    p_q, p_x, d_p = geom
    l, hd = p_q * p_x, 128

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    ops = [l2_normalize(randn(m, p_q, d_p)), randn(m, l), l2_normalize(randn(r, p_x, d_p)),
           randn(r, l)]
    return [t.to(dtype) for t in ops] + [randn(l, hd) / l ** 0.5, 0.1 * randn(1, hd),
                                         randn(hd, l) / hd ** 0.5, 0.1 * randn(1, l)]


def check_k5(device, m: int = TRAIN_BATCH * (MAX_SEQ_LEN - 1), r: int = NUM_NEGATIVES,
             geom: tuple = ML20M_GEOM, dtype_name: str = "float32",
             rates: tuple = K5_RATES, what: str = "ML-20M", seed: int = 5,
             timed: bool = True) -> tuple:
    """K5 forward and backward (ml-20m-fast's shapes by default) against the
    plain versions on the same inputs, mask seed and cotangent: f32 to K2's
    f32 tolerance and GRAD_REL_TOL, bf16 operands within K5_BF16_TOL. Each
    direction must take the route `tc_route` names (`.tc_launches`), and two
    backward calls must give the same bits. The bound's operations term is
    at the route's rate (3xTF32 for f32 on the tensor cores, the 67 TFLOP/s
    of the CUDA cores printed beside it), and its MUFU term counts one ex2
    for each SiLU and exp a pair needs, H + 2 L in either direction. `seed`
    draws the operands, the cotangent and the masks; with `timed` False the
    line carries the errors alone, and the result is each direction's share
    of its tolerance (1 at the limit)."""
    import torch

    from rails_tpu_torch.ops import mol_loss_train as mlt

    dtype = getattr(torch, dtype_name)
    args = k5_inputs(device, m, r, geom, dtype, seed)
    p_q, p_x, d_p = geom
    l, hd = p_q * p_x, args[4].shape[1]
    pi_rate, qi_rate = rates
    kw = dict(p_q=p_q, p_x=p_x, temperature=TEMPERATURE, qi_rate=qi_rate, pi_rate=pi_rate,
              eps=1e-6)
    mask_seed = 424_237 + seed   # 424,242 at the default seed 5
    fwd_fn, bwd_fn = mlt.fused_mol_loss_forward, mlt.fused_mol_loss_backward
    tc = mlt.tc_route(dtype, p_q, p_x, d_p, hd)
    route = ("CUDA cores" if not tc else "tensor cores, mma.sync bf16" if dtype_name == "bfloat16"
             else "tensor cores, 3xTF32 mma.sync")
    before = (fwd_fn.tc_launches, bwd_fn.tc_launches)
    got = fwd_fn(*args, mask_seed, **kw)
    ref = mlt.fused_mol_loss_forward_reference(*args, mask_seed, **kw)
    err = (got - ref).abs().max().item()
    if dtype_name == "float32":
        rtol, atol = K2_TOL_F32
        fwd_use = ((got - ref).abs() / (atol + rtol * ref.abs())).max().item()
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
        fwd_verdict, grad_tol = f"rtol {rtol}, atol {atol}: {fwd_use:.3f} of it", GRAD_REL_TOL
    else:
        fwd_tol, grad_tol = K5_BF16_TOL
        fwd_share = rel_err(got, ref)
        fwd_use = fwd_share / fwd_tol
        if fwd_share > fwd_tol:
            raise AssertionError(f"K5 {dtype_name} forward outside {fwd_tol}: {fwd_share}")
        fwd_verdict = f"max|err|/max|plain| {fwd_share:.2e} <= {fwd_tol}"
    cot = torch.randn(m, r, generator=torch.Generator(device=device).manual_seed(seed + 1),
                      device=device)
    grads = bwd_fn(*args, mask_seed, cot, **kw)
    if (fwd_fn.tc_launches - before[0], bwd_fn.tc_launches - before[1]) != (int(tc), int(tc)):
        raise AssertionError(f"K5 {what} {dtype_name}: tc_route says {tc}, the wrappers "
                             f"launched {fwd_fn.tc_launches - before[0]} / "
                             f"{bwd_fn.tc_launches - before[1]} on the tensor cores")
    again = bwd_fn(*args, mask_seed, cot, **kw)
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"K5 {what} {dtype_name}: two backward calls differ")
    del again
    ref_grads = mlt.fused_mol_loss_backward_reference(*args, mask_seed, cot, **kw)
    if any(a.dtype != b.dtype for a, b in zip(grads, ref_grads)):
        raise AssertionError("K5 gradients and plain gradients differ in dtype")
    grad_errs = {k: rel_err(a.float(), b.float()) for k, a, b in zip(K5_NAMES, grads, ref_grads)}
    bwd_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(grads, ref_grads))
    if max(grad_errs.values()) > grad_tol:
        raise AssertionError(f"K5 gradients outside {grad_tol}: {grad_errs}")
    del got, ref, grads, ref_grads
    torch.cuda.empty_cache()
    dt = "f32" if dtype_name == "float32" else "bf16"
    head = (f"[K5] {what} {dt} M={m} R={r} MoL {p_q}x{p_x}x{d_p} H={hd} dropout softmax "
            f"{pi_rate} / qi {qi_rate}, route {route}")
    grad_text = (f"gradient max|err|/max|plain| "
                 + ", ".join(f"{k} {v:.2e}" for k, v in grad_errs.items())
                 + f" (<= {grad_tol})")
    if not timed:
        print(f"{head}, seed {seed}: forward {fwd_verdict}; {grad_text}", flush=True)
        return fwd_use, max(grad_errs.values()) / grad_tol

    def fwd_call():
        return fwd_fn(*args, mask_seed, **kw)

    def bwd_call():
        return bwd_fn(*args, mask_seed, cot, **kw)

    fwd_ms = cuda_ms(fwd_call)
    fwd_plain_ms = cuda_ms(lambda: mlt.fused_mol_loss_forward_reference(*args, mask_seed, **kw),
                           iters=3, warmup=1)
    bwd_ms = cuda_ms(bwd_call, iters=5)
    bwd_plain_ms = cuda_ms(
        lambda: mlt.fused_mol_loss_backward_reference(*args, mask_seed, cot, **kw), iters=2,
        warmup=1)
    pairs = m * r
    fwd_flops = pairs * (2 * l * d_p + 4 * l * hd)      # component logits + the qi MLP
    # d q and d item (2 x 2 L d_P), d_h, d t_in, dW1 and dW2 (4 x 2 L H) per pair.
    bwd_flops = pairs * (4 * l * d_p + 8 * l * hd)
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    sfu = pairs * mol_sfu_per_pair(l, hd)
    rate = "tf32x3" if tc and dtype_name == "float32" else dtype_name
    bds = []
    for fn, ms_, flops, nbytes in ((fwd_call, fwd_ms, fwd_flops, in_bytes + 4 * pairs),
                                   (bwd_call, bwd_ms, bwd_flops, 2 * in_bytes + 4 * pairs)):
        bd = bound(flops, nbytes, rate, sfu, busy_sm_clock_hz(fn, ms_))
        bd["f32_cores_ms"] = flops / PEAK_FLOPS["float32"] * 1e3
        bds.append(bd)
    fwd_bd, bwd_bd = bds
    print(f"{head}: forward max|err| {err:.3e} ({fwd_verdict}); {grad_text}; two backward "
          f"calls bit-equal", flush=True)

    def bound_text(bd, flops):
        at = (f", {bd['f32_cores_ms']:.4f} ms at the CUDA cores' 67 TFLOP/s"
              if rate == "tf32x3" else "")
        return (f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}; {flops / 1e9:.1f} GFLOP at "
                f"{'3xTF32' if rate == 'tf32x3' else dt}, {sfu / 1e6:.1f}M MUFU{at})")

    print(f"[K5] {what} {dt} forward kernel {fwd_ms:.3f} ms, plain {fwd_plain_ms:.3f} ms, "
          f"{bound_text(fwd_bd, fwd_flops)}; backward kernel {bwd_ms:.3f} ms, plain "
          f"{bwd_plain_ms:.3f} ms, {bound_text(bwd_bd, bwd_flops)}", flush=True)
    keys = ("bound_ms", "bound_by")
    fwd = {"max_abs_err": err, "ms": fwd_ms, "plain_ms": fwd_plain_ms,
           **{k: fwd_bd[k] for k in keys}, "library_ms": None}
    bwd = {"max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
           **{k: bwd_bd[k] for k in keys}, "library_ms": None}
    return fwd, bwd


K6_KERNELS = ("count_kernel", "chunk_scan_kernel", "scan_kernel", "rank_kernel", "place_kernel",
              "sum_kernel")


def check_k6(device, ids, num_rows: int = NUM_ITEMS + 1, d: int = D,
             long_sums: bool = False) -> dict:
    """K6 on the (B, N) ids of a batch (padding included) into the
    (num_rows, d) f32 table, and on a small case with duplicate, negative and
    out-of-range ids; two calls bit-equal, one launch each, and every device
    operation of a call the kernel's own; `index_add_` is timed on the same
    rows as a yardstick. With `long_sums` (rows of thousands of nonzero
    updates) each element is held to the recursive-summation bound of its
    row, 2 n_t 2^-24 sum|x| (as tests/test_torch_port_gpu.py holds K6), in
    place of K6_TOL."""
    import torch

    from rails_tpu_torch.ops.scatter_add import scatter_add_rows, scatter_add_rows_reference

    g = torch.Generator(device=device).manual_seed(6)
    # Zero at padding ids, as in the step's cotangent: padded positions carry
    # no gradient, so each table row sums only its item's few occurrences.
    rows = (torch.randn(tuple(ids.shape) + (d,), generator=g, device=device)
            * (ids != 0)[..., None])
    before = scatter_add_rows.launches
    got = scatter_add_rows(ids, rows, num_rows)
    again = scatter_add_rows(ids, rows, num_rows)
    if scatter_add_rows.launches != before + 2:
        raise AssertionError("K6: a call must be one launch")
    if not torch.equal(got, again):
        raise AssertionError("K6: two calls on the same inputs differ")
    ref = scatter_add_rows_reference(ids, rows, num_rows)
    err = (got - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    if long_sums:
        flat = ids.reshape(-1).long()
        mass = torch.zeros(num_rows, d, dtype=torch.float64, device=device).index_add_(
            0, flat, rows.reshape(-1, d).double().abs())
        count = torch.bincount(flat, minlength=num_rows).double()[:, None]
        within = bool(((got - ref).double().abs() <= 2 * count * 2.0**-24 * mass).all())
        tol_text = "<= 2 n_t 2^-24 sum|x| per element"
    else:
        within = err <= K6_TOL * scale
        tol_text = f"<= {K6_TOL} x max(1, max|plain|) = {K6_TOL * scale:.3e}"
    small_ids = torch.tensor([3, 3, -1, 9, 10, -11, 0, 3, 12, -12], dtype=torch.int32,
                             device=device)
    small_rows = torch.randn(10, 40, generator=g, device=device)
    edge_err = (scatter_add_rows(small_ids, small_rows, 11)
                - scatter_add_rows_reference(small_ids, small_rows, 11)).abs().max().item()
    if not within or edge_err > K6_TOL:
        raise AssertionError(f"K6 differs from its plain version: {err} (scale {scale}), "
                             f"edge case {edge_err}")
    ms = cuda_ms(lambda: scatter_add_rows(ids, rows, num_rows))
    plain_ms = cuda_ms(lambda: scatter_add_rows_reference(ids, rows, num_rows))
    flat, src = ids.reshape(-1).long(), rows.reshape(-1, d)

    def library():
        torch.zeros(num_rows, d, device=device).index_add_(0, flat, src)

    library_ms = cuda_ms(library)
    host = host_us(lambda: scatter_add_rows(ids, rows, num_rows))
    library_host = host_us(library)
    calls = torch_calls(lambda: scatter_add_rows(ids, rows, num_rows))
    bad = [c for c in calls if c in K6_FORBIDDEN or any(k in c for k in K6_FORBIDDEN[:3])]
    if bad:
        raise AssertionError(f"K6 called torch ops besides its kernel: {bad}")
    stages = own_stages(device_timeline(lambda: scatter_add_rows(ids, rows, num_rows)),
                        K6_KERNELS)
    bd = bound(0, 4 * (ids.numel() * (d + 1) + num_rows * d), "float32")
    distinct, padding = int(torch.unique(flat).numel()), int((flat == 0).sum())
    print(f"[K6] ids {tuple(ids.shape)} ({distinct} distinct, {padding} padding) into "
          f"({num_rows}, {d}) f32: "
          f"max|err| {err:.3e} ({tol_text}), "
          f"duplicate/negative/out-of-range case {edge_err:.3e} (<= {K6_TOL}), two calls "
          f"bit-equal; kernel {ms:.4f} ms ({stages}; host {host:.1f} us a call), plain "
          f"{plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms (host {library_host:.1f} us a "
          f"call), bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": library_ms}


def bound_inputs(b: int, x: int, dtype, device, seed: int = 8, geom: tuple = ML20M_GEOM):
    """K2-K10 operands (q, qp, items, ip, w, T) over x items: l2-normalised
    P_Q / P_X x d_P components of `geom`, random gating partials and a random
    qi MLP of 128 hidden units, made on the card."""
    import torch

    from rails_tpu_torch.ops.mol_scoring import MoLKernelWeights, prepare_fused_tables
    from rails_tpu_torch.similarity.layers import l2_normalize

    g = torch.Generator(device=device).manual_seed(seed)
    p_q, p_x, d_p = geom
    l, hd = p_q * p_x, 128

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    tables = prepare_fused_tables(l2_normalize(randn(x, p_x, d_p)).to(dtype),
                                  randn(x, l).to(dtype))
    w = MoLKernelWeights(randn(l, hd) / l ** 0.5, 0.1 * randn(hd), randn(hd, l) / hd ** 0.5,
                         0.1 * randn(l))
    q = l2_normalize(randn(b, p_q, d_p)).to(dtype)
    return (q, randn(b, l), tables.item_comp_t, tables.item_partial_t, w, TEMPERATURE)


def check_bounds(device, b: int = APPROX_BATCH, x: int = APPROX_ITEMS,
                 geom: tuple = ML20M_GEOM) -> dict:
    """K8, K9 and K10 at B x X (B=32 over 1,048,576 items by default), f32,
    bf16 and int8 tables (the bf16 ones quantized): each against its plain
    version (int8 K8 and K9 to 1e-5 of their largest value: f32 sums of exact
    products), on the route `bounds_route` / `mol_route` names, counted on
    `.tc_launches`; K8 above K2's score everywhere up to F32_MARGIN (the f32
    rounding of K2's mixture; K8's logits are K2's); K9's max over l equal to
    K8's per-tile max bit for bit; K10 bit-equal to K2's columns of its
    tiles. Returns the bf16 and int8 entries of the kernel summary."""
    import torch

    from rails_tpu_torch.ops import mol_scoring as ms

    p_q, p_x, d_p = geom
    l, hd = p_q * p_x, 128
    rtol, atol = K2_TOL_F32
    out = {}
    for kind in ("float32", "bfloat16", "int8"):
        args = bound_inputs(b, x, torch.float32 if kind == "float32" else torch.bfloat16,
                            device, geom=geom)
        if kind == "int8":
            args = quantized(args)
        q, qp, items, ip, w, t = args[:6]
        cs = args[6] if kind == "int8" else None
        peak = "float32" if kind == "float32" else "bfloat16"
        xp = items.shape[2]
        nb = xp // ms.BLOCK_X
        k2 = ms.fused_mol_scores_t(*args)
        rel = F32_MARGIN
        route = bounds_route(geom, items.dtype)
        comp_bytes = (q.numel() * q.element_size() + items.numel() * items.element_size()
                      + (4 * cs.numel() if cs is not None else 0))

        def close(got, ref, what):
            if kind == "int8":
                err = rel_err(got, ref)
                if err > 1e-5:
                    raise AssertionError(f"{what} int8 differs from its plain version by {err}")
                return "max|err|/max|plain| <= 1e-5"
            torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
            return f"rtol {rtol}, atol {atol}"

        ub, tc8 = tc_launched(ms.fused_mol_ub_t, lambda: ms.fused_mol_ub_t(q, items, t, cs))
        if tc8 != (route == "tensor cores"):
            raise AssertionError(f"K8 {kind}: {tc8} tensor-core launches off its route")
        ub_ref = ms.fused_mol_ub_t_reference(q, items, t, cs)
        verdict = close(ub, ub_ref, "K8")
        slack = (ub + rel * torch.maximum(ub.abs(), k2.abs()) - k2).min().item()
        if slack < 0:
            raise AssertionError(f"K8 {kind}: the bound sits {-slack} below K2's score")
        k8 = {"max_abs_err": (ub - ub_ref).abs().max().item(),
              "ms": cuda_ms(lambda: ms.fused_mol_ub_t(q, items, t, cs)),
              "plain_ms": cuda_ms(lambda: ms.fused_mol_ub_t_reference(q, items, t, cs), iters=3,
                                  warmup=1),
              **bound(2 * b * xp * l * d_p, comp_bytes + 4 * b * xp, peak), "library_ms": None}
        print(f"[K8] {kind} tables B={b} X={xp} MoL {p_q}x{p_x}x{d_p}, {route} (.tc_launches "
              f"+{tc8} a call): max|err| "
              f"{k8['max_abs_err']:.3e} ({verdict}); UB + {rel:.2e} x max(|UB|, "
              f"|score|) >= K2's score for all {b * xp} pairs (min slack {slack:.3e}); kernel "
              f"{k8['ms']:.3f} ms, plain {k8['plain_ms']:.3f} ms, bound {k8['bound_ms']:.4f} ms "
              f"({k8['bound_by']})")

        gm, tc9 = tc_launched(ms.fused_mol_group_block_max,
                              lambda: ms.fused_mol_group_block_max(q, items, t, cs))
        if tc9 != (route == "tensor cores"):
            raise AssertionError(f"K9 {kind}: {tc9} tensor-core launches off its route")
        gm_ref = ms.fused_mol_group_block_max_reference(q, items, t, cs)
        verdict = close(gm, gm_ref, "K9")
        if not torch.equal(gm.amax(dim=1), ub.reshape(b, nb, ms.BLOCK_X).amax(dim=2)):
            raise AssertionError(f"K9 {kind}: the max over l differs from K8's per-tile max")
        k9 = {"max_abs_err": (gm - gm_ref).abs().max().item(),
              "ms": cuda_ms(lambda: ms.fused_mol_group_block_max(q, items, t, cs)),
              "plain_ms": cuda_ms(lambda: ms.fused_mol_group_block_max_reference(q, items, t, cs),
                                  iters=3, warmup=1),
              **bound(2 * b * xp * l * d_p, comp_bytes + 4 * b * l * nb, peak),
              "library_ms": None}
        print(f"[K9] {kind} tables B={b} X={xp} MoL {p_q}x{p_x}x{d_p} ({nb} tiles of "
              f"{ms.BLOCK_X}), {route} (.tc_launches +{tc9} a call): max|err| "
              f"{k9['max_abs_err']:.3e} ({verdict}); max over l bit-equal to K8's per-tile "
              f"max; kernel {k9['ms']:.3f} ms, plain {k9['plain_ms']:.3f} ms, "
              f"bound {k9['bound_ms']:.4f} ms ({k9['bound_by']})")

        gen = torch.Generator(device=device).manual_seed(10)
        tiles = torch.randint(0, nb, (K10_TILES,), generator=gen, device=device,
                              dtype=torch.int32)
        tiles[0], tiles[2] = nb - 1, tiles[1]          # the last tile and a duplicate
        distinct = int(torch.unique(tiles).numel())
        tile_args = (q, qp, tiles, *args[2:])
        sc, tc10 = tc_launched(ms.fused_mol_scores_tiles,
                               lambda: ms.fused_mol_scores_tiles(*tile_args))
        if tc10 != (mol_route(geom, items.dtype) == "tensor cores"):
            raise AssertionError(f"K10 {kind}: {tc10} tensor-core launches off its route")
        cols = (tiles.long()[:, None] * ms.BLOCK_X
                + torch.arange(ms.BLOCK_X, device=device)).reshape(-1)
        if not torch.equal(sc, k2[:, cols]):
            raise AssertionError(f"K10 {kind} differs from K2's columns of the same tiles")
        sc_ref = ms.fused_mol_scores_tiles_reference(*tile_args)
        if kind == "float32":
            torch.testing.assert_close(sc, sc_ref, rtol=rtol, atol=atol)
            verdict = f"rtol {rtol}, atol {atol}"
        else:
            verdict = bf16_contract(sc, sc_ref, f"K10 {kind}")
        cols_n = K10_TILES * ms.BLOCK_X
        per_col = (p_x * d_p + l) * items.element_size() + (4 * (p_x + 1) if cs is not None else 0)
        k10_ms = cuda_ms(lambda: ms.fused_mol_scores_tiles(*tile_args))
        k10 = {"max_abs_err": (sc - sc_ref).abs().max().item(), "ms": k10_ms,
               "plain_ms": cuda_ms(lambda: ms.fused_mol_scores_tiles_reference(*tile_args),
                                   iters=3, warmup=1),
               **mol_bound(lambda: ms.fused_mol_scores_tiles(*tile_args), k10_ms,
                           cols_n * b, 2 * l * d_p + 4 * l * hd,
                           distinct * ms.BLOCK_X * per_col + q.numel() * q.element_size()
                           + 4 * (b * l + 2 * l * hd + hd + l + K10_TILES + b * cols_n), peak,
                           mol_sfu_per_pair(l, hd)),
               "library_ms": None}
        print(f"[K10] {kind} tables B={b} MoL {p_q}x{p_x}x{d_p} T={K10_TILES} tiles ({distinct} "
              f"distinct, the last tile and a duplicate) of X={xp}, "
              f"{mol_route(geom, items.dtype)} (.tc_launches +{tc10} a call): bit-equal to K2's "
              f"columns of the same tiles; vs "
              f"plain max|err| {k10['max_abs_err']:.3e} ({verdict}); kernel {k10['ms']:.3f} ms, "
              f"device {k10['device_us']:.2f} us, plain {k10['plain_ms']:.3f} ms, bound "
              f"{k10['bound_ms']:.4f} ms ({k10['bound_by']})")
        if kind == "bfloat16":
            out.update({"K8": k8, "K9": k9, "K10": k10})
        elif kind == "int8":
            out.update({"K8-int8": k8, "K9-int8": k9, "K10-int8": k10})
        del args, q, qp, items, ip, w, cs, k2, ub, ub_ref, gm, gm_ref, sc, sc_ref, tile_args
        torch.cuda.empty_cache()
    return out


def check_k2_blockmax(device, b: int = APPROX_BATCH, x: int = APPROX_ITEMS - 1,
                      geom: tuple = ML20M_GEOM, invalid: tuple = BMAX_INVALID) -> dict:
    """K2's emit_blockmax at B x X over bf16 tables (B=32 over 1,048,575 items,
    one pad column at the end, by default), with `invalid` valid=0 in
    mid-corpus: the scores bit-equal to K2's with those columns and the pad
    tail at -1e30, the (B, X/256) maxima equal to theirs exactly, the plain
    version by K2's bf16 contract; kernel ms with and without the option."""
    import torch

    from rails_tpu_torch.ops import mol_scoring as ms

    args = bound_inputs(b, x, torch.bfloat16, device, geom=geom)
    xp = args[2].shape[2]
    valid = torch.ones(x, device=device)
    valid[list(invalid)] = 0.0
    k2 = ms.fused_mol_scores_t(*args)
    scores, tile_max = ms.fused_mol_scores_t(*args, emit_blockmax=True, valid=valid)
    keep = torch.zeros(xp, device=device)
    keep[: valid.shape[0]] = valid
    masked = torch.where(keep != 0, k2, ms.MASKED_SCORE)
    if not torch.equal(scores, masked):
        raise AssertionError("K2-bmax scores differ from K2's with the invalid columns masked")
    if not torch.equal(tile_max, scores.reshape(b, xp // ms.BLOCK_X, ms.BLOCK_X).amax(dim=2)):
        raise AssertionError("K2-bmax tile maxima differ from the maxima of its scores")
    ref_scores, ref_max = ms.fused_mol_scores_t_reference(*args, emit_blockmax=True, valid=valid)
    verdict = bf16_contract(scores, ref_scores, "K2-bmax")
    if not torch.equal(ref_max, ref_scores.reshape(b, -1, ms.BLOCK_X).amax(dim=2)):
        raise AssertionError("the plain K2-bmax maxima differ from the maxima of its scores")
    ms_bmax = cuda_ms(lambda: ms.fused_mol_scores_t(*args, emit_blockmax=True, valid=valid))
    ms_plain_k2 = cuda_ms(lambda: ms.fused_mol_scores_t(*args))
    plain_ms = cuda_ms(lambda: ms.fused_mol_scores_t_reference(*args, emit_blockmax=True,
                                                               valid=valid), iters=3, warmup=1)
    p_q, p_x, d_p = geom
    l, hd = p_q * p_x, 128
    nbytes = (table_bytes(args) + 4 * (b * l + 2 * l * hd + hd + l) + 4 * xp
              + 4 * b * (xp + xp // ms.BLOCK_X))
    bd = mol_bound(lambda: ms.fused_mol_scores_t(*args, emit_blockmax=True, valid=valid),
                   ms_bmax, b * xp, 2 * l * d_p + 4 * l * hd, nbytes, "bfloat16",
                   mol_sfu_per_pair(l, hd))
    print(f"[K2-bmax] bf16 tables B={b} X={xp} MoL {p_q}x{p_x}x{d_p} ({valid.shape[0]} items, "
          f"valid=0 at {list(invalid)} and the pad tail), {mol_route(geom, torch.bfloat16)}: "
          f"scores bit-equal to K2's with them at -1e30, "
          f"({b}, {xp // ms.BLOCK_X}) tile maxima exact; vs plain {verdict}; kernel "
          f"{ms_bmax:.3f} ms with emit_blockmax (device {bd['device_us']:.2f} us), "
          f"{ms_plain_k2:.3f} ms without; plain "
          f"{plain_ms:.3f} ms; bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    err = (scores - ref_scores).abs().max().item()
    return {"max_abs_err": err, "ms": ms_bmax, "plain_ms": plain_ms, **bd, "library_ms": None}


def approx_model(device):
    """ml-20m-hstu-mol in bf16 (seeded random weights) and the query
    embeddings and user ids of one batch of 32 ML-20M-shaped users."""
    import torch

    from rails_tpu_torch.core.config import get_experiment_config
    from rails_tpu_torch.data.datasets import SequenceDataset, generate_synthetic_sequences
    from rails_tpu_torch.models.encoder import SequentialRecommender

    cfg = get_experiment_config("ml-20m-hstu-mol")
    cfg = cfg.replace(hstu=cfg.hstu.replace(fused_inference=True),
                      train=cfg.train.replace(main_module_bf16=True, eval_bf16=True))
    model = SequentialRecommender(cfg, NUM_ITEMS, compute_dtype=torch.bfloat16, device=device,
                                  generator=torch.Generator().manual_seed(0))
    seqs = generate_synthetic_sequences(num_users=4 * APPROX_BATCH, num_items=NUM_ITEMS,
                                        max_len=200, seed=3, length_distribution="ml20m")
    ds = SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1)
    batch = next(ds.batches(APPROX_BATCH, cfg.train.gr_output_length + 1, shuffle=False,
                            device=device))
    return model, model.encode(batch.features), batch.features.user_ids


def approx_setup(device):
    """`approx_model`, the frontier's clustered corpus emb(i) = table[(i-1) %
    26,744] + 0.5 rms eps(i) over APPROX_ITEMS items with its bf16 standard,
    fused and avg tables, and the query embeddings of the batch."""
    import torch

    from rails_tpu_torch.index.top_k import build_mol_topk_state

    model, q, uids = approx_model(device)
    ids = torch.arange(1, APPROX_ITEMS + 1, dtype=torch.int32, device=device)
    g = torch.Generator(device=device).manual_seed(2)
    base = model.get_item_embeddings((ids - 1) % NUM_ITEMS + 1).float()
    emb = base + CLUSTER_SIGMA * base.pow(2).mean().sqrt() * torch.randn(
        base.shape, generator=g, device=device)
    del base
    state = build_mol_topk_state(model, ids, emb, torch.bfloat16, build_fused=True)
    return model, state, emb, q, uids


def clustered_chunk_fn(model, device):
    """The frontier's embed_chunk_fn over the clustered corpus: emb(i) =
    table[(i-1) % 26,744] + 0.5 rms eps(i), the noise of a chunk drawn from a
    generator seeded with the chunk's start, so that the build and the oracle
    see the same corpus whenever they chunk alike."""
    import torch

    table = model.get_item_embeddings(torch.arange(1, NUM_ITEMS + 1, device=device)).float()
    sigma = CLUSTER_SIGMA * table.pow(2).mean().sqrt()

    def embed(start: int, ids):
        base = model.get_item_embeddings((ids - 1) % NUM_ITEMS + 1).float()
        g = torch.Generator(device=device).manual_seed(start)
        return base + sigma * torch.randn(base.shape, generator=g, device=device)

    return embed


def state_gib(state) -> float:
    """Device memory of a top-k state's tensors, GiB."""
    import torch

    def tensors(obj):
        if isinstance(obj, torch.Tensor):
            yield obj
        elif isinstance(obj, tuple):
            for o in obj:
                yield from tensors(o)

    return sum(t.numel() * t.element_size() for t in tensors(state)) / 2**30


def check_against_oracle(model, state, res, k2_scores, oracle, q, uids) -> tuple:
    """The exact bf16 path against the streamed oracle, tie-aware. The oracle
    scores with the model's plain bf16 path, K2 with its kernel; the two
    differ by bf16 rounding, so the sorted score lists of the two top-k's are
    held within twice the scorers' largest difference on their items (delta:
    the oracle's items through K2, the returned items through the plain
    path), relative to each row's largest score: the i-th largest of one
    scorer is within delta of the other's. Returns (delta, dev)."""
    import torch

    from rails_tpu_torch.index import top_k as tk

    scale = oracle.scores.abs().amax(dim=1, keepdim=True)
    d_oracle = (oracle.scores - k2_scores.gather(1, oracle.ids.long() - 1)).abs() / scale
    idx = res.ids.long() - 1
    comp, gp = tk._gathered_candidate_tables(state, idx)
    plain = model.score_gathered(q, comp, gp, uids).float()
    d_res = (res.scores - plain).abs() / scale
    delta = max(d_oracle.max().item(), d_res.max().item())
    dev = ((res.scores - oracle.scores).abs() / scale).max().item()
    if dev > 2 * delta + 1e-5:
        raise AssertionError(f"the exact path misses the oracle's top-k: dev {dev:.3e} > "
                             f"2 x delta {delta:.3e}")
    return delta, dev


def timed(call) -> tuple:
    """call()'s result, the launches of that first call (nonzero counts), and
    its host-clock ms: the median of 3 synchronised runs after the first."""
    import torch

    reset_launches()
    res = call()
    torch.cuda.synchronize()
    counts = {key: v for key, v in launch_counts().items() if v}
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return res, counts, statistics.median(times)


def int8_phase(device, name: str, smi: str) -> dict:
    """The at-scale path at INT8_ITEMS items: bf16 and int8 states from the
    chunked on-device builder, the streamed oracle, the exact bf16 path
    through K2-bmax and hierarchical_top_k, and the INT8_METHODS. Returns the
    launches of the K2-bmax, K9-int8 and K10-int8 variants on their paths."""
    import torch

    from rails_tpu_torch.index import top_k as tk
    from rails_tpu_torch.index.factory import get_top_k_raw, parse_top_k_budgets
    from rails_tpu_torch.index.oracle import streamed_exact_top_k
    from rails_tpu_torch.ops.mol_scoring import extract_gating_qi_weights, fused_mol_scores_t

    model, q, uids = approx_model(device)
    embed = clustered_chunk_fn(model, device)
    ids = torch.arange(1, INT8_ITEMS + 1, dtype=torch.int32, device=device)
    states, build_s = {}, {}
    for kind, quantize in (("bf16", False), ("int8", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states[kind] = tk.build_fused_state_chunked_on_device(
            model, ids, embed, tk.BUILD_CHUNK, torch.bfloat16, quantize=quantize)
        torch.cuda.synchronize()
        build_s[kind] = time.perf_counter() - t0
    t0 = time.perf_counter()
    o_scores, o_ids = streamed_exact_top_k(model, states["bf16"], q, uids, APPROX_K,
                                           embed_chunk_fn=embed, chunk=tk.BUILD_CHUNK)
    oracle_s = time.perf_counter() - t0
    oracle = tk.TopKResult(torch.from_numpy(o_scores).to(device),
                           torch.from_numpy(o_ids).to(device))
    print(f"[int8] ml-20m-hstu-mol bf16, clustered corpus of {INT8_ITEMS} items (the frontier's "
          f"4M size; build chunk {tk.BUILD_CHUNK}), B={q.shape[0]}, k={APPROX_K}: build bf16 "
          f"{build_s['bf16']:.2f} s ({state_gib(states['bf16']):.3f} GiB), int8 "
          f"{build_s['int8']:.2f} s ({state_gib(states['int8']):.3f} GiB); streamed oracle "
          f"{oracle_s:.2f} s on {name} ({smi})")

    def k2_of(state):
        ft = state.fused_tables
        return fused_mol_scores_t(
            tk._query_comp(model, ft, q, uids), model.query_gating_partial(q), ft.item_comp_t,
            ft.item_partial_t, extract_gating_qi_weights(model.mol), TEMPERATURE, ft.comp_scale,
            ft.partial_scale, emit_blockmax=True, valid=state.item_ids != 0)

    def report(method, res, ms_, counts) -> str:
        overlap = id_overlap(res.ids, oracle.ids)
        recall = (res.ids == oracle.ids[:, :1]).any(dim=1).float().mean().item()
        return (f"[int8] {method}: {ms_:.3f} ms/batch, top-{APPROX_K} overlap with the oracle "
                f"{overlap:.4f}, recall@{APPROX_K} of the oracle's top-1 {recall:.4f}, launches "
                f"{counts}")

    launches = {}
    res, counts, ms_ = timed(lambda: get_top_k_raw("MoLBruteForceTopKFused")(
        model, states["bf16"], q, APPROX_K, uids))
    launches["K2-bmax"] = counts.get("K2-bmax", 0)
    scores, tile_max = k2_of(states["bf16"])
    scores = scores[:, :INT8_ITEMS]
    hv, _ = tk.hierarchical_top_k(scores, APPROX_K, tile_max=tile_max)
    tv, _ = torch.topk(scores, APPROX_K, dim=1)
    if not (torch.equal(hv, tv) and torch.equal(res.scores, tv)):
        raise AssertionError("the hierarchical select differs from torch.topk of the same scores")
    h_ms = cuda_ms(lambda: tk.hierarchical_top_k(scores, APPROX_K, tile_max=tile_max))
    t_ms = cuda_ms(lambda: torch.topk(scores, APPROX_K, dim=1))
    delta, dev = check_against_oracle(model, states["bf16"], res, scores, oracle, q, uids)
    print(report("MoLBruteForceTopKFused", res, ms_, counts)
          + f"; scores bit-equal to torch.topk of the same K2 scores; select "
          f"hierarchical_top_k {h_ms:.3f} ms vs torch.topk {t_ms:.3f} ms; vs the oracle "
          f"tie-aware: dev {dev:.3e} <= 2 x delta {delta:.3e}")
    del scores, tile_max
    torch.cuda.empty_cache()

    int8 = states["int8"]
    ft8, q8 = int8.fused_tables, tk._query_comp(model, int8.fused_tables, q, uids)
    kernel_ms = {
        "K2-bmax bf16": cuda_ms(lambda: k2_of(states["bf16"]), iters=3, warmup=1),
        "K2-bmax int8": cuda_ms(lambda: k2_of(int8), iters=3, warmup=1),
        "K8-int8": cuda_ms(lambda: tk.fused_mol_ub_t(q8, ft8.item_comp_t, TEMPERATURE,
                                                     ft8.comp_scale), iters=3, warmup=1),
        "K9-int8": cuda_ms(lambda: tk.fused_mol_group_block_max(
            q8, ft8.item_comp_t, TEMPERATURE, ft8.comp_scale), iters=3, warmup=1),
    }
    print(f"[int8] device ms of the path's kernels at {INT8_ITEMS} items, B={q.shape[0]}: "
          + ", ".join(f"{key} {v:.3f}" for key, v in kernel_ms.items()))
    k2_8 = k2_of(int8)[0][:, :INT8_ITEMS]
    exact8 = tk.TopKResult(*torch.topk(k2_8, APPROX_K, dim=1))
    exact8 = exact8._replace(ids=exact8.ids + 1)          # corpus ids are positions + 1
    for method in INT8_METHODS:
        raw = get_top_k_raw(method)
        res, counts, ms_ = timed(lambda: raw(model, int8, q, APPROX_K, uids))
        check_tc_route(counts, f"[int8] {method}")
        for key in ("K9-int8", "K10-int8"):
            launches[key] = launches.get(key, 0) + counts.get(key, 0)
        line = report(method, res, ms_, counts)
        if method.startswith("MoLBruteForceTopKFusedInt8"):
            if not torch.equal(res.scores, exact8.scores):
                raise AssertionError(f"{method} differs from torch.topk of K2-int8's scores")
            line += "; scores bit-equal to torch.topk of K2-int8's scores"
        if method.startswith("MoLCertTopK"):
            cres, cert = tk.mol_certified_top_k(model, int8, q, APPROX_K,
                                                parse_top_k_budgets(method)["cand_budget"], uids)
            rate, delta, dev = check_certified(cres, cert, k2_8, exact8)
            line += (f"; certified {rate:.4f} of rows, certified rows exact (K2-int8) up to the "
                     f"scorers' difference: dev {dev:.3e} <= 2 x delta {delta:.3e}")
        print(line)
    if not all(launches.values()):
        raise AssertionError(f"a kernel variant of the at-scale path never launched: {launches}")
    del states, int8, k2_8
    torch.cuda.empty_cache()
    return launches


def int8_e2e(device, name: str, smi: str) -> dict:
    """The serving step on int8 tables: the 3 serving batches of 512 through
    get_eval_state and make_eval_step_fn with E2E_INT8_METHODS, the kernel
    path (launch counts, ms/batch) against the same step through the plain
    versions, and recall_vs_exact against MoLBruteForceTopKFused on bf16
    tables. Returns the launch counts of the kernel-path run."""
    import torch

    from rails_tpu_torch.data.features import Batch
    from rails_tpu_torch.train.evaluation import get_eval_state, make_eval_step_fn, recall_vs_exact

    dtype_name, min_rank_agree, min_overlap = E2E_TOL[0]
    model, exact_es, _, batches = serving_setup(torch.bfloat16, device, 3)
    all_ids = np.arange(1, NUM_ITEMS + 1, dtype=np.int32)
    runs = {}
    for method in E2E_INT8_METHODS:
        es = get_eval_state(model, all_ids, method, table_dtype=torch.bfloat16, device=device)
        if es.topk_state.fused_tables.item_comp_t.dtype != torch.int8:
            raise AssertionError(f"{method}: get_eval_state built no int8 tables")
        step = make_eval_step_fn(model, method, k=120, num_objects=es.num_objects,
                                 filter_invalid_ids=True, truncate_k_prime_to=200)
        runs[method] = (es, step)
        run_batches(lambda f, t, es=es, step=step: step(es.topk_state, f, t), batches)  # warm-up
    reset_launches()
    outs = {m: run_batches(lambda f, t, es=es, step=step: step(es.topk_state, f, t), batches)
            for m, (es, step) in runs.items()}
    counts = launch_counts()
    n = len(batches)
    want = {"K1": len(runs) * n * model.cfg.hstu.num_blocks, "K2": n, "K2-int8": n,
            "K2-bmax": 0, "K8": n, "K8-int8": n}
    if any(counts[key] != v for key, v in want.items()):
        raise AssertionError(f"int8 serving launches {counts}, want {want}")
    check_tc_route(counts, "[int8-e2e]")
    t_batches = [Batch(f, t, torch.zeros_like(t)) for f, t in batches]
    for method, (es, step) in runs.items():
        outs_k, ms_k = outs[method]
        check_outputs(outs_k, batches)
        with plain_kernels():
            outs_p, ms_p = run_batches(lambda f, t: step(es.topk_state, f, t), batches)
        rk, rp = (torch.cat([o[0] for o in o_]) for o_ in (outs_k, outs_p))
        ik, ip = (torch.cat([o[1] for o in o_]) for o_ in (outs_k, outs_p))
        rank_agree = (rk == rp).float().mean().item()
        overlap = id_overlap(ik, ip)
        recall = recall_vs_exact(model, exact_es, es, t_batches, k=APPROX_K)
        print(f"[int8-e2e] {method} {dtype_name} tables quantized, {n} batches of {BATCH}, "
              f"{NUM_ITEMS} items, k=120, k'=200: kernel path {ms_k:.3f} ms/batch, plain path "
              f"{ms_p:.3f} ms/batch on {name} ({smi}); vs plain: ranks agree on "
              f"{rank_agree:.4f} (>= {min_rank_agree}), top-120 overlap {overlap:.4f} "
              f"(>= {min_overlap}); recall_vs_exact (MoLBruteForceTopKFused, bf16) "
              + ", ".join(f"{key} {v:.4f}" for key, v in recall.items()))
        if rank_agree < min_rank_agree or overlap < min_overlap:
            raise AssertionError(f"{method}: the kernel path disagrees with the plain path")
    print(f"[int8-e2e] launches of the kernel-path run of the {len(runs)} methods: "
          f"{ {key: v for key, v in counts.items() if v} }")
    return counts


def frontier_phase(device, name: str, smi: str) -> dict:
    """The port's frontier CLI (`rails_tpu_torch.cli.frontier`) through its
    own functions at FRONTIER_ITEMS items: the bf16 pre-train (the loss must
    fall: the mean of the last 10 steps below the first 10), the chunked
    bf16 build, the queries through the XLA-path encoder, the streamed
    oracle, every default method (the IVF index built before the first IVF
    method, its `ivf_build` row printed; IVF recall beside the JAX package's,
    not gated); then the int8 build of the same corpus and
    FRONTIER_INT8_METHODS with `--int8`. Gates: the exact bf16 path against
    the oracle tie-aware (`check_against_oracle`), the exact int8 path equal
    to torch.topk of K2-int8's scores, and every certified row holding K2's
    exact top-k (`check_certified`). Recall is printed, not gated. Returns the
    launches of the whole phase."""
    import torch

    from rails_tpu_torch.cli import frontier as fr
    from rails_tpu_torch.index import top_k as tk
    from rails_tpu_torch.ops.mol_scoring import extract_gating_qi_weights, fused_mol_scores_t
    from rails_tpu_torch.train.loop import make_optimizer

    args = fr.parse_args(["--num-items", str(FRONTIER_ITEMS), "--train-steps",
                          str(FRONTIER_STEPS), "--runs", str(FRONTIER_RUNS)])
    methods = fr.check_ported(args)
    cfg = fr.configure(args)
    ds = fr.synthetic_dataset(cfg)
    k, x = args.k, args.num_items
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, losses = fr.pretrain(cfg, ds, args.train_steps, device)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    counts = launch_counts()
    want = {key: v * len(losses)
            for key, v in step_launches(cfg, model, make_optimizer(cfg, model)).items()}
    if counts != want:
        raise AssertionError(f"frontier pre-train launches {counts}, want {want}")
    for k4 in ("K4 fwd", "K4 bwd"):
        if counts[f"{k4}-tc"] != counts[f"{k4} (bf16)"] or not counts[f"{k4}-tc"]:
            raise AssertionError(f"frontier pre-train: {counts[f'{k4} (bf16)']} bf16 {k4} "
                                 f"launches, {counts[f'{k4}-tc']} of them on the tensor cores")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"[frontier] pre-train {cfg.name} bf16, B={args.batch_size}, {len(losses)} steps over "
          f"{cfg.data.synthetic_num_users} synthetic users ({cfg.data.synthetic_num_items} items): "
          f"loss first-10 mean {first:.4f}, last-10 mean {last:.4f}; {pre_s:.2f} s = "
          f"{1e3 * pre_s / len(losses):.3f} ms/step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{ {key: v for key, v in counts.items() if v} } on {name} ({smi})")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"the frontier pre-train loss did not fall: {losses}")
    phase_counts = dict(counts)

    with torch.inference_mode():
        embed = fr.clustered_embed_fn(model, cfg.data.synthetic_num_items, args.cluster_sigma)
        batch = next(ds.batches(args.batch_size, cfg.train.gr_output_length + 1, shuffle=False,
                                device=device))
        reset_launches()
        q, uids = model.encode(batch.features), batch.features.user_ids
        if launch_counts()["K1"]:
            raise AssertionError("the frontier's encoder (fused_inference=False) launched K1")
        oracle = oracle_t = None
        for kind, methods_ in (("bf16", methods), ("int8", FRONTIER_INT8_METHODS)):
            int8 = kind == "int8"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = fr.build_corpus(model, x, embed, int8, device)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            line = (f"[frontier] {kind} tables of a clustered corpus of {x} items (sigma "
                    f"{args.cluster_sigma}, build chunk {tk.BUILD_CHUNK}), B={q.shape[0]}, k={k}: "
                    f"build {build_s:.2f} s, state {state_gib(state):.3f} GiB")
            if oracle is None:
                t0 = time.perf_counter()
                oracle = fr.exact_oracle(model, state, q, uids, k, embed)
                line += f"; streamed oracle {time.perf_counter() - t0:.2f} s"
                oracle_t = tk.TopKResult(torch.from_numpy(oracle.scores).to(device),
                                         torch.from_numpy(oracle.ids).to(device))
            ft = state.fused_tables
            k2_scores = fused_mol_scores_t(
                tk._query_comp(model, ft, q, uids), model.query_gating_partial(q),
                ft.item_comp_t, ft.item_partial_t, extract_gating_qi_weights(model.mol),
                TEMPERATURE, ft.comp_scale, ft.partial_scale)[:, :x]
            exact = tk.TopKResult(*torch.topk(k2_scores, k, dim=1))
            exact = exact._replace(ids=exact.ids + 1)           # corpus ids are positions + 1
            print(line + f" on {name} ({smi})")
            for method in methods_:
                if method.startswith("MoLIVF") and state.ivf is None:
                    state, row = fr.attach_ivf(state, fr.ivf_nlist(args), args.ivf_iters)
                    print(f"[frontier] {json.dumps(row)} on {name} ({smi})")
                reset_launches()
                row, res, cert = fr.run_method(model, state, q, uids, method, k, args.runs, int8,
                                               oracle, device)
                counts = launch_counts()
                for key, v in counts.items():
                    phase_counts[key] = phase_counts.get(key, 0) + v
                line = f"[frontier] {json.dumps(row)}; launches { {a: v for a, v in counts.items() if v} }"
                if method == "MoLBruteForceTopKFused" and not int8:
                    delta, dev = check_against_oracle(model, state, res, k2_scores, oracle_t, q,
                                                      uids)
                    line += f"; vs the oracle tie-aware: dev {dev:.3e} <= 2 x delta {delta:.3e}"
                elif method == "MoLBruteForceTopKFused":
                    if not torch.equal(res.scores, exact.scores):
                        raise AssertionError("FusedInt8 differs from torch.topk of K2-int8's scores")
                    line += "; scores bit-equal to torch.topk of K2-int8's scores"
                if cert is not None:
                    rate, delta, dev = check_certified(res, cert, k2_scores, exact)
                    line += (f"; certified rows exact (K2{'-int8' if int8 else ''}) up to the "
                             f"scorers' difference: dev {dev:.3e} <= 2 x delta {delta:.3e}")
                if method in JAX_IVF_RECALL:
                    line += (f"; the JAX package's recall@{k} at 8M items (docs/frontier_8m.json): "
                             f"{JAX_IVF_RECALL[method] or 'none, its run failed to compile it'}")
                print(line)
            print(f"[frontier] {kind} sweep peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            del state, ft, k2_scores, exact
            torch.cuda.empty_cache()
    check_tc_route(phase_counts, "[frontier]")
    print(f"[frontier] launches of the phase: { {a: v for a, v in phase_counts.items() if v} }")
    return phase_counts


def check_certified(res, cert, k2_scores, exact) -> tuple:
    """Soundness of a certified method in bf16, tie-aware. The rerank scores
    with the model's bf16 PyTorch path, the exact reference with K2, and the
    two differ by bf16 rounding, so certified rows are held to K2's exact
    top-k through K2's own scores: delta = max |rerank score - K2 score| of
    the returned items (relative to the row's largest exact score), and
    dev = max gap between the K2 scores of the returned items and the exact
    top-k scores, both sorted. A certified row holds dev <= 2 delta (an item
    it misses can outscore the ones it returns only through the scorers'
    difference). Returns (certification rate, delta, dev)."""
    import torch

    rows = cert.certified
    scale = exact.scores.abs().amax(dim=1, keepdim=True)
    k2_of = k2_scores.gather(1, res.ids.long() - 1)       # corpus ids are positions + 1
    delta = ((res.scores - k2_of).abs() / scale).max().item()
    dev_rows = ((torch.sort(k2_of, dim=1, descending=True).values - exact.scores).abs()
                / scale).amax(dim=1)
    dev = dev_rows[rows].max().item() if bool(rows.any()) else 0.0
    if dev > 2 * delta + 1e-5:
        raise AssertionError(f"a certified row misses the exact top-k: dev {dev:.3e} > "
                             f"2 x delta {delta:.3e}")
    return rows.float().mean().item(), delta, dev


def approx_phase(device, name: str, smi: str) -> None:
    """Every ported method on the 1M-item clustered corpus: ms/batch (median
    of 3, host clock), launches, top-200 overlap with the exact ids, recall of
    the exact top-1; certification rate and soundness of the certified ones."""
    import torch

    from rails_tpu_torch.index import top_k as tk
    from rails_tpu_torch.index.factory import get_top_k_raw, parse_top_k_budgets
    from rails_tpu_torch.ops.mol_scoring import extract_gating_qi_weights, fused_mol_scores_t

    model, state, emb, q, uids = approx_setup(device)
    ft, k = state.fused_tables, APPROX_K
    t0 = time.perf_counter()
    k2_scores = fused_mol_scores_t(
        tk._query_comp(model, ft, q, uids), model.query_gating_partial(q), ft.item_comp_t,
        ft.item_partial_t, extract_gating_qi_weights(model.mol), TEMPERATURE,
    )[:, :ft.num_items]
    exact = get_top_k_raw("MoLBruteForceTopKFused")(model, state, q, k, uids)
    torch.cuda.synchronize()
    print(f"[approx] ml-20m-hstu-mol bf16, clustered corpus of {ft.num_items} items (sigma "
          f"{CLUSTER_SIGMA}; the frontier's 8M cut to fit the script's time), B={q.shape[0]}, "
          f"k={k}; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB; exact "
          f"reference (K2) in {1e3 * (time.perf_counter() - t0):.1f} ms on {name} ({smi})")
    for method in APPROX_METHODS:
        raw = get_top_k_raw(method)
        res, counts, ms_ = timed(lambda: raw(model, state, q, k, uids, item_embeddings=emb))
        check_tc_route(counts, f"[approx] {method}")
        overlap = id_overlap(res.ids, exact.ids)
        recall = (res.ids == exact.ids[:, :1]).any(dim=1).float().mean().item()
        line = (f"[approx] {method}: {ms_:.3f} ms/batch, top-{k} overlap "
                f"{overlap:.4f}, recall@{k} of the exact top-1 {recall:.4f}, launches {counts}")
        budgets = parse_top_k_budgets(method)
        if method.startswith(("MoLCertTopK", "MoLTileTopK")):
            if method.startswith("MoLCertTopK"):
                cres, cert = tk.mol_certified_top_k(model, state, q, k, budgets["cand_budget"],
                                                    uids)
            else:
                cres, cert = tk.mol_tile_top_k_shared(
                    model, state, q, k, budgets["tiles_per_group"], uids,
                    tile_budget=budgets.get("tile_budget"), certified=True)
            rate, delta, dev = check_certified(cres, cert, k2_scores, exact)
            line += (f"; certified {rate:.4f} of rows (median gap bound "
                     f"{cert.gap_bound.median().item():.4f}), certified rows exact up to the "
                     f"scorers' difference: dev {dev:.3e} <= 2 x delta {delta:.3e}")
        print(line)
    # Where certification sets in with these weights, and the full-coverage
    # invariant: a budget >= X certifies every row.
    parts = []
    for budget in (1 << 16, 1 << 18, ft.num_items):
        res, cert = tk.mol_certified_top_k(model, state, q, k, budget, uids)
        rate, delta, dev = check_certified(res, cert, k2_scores, exact)
        parts.append(f"{budget}: {rate:.4f} (dev {dev:.3e} <= 2 x delta {delta:.3e})")
    if rate < 1.0:
        raise AssertionError(f"MoLCertTopK with a budget >= X certified only {rate} of rows")
    print("[approx] MoLCertTopK certified share by budget, certified rows exact up to the "
          "scorers' difference: " + "; ".join(parts))


def ivf_phase(device, name: str, smi: str) -> dict:
    """`[ivf]`: IVF on the `[approx]` clustered corpus (bf16 standard and
    fused tables), nlist = max(64, 4 sqrt(X)) as the frontier sets it, with
    the JAX module's invariants as gates: two k-means calls with one seed
    bit-equal; every real position exactly once in buckets + overflow, the
    fill within cap; every list probed = the exact fused path's top-k,
    tie-aware (`check_certified` with every row held); after the
    cluster-order relayout the exact method's scores bit-equal and its ids
    equal wherever scores differ. Prints the build's seconds, IVF8/32 and
    Tile8 on the unordered and the cluster-ordered layout (recall not
    gated). Returns the phase's launches."""
    import types

    import torch

    from rails_tpu_torch.cli import frontier as fr
    from rails_tpu_torch.index import ivf
    from rails_tpu_torch.index import top_k as tk
    from rails_tpu_torch.index.factory import get_top_k_raw
    from rails_tpu_torch.ops.mol_scoring import extract_gating_qi_weights, fused_mol_scores_t

    model, state, emb, q, uids = approx_setup(device)
    del emb
    ft, k, b = state.fused_tables, APPROX_K, q.shape[0]
    x = ft.num_items
    nlist = max(64, int(4 * np.sqrt(x)))
    reset_launches()
    k2_scores = fused_mol_scores_t(
        tk._query_comp(model, ft, q, uids), model.query_gating_partial(q), ft.item_comp_t,
        ft.item_partial_t, extract_gating_qi_weights(model.mol), TEMPERATURE)[:, :x]
    exact = tk.TopKResult(*torch.topk(k2_scores, k, dim=1))
    exact = exact._replace(ids=exact.ids + 1)                  # corpus ids are positions + 1
    valid = state.item_ids != 0
    cents, secs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cents.append(ivf.kmeans(state.avg_component, nlist, chunk=fr.IVF_CHUNK, valid=valid))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    if not torch.equal(*cents):
        raise AssertionError("[ivf] two k-means calls with one seed differ")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index, perm = ivf.build_ivf_index(state.avg_component, state.item_ids, nlist=nlist,
                                      chunk=fr.IVF_CHUNK, mol_state=state,
                                      return_cluster_perm=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if not torch.equal(index.centroids, cents[0]):
        raise AssertionError("[ivf] the index's k-means differs from kmeans with its seed")
    cap = index.buckets.shape[1]
    slots = torch.cat([index.buckets.reshape(-1), index.overflow]).long()
    counts = torch.bincount(slots, minlength=x)
    fill = (index.buckets != 0).sum(dim=1)
    if not (bool((counts[1:] == 1).all()) and counts[0] >= 1 and int(fill.max()) <= cap):
        raise AssertionError(f"[ivf] a real position is not listed exactly once: counts of "
                             f"positions 1.. in {counts[1:].unique().tolist()}, fill max "
                             f"{int(fill.max())} of cap {cap}")
    print(f"[ivf] clustered corpus of {x} items (bf16 standard + fused tables), nlist {nlist}, "
          f"10 Lloyd iterations in chunks of {fr.IVF_CHUNK}: kmeans {secs[0]:.2f} s and "
          f"{secs[1]:.2f} s, bit-equal; build with MoL-aware probes and the cluster order "
          f"{build_s:.2f} s; cap {cap}, fill mean {fill.float().mean().item():.1f} max "
          f"{int(fill.max())}, overflow {int(index.overflow.shape[0])} slots; every position "
          f"listed once on {name} ({smi})")
    st = state._replace(ivf=index)
    t0 = time.perf_counter()
    full = ivf.mol_ivf_top_k(model, st, q, k, nprobe=nlist, user_ids=uids, cand_chunk=1 << 16)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    every_row = types.SimpleNamespace(certified=torch.ones(b, dtype=torch.bool, device=device))
    _, delta, dev = check_certified(full, every_row, k2_scores, exact)
    print(f"[ivf] every list probed ({nlist} x {cap} slots + overflow a query, B={b}, k={k}, "
          f"{full_s:.2f} s): the exact fused top-k up to the scorers' difference, dev "
          f"{dev:.3e} <= 2 x delta {delta:.3e}")
    sp = tk.permute_state_items(st, perm)
    fused = get_top_k_raw("MoLBruteForceTopKFused")
    a, c = fused(model, st, q, k, uids), fused(model, sp, q, k, uids)
    gap = a.scores[:, 1:] != a.scores[:, :-1]
    apart = torch.ones_like(a.scores, dtype=torch.bool)
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    if not (torch.equal(a.scores, c.scores) and torch.equal(a.ids[apart], c.ids[apart])):
        raise AssertionError("[ivf] the exact method's result moved with the cluster order")
    line = (f"[ivf] cluster-order relayout (permute_state_items): the exact fused method's "
            f"scores bit-equal, ids equal on the {apart.float().mean().item():.4f} of places "
            f"whose score is not tied")
    for method in ("MoLIVFTopK8", "MoLIVFTopK32", "MoLTileTopK8"):
        for layout, st_ in (("unordered", st), ("cluster-ordered", sp)):
            if method.startswith("MoLIVF") and layout != "unordered":
                continue
            res, counts_, ms_ = timed(lambda: get_top_k_raw(method)(model, st_, q, k, uids))
            check_tc_route(counts_, f"[ivf] {method}")
            recall = (res.ids == exact.ids[:, :1]).any(dim=1).float().mean().item()
            line += (f"; {method} {layout}: {ms_:.3f} ms/batch, top-{k} overlap "
                     f"{id_overlap(res.ids, exact.ids):.4f}, recall@{k} of the exact top-1 "
                     f"{recall:.4f}")
    print(line)
    return launch_counts()


def approx_e2e(device, name: str, smi: str) -> dict:
    """The serving step with approximate retrieval: the 3 serving batches of
    512 through get_eval_state and make_eval_step_fn, per method the kernel
    path (launch counts, ms/batch) against the same step through the plain
    versions, and recall_vs_exact against MoLBruteForceTopKFused. Returns the
    launch counts of the kernel-path run of all methods."""
    import torch

    from rails_tpu_torch.data.features import Batch
    from rails_tpu_torch.train.evaluation import (
        get_eval_state,
        make_eval_step_fn,
        recall_vs_exact,
    )

    dtype_name, min_rank_agree, min_overlap = E2E_TOL[0]
    model, exact_es, _, batches = serving_setup(torch.bfloat16, device, 3)
    all_ids = np.arange(1, NUM_ITEMS + 1, dtype=np.int32)
    runs = {}
    for method in E2E_APPROX_METHODS:
        es = get_eval_state(model, all_ids, method, table_dtype=torch.bfloat16, device=device)
        step = make_eval_step_fn(model, method, k=120, num_objects=es.num_objects,
                                 filter_invalid_ids=True, truncate_k_prime_to=200)
        runs[method] = (es, step)
        run_batches(lambda f, t, es=es, step=step: step(es.topk_state, f, t), batches)  # warm-up
    reset_launches()
    outs = {m: run_batches(lambda f, t, es=es, step=step: step(es.topk_state, f, t), batches)
            for m, (es, step) in runs.items()}
    counts = launch_counts()
    want = {"K1": 3 * len(batches) * model.cfg.hstu.num_blocks, "K2": 0, "K8": len(batches),
            "K9": len(batches), "K10": len(batches)}
    if any(counts[key] != v for key, v in want.items()):
        raise AssertionError(f"approximate serving launches {counts}, want {want}")
    t_batches = [Batch(f, t, torch.zeros_like(t)) for f, t in batches]
    for method, (es, step) in runs.items():
        outs_k, ms_k = outs[method]
        check_outputs(outs_k, batches)
        with plain_kernels():
            outs_p, ms_p = run_batches(lambda f, t: step(es.topk_state, f, t), batches)
        rk, rp = (torch.cat([o[0] for o in o_]) for o_ in (outs_k, outs_p))
        ik, ip = (torch.cat([o[1] for o in o_]) for o_ in (outs_k, outs_p))
        rank_agree = (rk == rp).float().mean().item()
        overlap = id_overlap(ik, ip)
        recall = recall_vs_exact(model, exact_es, es, t_batches, k=APPROX_K)
        print(f"[approx-e2e] {method} {dtype_name}, {len(batches)} batches of {BATCH}, "
              f"{NUM_ITEMS} items, k=120, k'=200: kernel path {ms_k:.3f} ms/batch, plain path "
              f"{ms_p:.3f} ms/batch on {name} ({smi}); vs plain: ranks agree on "
              f"{rank_agree:.4f} (>= {min_rank_agree}), top-120 overlap {overlap:.4f} "
              f"(>= {min_overlap}); recall_vs_exact (MoLBruteForceTopKFused) "
              + ", ".join(f"{key} {v:.4f}" for key, v in recall.items()))
        if rank_agree < min_rank_agree or overlap < min_overlap:
            raise AssertionError(f"{method}: the kernel path disagrees with the plain path")
    print(f"[approx-e2e] launches of the kernel-path run of the {len(runs)} methods: "
          f"{ {key: v for key, v in counts.items() if v} }")
    return counts


def books_e2e(device, name: str, smi: str, n_batches: int = 3) -> dict:
    """amzn-books-hstu-mol serving at full width: 16 blocks (seeded random
    weights, bf16 as `eval_bf16` serves it) over BOOKS_ITEMS items, batches of
    BOOKS_BATCH synthetic users at N = 61, k=120, k'=200, through
    get_eval_state and make_eval_step_fn for every BOOKS_METHODS spelling: the
    kernel path (launch counts, ms/batch) against the same step through the
    plain versions, with `[e2e]`'s bf16 rank and overlap checks. The encoder
    runs the XLA block path (`fused_inference=False`), so no K1. Returns the
    launch counts of the kernel-path run of all methods."""
    import torch

    from rails_tpu_torch.core.config import get_experiment_config
    from rails_tpu_torch.data.datasets import SequenceDataset, generate_synthetic_sequences
    from rails_tpu_torch.models.encoder import SequentialRecommender
    from rails_tpu_torch.train.evaluation import get_eval_state, make_eval_step_fn

    dtype_name, min_rank_agree, min_overlap = E2E_TOL[0]
    cfg = get_experiment_config("amzn-books-hstu-mol")
    model = SequentialRecommender(cfg, BOOKS_ITEMS, compute_dtype=torch.bfloat16, device=device,
                                  generator=torch.Generator().manual_seed(0))
    seqs = generate_synthetic_sequences(num_users=BOOKS_BATCH * n_batches, num_items=BOOKS_ITEMS,
                                        max_len=cfg.data.max_sequence_length + 2, seed=4)
    ds = SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1)
    batches = [(b.features, b.target_ids) for b in ds.batches(
        BOOKS_BATCH, cfg.train.gr_output_length + 1, shuffle=False, drop_last=True,
        device=device)]
    all_ids = np.arange(1, BOOKS_ITEMS + 1, dtype=np.int32)
    n = len(batches)
    counts, launches = {}, {}
    for method in BOOKS_METHODS:
        es = get_eval_state(model, all_ids, method, table_dtype=torch.bfloat16, device=device)
        step = make_eval_step_fn(model, method, k=120, num_objects=es.num_objects,
                                 filter_invalid_ids=True, truncate_k_prime_to=200)

        def serve(f, t, es=es, step=step):
            return step(es.topk_state, f, t)

        run_batches(serve, batches)                                       # warm-up
        reset_launches()
        outs_k, ms_k = run_batches(serve, batches)
        counts = {key: v for key, v in launch_counts().items() if v}
        for key, v in counts.items():
            launches[key] = launches.get(key, 0) + v
        check_outputs(outs_k, batches, num_items=BOOKS_ITEMS)
        with plain_kernels():
            outs_p, ms_p = run_batches(serve, batches)
        rk, rp = (torch.cat([o[0] for o in o_]) for o_ in (outs_k, outs_p))
        ik, ip = (torch.cat([o[1] for o in o_]) for o_ in (outs_k, outs_p))
        rank_agree = (rk == rp).float().mean().item()
        overlap = id_overlap(ik, ip)
        print(f"[books-e2e] {method} {dtype_name} {cfg.name}, {n} batches of {BOOKS_BATCH} "
              f"(N={batches[0][0].ids.shape[1]}), {BOOKS_ITEMS} items, k=120, k'=200: kernel "
              f"path {ms_k:.3f} ms/batch = {BOOKS_BATCH / ms_k * 1e3:.1f} q/s, plain path "
              f"{ms_p:.3f} ms/batch on {name} ({smi}); launches {counts}; vs plain: ranks agree "
              f"on {rank_agree:.4f} of {rk.numel()} rows (>= {min_rank_agree}), top-120 overlap "
              f"{overlap:.4f} (>= {min_overlap})")
        if rank_agree < min_rank_agree or overlap < min_overlap:
            raise AssertionError(f"{method}: the kernel path disagrees with the plain path")
        if counts.get("K1", 0):
            raise AssertionError(f"{method}: the XLA-path encoder launched K1")
        del es, step, outs_k, outs_p
        torch.cuda.empty_cache()
    want = {"K2": 2 * n, "K2-bmax": 2 * n, "K2-int8": n, "K8": 2 * n, "K8-int8": n,
            "K9": 2 * n, "K9-int8": n, "K10": 2 * n, "K10-int8": n}
    if any(launches.get(key, 0) != v for key, v in want.items()):
        raise AssertionError(f"Books serving launches {launches}, want {want}")
    check_tc_route(launches, "[books-e2e]")
    print(f"[books-e2e] launches of the kernel-path runs of the {len(BOOKS_METHODS)} methods: "
          f"{launches}")
    return launches


def model_serving(device, config: str, num_items: int, batch: int, n_batches: int,
                  lengths: str, changes: Optional[dict] = None):
    """A registry config's serving step at full width (seeded random weights;
    bf16 where the config sets `eval_bf16`, else f32; HSTU blocks through K1,
    `fused_inference`): MoL through the exact fused method on bf16 tables
    (K2), DotProduct through MIPS over the l2-normalised items where the
    config sets `item_l2_norm`; `n_batches` length-sorted batches of `batch`
    synthetic users with `lengths` history lengths, each truncated to its
    64-bucket. Returns (cfg, model, state, step, batches, dtype)."""
    import torch

    from rails_tpu_torch.core.config import get_experiment_config
    from rails_tpu_torch.data.datasets import SequenceDataset, generate_synthetic_sequences
    from rails_tpu_torch.data.features import serving_pad_length, truncate_features
    from rails_tpu_torch.models.encoder import SequentialRecommender
    from rails_tpu_torch.train.evaluation import get_eval_state, make_eval_step_fn

    cfg = configure(get_experiment_config(config), changes)
    cfg = cfg.replace(hstu=cfg.hstu.replace(fused_inference=True))
    dtype = torch.bfloat16 if cfg.train.eval_bf16 else torch.float32
    model = SequentialRecommender(cfg, num_items, compute_dtype=dtype, device=device,
                                  generator=torch.Generator().manual_seed(0),
                                  item_id_to_category_id=category_map(cfg, num_items))
    method = "MoLBruteForceTopKFused" if cfg.similarity_type == "MoL" else cfg.train.top_k_method
    t = cfg.train
    es = get_eval_state(model, np.arange(1, num_items + 1, dtype=np.int32), method,
                        table_dtype=torch.bfloat16, device=device, item_l2_norm=t.item_l2_norm,
                        l2_norm_eps=t.l2_norm_eps)
    step = make_eval_step_fn(model, method, k=120, num_objects=es.num_objects,
                             filter_invalid_ids=True, truncate_k_prime_to=200)
    seqs = generate_synthetic_sequences(num_users=batch * n_batches, num_items=num_items,
                                        max_len=cfg.data.max_sequence_length + 2, seed=0,
                                        length_distribution=lengths)
    ds = SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1)
    batches = []
    for b in ds.batches(batch, cfg.train.gr_output_length + 1, shuffle=False,
                        sort_by_length=True, drop_last=True, device=device):
        n = min(b.features.ids.shape[1], serving_pad_length(int(b.features.lengths.max()), 64))
        batches.append((truncate_features(b.features, n), b.target_ids))
    return cfg, model, es, step, batches, dtype


def serve_phase(device, name: str, smi: str, tag: str, config: str, num_items: int,
                batch: int = BATCH, n_batches: int = 1, lengths: str = "ml20m",
                changes: Optional[dict] = None, what: str = "") -> dict:
    """`model_serving`'s step through the kernels against the same step
    through the plain versions (`plain_kernels`) on the same model, tables
    and batches, at `[e2e]`'s rank and overlap tolerances for the dtype: K1 a
    block per batch with an HSTU encoder, K2 on the tensor cores with MoL.
    Returns the kernel-path run's launch counts and ms per batch."""
    import torch

    cfg, model, es, step, batches, dtype = model_serving(device, config, num_items, batch,
                                                         n_batches, lengths, changes)
    dt = str(dtype)[6:]
    _, min_rank_agree, min_overlap = next(t for t in E2E_TOL if t[0] == dt)

    def serve(f, t):
        return step(es.topk_state, f, t, es.item_embeddings)

    run_batches(serve, batches)                                           # warm-up
    reset_launches()
    outs_k, ms = run_batches(serve, batches)
    counts = {k: v for k, v in launch_counts().items() if v}
    hstu, mol = cfg.model_type == "HSTU", cfg.similarity_type == "MoL"
    want_k1 = cfg.hstu.num_blocks * len(batches) if hstu else 0
    if (counts.get("K1", 0) != want_k1 or (counts.get("K2", 0) >= len(batches)) != mol
            or counts.get("K2-tc", 0) != counts.get("K2", 0)):
        raise AssertionError(f"[{tag}] {cfg.name} launches {counts} for {len(batches)} batches")
    check_outputs(outs_k, batches, num_items=num_items)
    ms_k = statistics.median([ms] + [run_batches(serve, batches)[1] for _ in range(2)])
    with plain_kernels():
        run_batches(serve, batches)                                       # warm-up
        outs_p, ms_p = run_batches(serve, batches)
    rk, rp = (torch.cat([o[0] for o in outs]) for outs in (outs_k, outs_p))
    ik, ip = (torch.cat([o[1] for o in outs]) for outs in (outs_k, outs_p))
    rank_agree = (rk == rp).float().mean().item()
    overlap = id_overlap(ik, ip)
    # The encoder's length: the combined preprocessor interleaves to 2n.
    d = model.d_model
    n_enc = batches[0][0].ids.shape[1] * (2 if cfg.input_preprocessor_type == "combined" else 1)
    h = cfg.hstu
    k1r = k1_route(dtype, d, n_enc, h.num_heads, h.dqk, h.dv, h.linear_activation)
    route = f"K1 at n={n_enc} on the {k1r}" if hstu else "SASRec in plain torch"
    # Every K1 block on the route its rules name: each stage of the
    # tensor-core route once a block, none off it.
    stages = {"K1 proj": k1r == "bf16 tensor cores", "K1 attn": k1r == "bf16 tensor cores",
              "K1 out": k1r == "bf16 tensor cores",
              **{k: k1r == K1_TF32_ROUTE for k in K1_TF32_STAGES}}
    wrong = {k: counts.get(k, 0) for k, on in stages.items()
             if counts.get(k, 0) != (want_k1 if on and hstu else 0)}
    if wrong:
        raise AssertionError(f"[{tag}] {cfg.name}: K1 on the {k1r} launched its stages {wrong}")
    what = f" {what}" if what else ""
    print(f"[{tag}]{what} {cfg.name} {dt}, {cfg.model_type}/{cfg.similarity_type} D={d}, "
          f"{len(batches)} batch(es) of {batch} (n={[f.ids.shape[1] for f, _ in batches]}), "
          f"{num_items} items, k=120, k'=200 ({route}; "
          f"{'K2 on bf16 tables' if mol else 'MIPS over the item embeddings'}): launches "
          f"{counts}; kernel path median {ms_k:.3f} ms/batch = {batch / ms_k * 1e3:.1f} q/s, "
          f"plain path {ms_p:.3f} ms/batch on {name} ({smi}); vs plain: ranks agree on "
          f"{rank_agree:.4f} of {rk.numel()} rows (>= {min_rank_agree}), top-120 overlap "
          f"{overlap:.4f} (>= {min_overlap})")
    if rank_agree < min_rank_agree or overlap < min_overlap:
        raise AssertionError(f"[{tag}] {cfg.name}: the kernel path disagrees with the plain path")
    return {**counts, "ms": ms_k, "plain_ms": ms_p}


def corpus(config: str) -> tuple:
    """(items, history-length distribution) of a registry config's dataset."""
    if config.startswith("ml-20m"):
        return NUM_ITEMS, "ml20m"
    if config.startswith("ml-1m"):
        return ML1M_ITEMS, "uniform"
    return BOOKS_ITEMS, "uniform"


def models_phase(device, name: str, smi: str) -> dict:
    """`[models]`: one eval batch of each of MODEL_CONFIGS at its published
    widths (Books' 695,762 items at B=64), kernels against plain. Returns the
    launch counts by config."""
    import torch

    runs = {}
    for config in MODEL_CONFIGS:
        items, lengths = corpus(config)
        batch = BOOKS_BATCH if config.startswith("amzn-books") else BATCH
        runs[config] = serve_phase(device, name, smi, "models", config, items, batch, 1, lengths)
        torch.cuda.empty_cache()
    return runs


def models_var_phase(device, name: str, smi: str) -> dict:
    """`[models-var]`: one ml-20m-hstu-mol train step with each of
    VAR_OPTIONS, kernels against plain (`train_phase` with no further
    steps); for the rated and the combined preprocessor also a bf16 train
    step (main_module_bf16) and one eval batch of 512 in f32 and in bf16
    (K1 at their width and length). Returns each run's launch counts by
    (option, dtype name, "train" or "serve")."""
    import torch

    runs = {}
    for option, changes in VAR_OPTIONS.items():
        runs[(option, "float32", "train")] = train_phase(
            device, name, smi, tag="models-var", changes=changes, what=option, steps=0)
        torch.cuda.empty_cache()
        if option not in ("rated", "combined"):
            continue
        runs[(option, "bfloat16", "train")] = train_phase(
            device, name, smi, tag="models-var", changes=changes, what=option, steps=0,
            main_module_bf16=True)
        torch.cuda.empty_cache()
        for bf16 in (False, True):
            serve_changes = dict(changes, train=dict(eval_bf16=bf16))
            runs[(option, "bfloat16" if bf16 else "float32", "serve")] = serve_phase(
                device, name, smi, "models-var", "ml-20m-hstu-mol", NUM_ITEMS,
                changes=serve_changes, what=option)
            torch.cuda.empty_cache()
    return runs


def k1_variant_inputs(b: int, n: int, dtype, device, instance: str):
    """`k1_inputs` for one of K1_VAR_INSTANCES: a (3*h*dv, D) output
    projection for concat_ua; the layer's bias built in-kernel, or the same
    bias precomputed in x's dtype (raw, or with the -30000 penalty folded in
    for mask_in_bias), or none."""
    import torch

    from rails_tpu_torch.ops.hstu_block import time_bucket

    mode, activation, normalization, concat_ua = K1_VAR_INSTANCES[instance]
    (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw), kw = k1_inputs(b, n, dtype, device)
    if concat_ua:
        g = torch.Generator().manual_seed(3)
        o_kernel = (torch.randn(3 * H * DV, D, generator=g) / (H * DV) ** 0.5).to(dtype).to(device)
    args = dict(x=x, colmask=colmask, uvqk=uvqk, o_kernel=o_kernel, o_bias=o_bias)
    if mode == "internal":
        args.update(rel_pos=rel_pos, ext=ext, tsw=tsw)
    elif mode in ("raw", "penalty"):
        bias = rel_pos[None] + tsw[time_bucket(ext[:, 1:, None] - ext[:, None, :n], 128).long()]
        if mode == "penalty":
            causal = torch.tril(torch.ones(n, n, device=device))
            bias = bias + (causal[None] * colmask[:, None, :] - 1.0) * 30000.0
        args.update(bias=bias.to(dtype).contiguous(), mask_in_bias=mode == "penalty")
    kw.update(activation=activation, normalization=normalization)
    return args, kw


def k1_variant_flops(b: int, n: int, softmax: bool, out_rows: int, attention: bool = True,
                     geom: tuple = K1_GEOMS["ml-20m"]) -> int:
    """FLOPs one block forward needs at a geometry of K1_GEOMS: the
    projection, the attention (pointwise: q k^T and a v over the causal
    pairs; softmax: q k^T over every pair, since the denominator covers all
    columns, and a v over the causal ones) and an output projection of
    `out_rows` rows."""
    d, h, dqk, dv, _ = geom
    f = 2 * h * dv + 2 * h * dqk
    pairs = n * (n + 1) // 2
    if not attention:
        attn = 0
    elif softmax:
        attn = b * (2 * n * n * h * dqk + 2 * pairs * h * dv)
    else:
        attn = b * h * pairs * 2 * (dqk + dv)
    return 2 * b * n * d * f + attn + 2 * b * n * out_rows * d


def k1_variant_bytes(b: int, n: int, itemsize: int, out_rows: int, bias: str,
                     geom: tuple = K1_GEOMS["ml-20m"]) -> int:
    """Bytes one block forward must move: x and out, the weights, the column
    mask, and the bias tables (internal) or the (B, n, n) bias (precomputed)."""
    d, h, dqk, dv, _ = geom
    f = 2 * h * dv + 2 * h * dqk
    nbytes = itemsize * (2 * b * n * d + d * f + out_rows * d) + 4 * (d + b * n)
    if bias == "internal":
        nbytes += 4 * (n * n + 128 + b * (n + 1))
    elif bias in ("raw", "penalty"):
        nbytes += itemsize * b * n * n
    return nbytes


def check_k1_variant(b: int, n: int, dtype, device, instance: str) -> dict:
    """One of K1's variant instances against its plain version."""
    import torch

    from rails_tpu_torch.ops.hstu_block import fused_hstu_block, fused_hstu_block_reference

    mode, activation, normalization, concat_ua = K1_VAR_INSTANCES[instance]
    args, kw = k1_variant_inputs(b, n, dtype, device, instance)
    route = k1_route(dtype, D, n, H, DQK, DV, activation, normalization == "softmax_rel_bias")
    got = tf32_launched(lambda: fused_hstu_block(**args, **kw), route)
    ref = fused_hstu_block_reference(**args, **kw)
    dt = str(dtype)[6:]
    rtol, atol = K1_TOL[dt]
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
    err = (got.float() - ref.float()).abs().max().item()
    ms = cuda_ms(lambda: fused_hstu_block(**args, **kw))
    plain_ms = cuda_ms(lambda: fused_hstu_block_reference(**args, **kw), iters=3, warmup=1)
    rows = (3 if concat_ua else 1) * H * DV
    softmax = normalization == "softmax_rel_bias"
    flops = k1_variant_flops(b, n, softmax, rows)
    nbytes = k1_variant_bytes(b, n, args["x"].element_size(), rows, mode)
    bd = bound(flops, nbytes, "tf32x3" if route == K1_TF32_ROUTE else dt)
    print(f"[K1-var] {instance} {dt} B={b} n={n} D={D} h={H} (bias {mode}, "
          f"{kw['activation']}, {normalization}, o_kernel {rows} rows; {route}): max|err| "
          f"{err:.3e} (rtol {rtol}, atol {atol}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}; {bound_terms(flops, nbytes, route)})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None}


def variant_config(instance: str) -> tuple:
    """The `--set` overrides of ml-20m-hstu-mol that select a K1 variant
    instance, and whether its timestamps go int64: JAX precomputes the bias
    (raw under softmax, with the mask penalty otherwise) only for timestamps
    that are not int32."""
    mode, activation, normalization, concat_ua = K1_VAR_INSTANCES[instance]
    overrides = ((f"hstu.linear_activation={activation}",) if activation != "silu" else ())
    overrides += (("hstu.concat_ua=true",) if concat_ua else ())
    overrides += ((f"hstu.normalization={normalization}",) if normalization != "rel_bias" else ())
    overrides += (("hstu.enable_relative_attention_bias=false",) if mode == "none" else ())
    return overrides, mode in ("raw", "penalty")


def variants_e2e(device, name: str, smi: str) -> dict:
    """ml-20m-hstu-mol with fused_inference and each K1 variant's
    configuration (`variant_config`, through `apply_override`), in bf16 and,
    for the instances of K1's f32 route (SiLU), in f32: one batch of 512
    through get_eval_state and make_eval_step_fn (K1 + K2) against the same
    step through the plain versions, with `[e2e]`'s rank and overlap checks
    of its dtype; every block on its route's stages. Returns each run's
    launch counts by (instance, dtype name)."""
    import torch

    runs = {}
    for instance, dtype_name in [(i, d) for d, *_ in E2E_TOL for i in K1_VAR_INSTANCES
                                 if d == "bfloat16" or K1_VAR_INSTANCES[i][1] == "silu"]:
        min_rank_agree, min_overlap = {d: t for d, *t in E2E_TOL}[dtype_name]
        dtype = getattr(torch, dtype_name)
        overrides, int64 = variant_config(instance)
        model, es, step, batches = serving_setup(dtype, device, 1, overrides=overrides)
        if int64:
            batches = [(f._replace(timestamps=f.timestamps.long()), t) for f, t in batches]

        def serve(f, t, es=es, step=step):
            return step(es.topk_state, f, t)

        run_batches(serve, batches)                                       # warm-up
        reset_launches()
        outs_k, ms_k = run_batches(serve, batches)
        counts = {k: v for k, v in launch_counts().items() if v}
        check_outputs(outs_k, batches)
        want = model.cfg.hstu.num_blocks * len(batches)
        silu = model.cfg.hstu.linear_activation == "silu"   # `tc_block`, `tf32_block`
        bf16 = dtype == torch.bfloat16
        stages, stages32 = (want * silu, 0) if bf16 else (0, want)
        softmax32 = stages32 * (K1_VAR_INSTANCES[instance][2] == "softmax_rel_bias")
        if (counts.get("K1") != want or counts.get("K2", 0) < len(batches)
                or any(counts.get(k, 0) != stages for k in K1_STAGES)
                or any(counts.get(k, 0) != stages32 for k in K1_TF32_STAGES)
                or counts.get("K1 f32 softmax", 0) != softmax32):
            raise AssertionError(f"{instance} {dtype_name}: launches {counts}, want K1 {want}")
        with plain_kernels():
            outs_p, ms_p = run_batches(serve, batches)
        rk, rp = (torch.cat([o[0] for o in o_]) for o_ in (outs_k, outs_p))
        ik, ip = (torch.cat([o[1] for o in o_]) for o_ in (outs_k, outs_p))
        rank_agree = (rk == rp).float().mean().item()
        overlap = id_overlap(ik, ip)
        print(f"[variants-e2e] {instance}: ml-20m-hstu-mol {dtype_name} fused_inference "
              f"{list(overrides)}{' + int64 timestamps' if int64 else ''}, {len(batches)} batch "
              f"of {BATCH} (n={batches[0][0].ids.shape[1]}), {NUM_ITEMS} items, k=120, k'=200: "
              f"launches {counts}; kernel path {ms_k:.3f} ms/batch, plain path {ms_p:.3f} "
              f"ms/batch on {name} ({smi}); vs plain: ranks agree on {rank_agree:.4f} of "
              f"{rk.numel()} rows (>= {min_rank_agree}), top-120 overlap {overlap:.4f} "
              f"(>= {min_overlap})")
        if rank_agree < min_rank_agree or overlap < min_overlap:
            raise AssertionError(f"{instance} {dtype_name}: the kernel path disagrees with the "
                                 f"plain path")
        runs[(instance, dtype_name)] = counts
        del model, es, step, batches, outs_k, outs_p
        torch.cuda.empty_cache()
    return runs


def train_var_phase(device, name: str, smi: str) -> dict:
    """ml-20m-hstu-mol with fused_train and each of K4_VAR_INSTANCES, in f32 and
    in bf16 (main_module_bf16): `[train]`'s step-1 contract, then
    TRAIN_VAR_STEPS steps, each making 16 launches of K4's forward and
    backward and of the variant's counters. Returns each run's launch counts
    by (instance, dtype)."""
    import torch

    runs = {}
    for instance, hstu in K4_VAR_INSTANCES.items():
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dict(main_module_bf16=True) if dtype == torch.bfloat16 else {}
            runs[(instance, dtype)] = train_phase(device, name, smi, tag="train-var", hstu=hstu,
                                                  steps=TRAIN_VAR_STEPS, **bf16)
            torch.cuda.empty_cache()
    return runs


def p1_flops_bytes(b: int, n: int, mode: str) -> tuple:
    """FLOPs and bytes of one probe block in `mode` (bf16, concat_ua)."""
    rows = 3 * H * DV
    if mode == "ident":   # LN and the whole (D, F) projection; out = Y[:, :D] + x
        f = 2 * H * DV + 2 * H * DQK
        return 2 * b * n * D * f, 2 * (2 * b * n * D + D * f)
    flops = k1_variant_flops(b, n, False, rows, attention=mode != "noattn")
    return flops, k1_variant_bytes(b, n, 2, rows, "internal")


def p1_phase(device, name: str, smi: str) -> dict:
    """P1 (`rails_tpu_torch.cli.encode_probe`): at B=512, n=192, each mode's
    kernel against its plain version on one block (and again at
    B=P1_CHECK_BATCH on other data), `full` against `production` (K1's
    concat_ua instance), each mode's kernel and plain ms; then the CLI's
    16-block sweep of every mode with `--runs` cut to P1_RUNS. Returns the
    `full` row and the CLI run's launches."""
    import torch

    from rails_tpu_torch.cli import encode_probe as cli
    from rails_tpu_torch.ops import encode_probe as ep
    from rails_tpu_torch.ops.hstu_block import fused_hstu_block

    n = P1_LENGTH
    kw = dict(num_heads=H, dqk=DQK, dv=DV, inv_n=1.0 / n)
    rtol, atol = K1_TOL["bfloat16"]

    def block_args(d):
        return (d["x0"], d["colmask"], d["uvqk"][0], d["ow"][0], d["ob"][0], d["rel_pos"],
                d["ext"], d["tsw"])

    small = block_args(cli.probe_data(P1_CHECK_BATCH, n, 1, np.random.default_rng(1), device))
    small_errs = {}
    for mode in ep.MODES:
        got = ep.encode_probe_block(mode, *small, **kw).float()
        ref = ep.encode_probe_block_reference(mode, *small, **kw).float()
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
        small_errs[mode] = (got - ref).abs().max().item()
    del small
    args = block_args(cli.probe_data(BATCH, n, 1, np.random.default_rng(2), device))
    errs = {}
    for mode in ep.MODES:
        got = ep.encode_probe_block(mode, *args, **kw).float()
        ref = ep.encode_probe_block_reference(mode, *args, **kw).float()
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
        errs[mode] = (got - ref).abs().max().item()
        if mode == "full":
            prod = fused_hstu_block(*args, **kw).float()
            torch.testing.assert_close(got, prod, rtol=rtol, atol=atol)
            prod_err = (got - prod).abs().max().item()
        del got, ref
    print(f"[P1] B={BATCH} n={n} bf16, one block: max|kernel - plain| per mode "
          f"{ {m: float(f'{e:.3e}') for m, e in errs.items()} } (rtol {rtol}, atol {atol}); "
          f"at B={P1_CHECK_BATCH} {max(small_errs.values()):.3e}; full vs production "
          f"(K1 concat_ua) {prod_err:.3e}")
    rows = {}
    for mode in ep.MODES:
        ms = cuda_ms(lambda: ep.encode_probe_block(mode, *args, **kw))
        plain_ms = cuda_ms(lambda: ep.encode_probe_block_reference(mode, *args, **kw), iters=3,
                           warmup=1)
        bd = bound(*p1_flops_bytes(BATCH, n, mode), "bfloat16")
        rows[mode] = {"max_abs_err": errs[mode], "ms": ms, "plain_ms": plain_ms, **bd,
                      "library_ms": None}
        print(f"[P1] {mode} B={BATCH} n={n} one block: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
              f"ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    del args
    torch.cuda.empty_cache()
    ep.encode_probe_block.launches = 0
    out = cli.main(["--batch-size", str(BATCH), "--lengths", str(n), "--runs", str(P1_RUNS),
                    "--device", str(device)])
    launches = ep.encode_probe_block.launches
    row = out["ms_per_encode"][n]
    if launches != len(ep.MODES) * 16 * P1_RUNS * 4:
        raise AssertionError(f"P1 launched {launches} times")
    print(f"[P1] cli.encode_probe B={BATCH} n={n}, 16 blocks, --runs {P1_RUNS} on {name} ({smi}): "
          f"ms per encode {row}; term costs vs full: "
          f"{ {m: round(row['full'] - row[m], 3) for m in row if m != 'full'} }; "
          f"{launches} probe launches")
    return {"full": rows["full"], "rows": rows, "launches": launches}


def p2_operands(device, seed: int = 9) -> tuple:
    """P2's operands at B=32 over P2_ITEMS items (padded to 256), the probe's
    geometry and types, drawn on the card from `seed` in the probe's m-major
    layout and put into K2's order by `probe_operands`."""
    import torch

    from rails_tpu_torch.ops import mol_probe as mp

    b, x_pad = APPROX_BATCH, -(-P2_ITEMS // 256) * 256
    l = P_Q * P_X
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return 0.1 * torch.randn(*shape, generator=g, device=device)

    return mp.probe_operands(
        q=randn(P_Q, b, D_P), qp=randn(b, l), item=randn(P_X, D_P, x_pad).bfloat16(),
        ip=randn(l, x_pad).bfloat16(), w1=randn(l, 128), b1=randn(128), w2=randn(128, l),
        b2=randn(l))


def p2_faults(ops: tuple) -> dict:
    """P2_FAULTS: `ops` with seeded wrong weights, by name."""
    q, qp, item, ip, w = ops
    w2 = w.w2.clone()
    w2[[0, 1]] = w2[[1, 0]]
    w1 = w.w1.clone()
    w1[5] = 0.0
    wrong = (type(w)(w.w1, w.b1, w2, w.b2), type(w)(w1, w.b1, w.w2, w.b2))
    return {name: (q, qp, item, ip, wt) for name, wt in zip(P2_FAULTS, wrong)}


def check_p2(device, ops: tuple) -> dict:
    """P2's kernel in each mode on `ops` (`p2_operands`) against its plain
    version over the whole corpus, per score within `mol_probe_error_bound`;
    in `full`, the kernel on each of P2_FAULTS must break that bound; `full`
    against K2 on the same operands (K2's bf16 contract; the same kernel, so
    bit-equal is expected); each mode's kernel and plain ms and bound.
    Returns each mode's row of the kernel summary."""
    import torch

    from rails_tpu_torch.ops import mol_probe as mp
    from rails_tpu_torch.ops.mol_scoring import fused_mol_scores_t

    b, x_pad, x = ops[0].shape[0], ops[2].shape[2], P2_ITEMS
    l = P_Q * P_X
    k2_full = fused_mol_scores_t(*ops, 1.0 / mp.INV_TEMPERATURE)
    k2_ms = cuda_ms(lambda: fused_mol_scores_t(*ops, 1.0 / mp.INV_TEMPERATURE), iters=3,
                    warmup=1)
    errs, ratios, rows, faults = {}, {}, {}, {}
    for mode in mp.MODES:
        got = mp.mol_probe_scores(mode, *ops)
        ref = mp.mol_probe_scores_reference(mode, *ops)
        bd = mp.mol_probe_error_bound(mode, *ops)
        err = (got - ref).abs()
        ratios[mode] = (err / bd).max().item()
        errs[mode] = err.max().item()
        if not ratios[mode] <= 1.0:
            raise AssertionError(f"P2 {mode}: kernel vs plain at {ratios[mode]:.3e} of its bound")
        if mode == "full":
            verdict = bf16_contract(got[:, :x], k2_full[:, :x], "P2 full vs K2")
            bit_equal = torch.equal(got, k2_full)
            for fault, wrong in p2_faults(ops).items():
                faults[fault] = ((mp.mol_probe_scores(mode, *wrong) - ref).abs() / bd).max().item()
                if not faults[fault] > 1.0:
                    raise AssertionError(f"P2 full: the bound misses the seeded fault {fault!r} "
                                         f"({faults[fault]:.3e} of it)")
        del got, ref, err, bd
        ms = cuda_ms(lambda: mp.mol_probe_scores(mode, *ops), iters=3, warmup=1)
        plain_ms = cuda_ms(lambda: mp.mol_probe_scores_reference(mode, *ops), iters=1,
                           warmup=0)
        per_pair = 2 * l * D_P + (4 * l * 128 if mode in ("full", "nosilu", "noexp") else 0)
        nbytes = 2 * (P_X * D_P + l) * x_pad + 4 * b * x_pad + 4 * (b * l + 2 * l * 128)
        bd = mol_bound(lambda: mp.mol_probe_scores(mode, *ops), ms, b * x_pad, per_pair,
                       nbytes, "bfloat16", mol_sfu_per_pair(l, 128, mode))
        rows[mode] = {"max_abs_err": errs[mode], "ms": ms, "plain_ms": plain_ms, **bd,
                      "library_ms": None}
        print(f"[P2] {mode} B={b} X={x}, {mol_route((P_Q, P_X, D_P), torch.bfloat16)}: kernel "
              f"{ms:.3f} ms, device {bd['device_us']:.2f} us, plain {plain_ms:.3f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    print(f"[P2] B={b} X={x} MoL {P_Q}x{P_X}x{D_P} H=128 bf16, all {x_pad} columns: "
          f"max|kernel - plain| per mode { {m: float(f'{e:.3e}') for m, e in errs.items()} }, "
          f"its largest share of `mol_probe_error_bound` (one bf16 flip) "
          f"{ {m: float(f'{r:.3e}') for m, r in ratios.items()} } (<= 1); the kernel on "
          f"seeded faults, full: { {k: float(f'{v:.3e}') for k, v in faults.items()} } (> 1); "
          f"full vs K2 on the same operands: {verdict}, bit-equal {bit_equal}; K2 {k2_ms:.3f} ms")
    return rows


def p2_phase(device, name: str, smi: str) -> dict:
    """P2 (`rails_tpu_torch.cli.mol_probe`) at B=32 over P2_ITEMS items:
    `check_p2` on `p2_operands`, then the CLI's timing of every mode
    (`--runs` cut to P2_RUNS) and of the hierarchical select. Returns the
    `full` row and the CLI run's launches."""
    import torch

    from rails_tpu_torch.cli import mol_probe as cli
    from rails_tpu_torch.ops import mol_probe as mp

    b, x = APPROX_BATCH, P2_ITEMS
    ops = p2_operands(device)
    rows = check_p2(device, ops)
    mp.mol_probe_scores.launches = mp.mol_probe_scores.tc_launches = 0
    res = cli.time_modes(ops, mp.MODES, P2_RUNS, device)
    launches = mp.mol_probe_scores.launches
    if launches != len(mp.MODES) * P2_RUNS * 4 or mp.mol_probe_scores.tc_launches != launches:
        raise AssertionError(f"P2 launched {launches} times, "
                             f"{mp.mol_probe_scores.tc_launches} on the tensor cores")
    del ops
    torch.cuda.empty_cache()
    g = torch.Generator(device=device).manual_seed(9)
    scores = torch.randn(b, x, generator=g, device=device)
    sel = cli.time_select(scores, APPROX_K, P2_RUNS, device)
    print(f"[P2] cli.mol_probe B={b} X={x}, --runs {P2_RUNS} on {name} ({smi}): ms per batch "
          f"{res}, select_hierarchical {sel:.3f}; stage costs vs full: "
          f"{ {m: round(res['full'] - res[m], 2) for m in res if m != 'full'} }; "
          f"{launches} probe launches")
    return {"full": rows["full"], "rows": rows, "launches": launches}


def ml1m_ratings_dat(path: str, seed: int = 0) -> int:
    """Write an ML-1M-shaped ratings.dat (`user::item::rating::timestamp`):
    ML1M_USERS users with lognormal per-user counts (ML1M_MEDIAN, ML1M_MEAN,
    clamped to [20, ML1M_MAX_LEN]), items drawn with Zipf popularity from
    3,706 ids up to ML1M_MAX_ID (each at least once), ratings 1-5, each
    user's timestamps increasing, lines in shuffled order. Returns the number
    of events."""
    rng = np.random.default_rng(seed)
    items = np.sort(np.concatenate([rng.choice(np.arange(1, ML1M_MAX_ID), 3_705, replace=False),
                                    [ML1M_MAX_ID]]))
    sigma = np.sqrt(2.0 * np.log(ML1M_MEAN / ML1M_MEDIAN))
    lens = np.clip(rng.lognormal(np.log(ML1M_MEDIAN), sigma, ML1M_USERS), 20,
                   ML1M_MAX_LEN).astype(np.int64)
    n = int(lens.sum())
    popularity = 1.0 / np.arange(1, items.size + 1)
    picks = rng.choice(items.size, n, p=popularity / popularity.sum())
    picks[rng.choice(n, items.size, replace=False)] = rng.permutation(items.size)
    users = np.repeat(np.arange(1, ML1M_USERS + 1), lens)
    starts = np.repeat(np.cumsum(lens) - lens, lens)
    gaps = np.cumsum(rng.integers(1, 3_600, n))
    ts = 956_703_932 + rng.integers(0, 10**7, ML1M_USERS)[users - 1] + gaps - gaps[starts]
    rows = np.stack([users, items[picks], rng.integers(1, 6, n), ts], axis=1)
    np.savetxt(path, rows[rng.permutation(n)], fmt="%d::%d::%d::%d")
    return n


def data_phase(device, name: str, smi: str) -> dict:
    """`[data]`: the port's data pipeline at ML-1M's full size. An
    ML-1M-shaped ratings.dat (`ml1m_ratings_dat`) in a temporary directory
    through the ml-1m preprocessor (pandas-free, its unique-item and max-id
    checks included) into sasrec_format.csv; `get_reco_dataset` on it,
    gated on the native parser having run and on its arrays equal to the
    Python parser's (both timed); one eval batch of ml-1m-hstu-mol through
    MoLBruteForceTopKFused (K2 at 8x4x64 on bf16 tables, no K1: the config
    leaves fused_inference off) against the plain path; then three
    ml-1m-hstu-mol-fast steps (K5) from `prefetch_batches` over the train
    split, step 1 kernels vs plain, each step's launches checked. Returns
    the launches of the serving batch and the three steps."""
    import itertools
    import tempfile

    import torch

    from rails_tpu_torch.core.config import get_experiment_config
    from rails_tpu_torch.data import datasets, native
    from rails_tpu_torch.data.preprocessor import get_common_preprocessors
    from rails_tpu_torch.models.encoder import SequentialRecommender
    from rails_tpu_torch.train.evaluation import get_eval_state, make_eval_step_fn
    from rails_tpu_torch.train.loop import create_train_state

    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "tmp", "ml-1m"))
        t0 = time.perf_counter()
        n = ml1m_ratings_dat(os.path.join(root, "tmp", "ml-1m", "ratings.dat"))
        write_s = time.perf_counter() - t0
        proc = get_common_preprocessors(root)["ml-1m"]
        t0 = time.perf_counter()
        unique = proc.preprocess_rating()
        pre_s = time.perf_counter() - t0
        csv_path = proc.output_format_csv()
        cfg = get_experiment_config("ml-1m-hstu-mol")
        before = native.parse_sasrec_csv_native.calls
        t0 = time.perf_counter()
        ds = datasets.get_reco_dataset(cfg.data, root)
        native_s = time.perf_counter() - t0
        if native.parse_sasrec_csv_native.calls != before + 1:
            raise AssertionError("[data] get_reco_dataset did not parse with the native loader")
        t0 = time.perf_counter()
        py = datasets._parse_sasrec_csv_python(csv_path)
        python_s = time.perf_counter() - t0
        seqs = ds.eval_dataset._seqs
        for f in ("user_ids", "offsets", "item_ids", "ratings", "timestamps"):
            if not np.array_equal(getattr(seqs, f), getattr(py, f)):
                raise AssertionError(f"[data] native and Python parsers differ in {f}")
        mb = os.path.getsize(csv_path) / 2**20
    print(f"[data] ML-1M-shaped ratings.dat: {n} events of {ML1M_USERS} users, {unique} items "
          f"(max id {ds.max_item_id}), written in {write_s:.2f} s; preprocess (pandas-free) "
          f"{pre_s:.2f} s -> sasrec_format.csv {mb:.1f} MiB; get_reco_dataset with the native "
          f"parser {native_s:.3f} s, the Python parser alone {python_s:.3f} s, arrays equal; "
          f"{len(ds.train_dataset)} train and {len(ds.eval_dataset)} eval users")

    dtype = torch.bfloat16 if cfg.train.eval_bf16 else torch.float32
    model = SequentialRecommender(cfg, ds.max_item_id, compute_dtype=dtype, device=device,
                                  generator=torch.Generator().manual_seed(0))
    method = "MoLBruteForceTopKFused"
    es = get_eval_state(model, ds.all_item_ids, method, table_dtype=torch.bfloat16,
                        device=device)
    step = make_eval_step_fn(model, method, k=120, num_objects=es.num_objects,
                             filter_invalid_ids=True, truncate_k_prime_to=200)
    batch = next(ds.eval_dataset.batches(cfg.train.eval_batch_size,
                                         cfg.train.gr_output_length + 1, shuffle=False,
                                         device=device))
    batches = [(batch.features, batch.target_ids)]

    def serve(f, t):
        return step(es.topk_state, f, t)

    run_batches(serve, batches)                                           # warm-up
    reset_launches()
    outs_k, ms_k = run_batches(serve, batches)
    counts = {k: v for k, v in launch_counts().items() if v}
    if counts != {"K2": 1, "K2-tc": 1}:
        raise AssertionError(f"[data] ml-1m-hstu-mol serving launches {counts}, want K2 once on "
                             f"the tensor cores")
    check_outputs(outs_k, batches, num_items=ds.max_item_id)
    with plain_kernels():
        outs_p, ms_p = run_batches(serve, batches)
    _, min_rank_agree, min_overlap = next(t for t in E2E_TOL if t[0] == str(dtype)[6:])
    rank_agree = (outs_k[0][0] == outs_p[0][0]).float().mean().item()
    overlap = id_overlap(outs_k[0][1], outs_p[0][1])
    print(f"[data] {cfg.name} {str(dtype)[6:]}, one eval batch of {batch.target_ids.shape[0]} "
          f"from the loaded split (N={batch.features.ids.shape[1]}), {es.num_objects} items, "
          f"k=120, k'=200, MoLBruteForceTopKFused: launches {counts}; kernel path {ms_k:.3f} "
          f"ms, plain path {ms_p:.3f} ms on {name} ({smi}); vs plain: ranks agree on "
          f"{rank_agree:.4f} (>= {min_rank_agree}), top-120 overlap {overlap:.4f} "
          f"(>= {min_overlap})")
    if rank_agree < min_rank_agree or overlap < min_overlap:
        raise AssertionError("[data] the kernel path disagrees with the plain path")
    del model, es
    torch.cuda.empty_cache()

    fast = get_experiment_config("ml-1m-hstu-mol-fast")
    model, state, step, _ = create_train_state(fast, ds.max_item_id, ds.all_item_ids, seed=0,
                                               device=device)
    batches = datasets.prefetch_batches(itertools.islice(ds.train_dataset.batches(
        fast.train.local_batch_size, fast.train.gr_output_length + 1, shuffle=True, seed=0,
        drop_last=True, device=device), 3))
    gen = torch.Generator(device=device).manual_seed(0)
    state, per_step, want = first_step_vs_plain(fast, model, state, step, next(batches), gen,
                                                "data", "from prefetch_batches over the train "
                                                "split,")
    if not (per_step.get("K5 fwd") and per_step.get("K5 bwd")):
        raise AssertionError(f"[data] {fast.name} step launched no K5: {per_step}")
    reset_launches()
    losses, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b, gen)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(m["loss"].item())
    steps = launch_counts()
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"[data] steps 2-3 from the prefetched batches: losses {losses}")
    if steps != {k: 2 * v for k, v in want.items()}:
        raise AssertionError(f"[data] steps 2-3 launches {steps}, want twice {want}")
    print(f"[data] {fast.name} steps 2-3 on the next prefetched batches: loss "
          f"{losses[0]:.4f}, {losses[1]:.4f}; {times[0]:.3f} and {times[1]:.3f} ms/step; "
          f"launches {({k: v for k, v in steps.items() if v})} on {name} ({smi})")
    return {k: counts.get(k, 0) + per_step[k] + steps[k] for k in steps}


SHARD_RANKS = 4
SHARD_ITEMS = 1 << 21          # 2,097,152 items: 524,288 a shard, above _CHUNK_MAX_X
SHARD_VOCAB = 100_000          # shard_bench's vocabulary: min(X, 100,000)
SHARD_BATCH = 32
SHARD_K = 200
SHARD_SMALL_ITEMS = 1_024      # Naive and Comb at full budget: 256 a shard
SHARD_EXACT = ("MoLBruteForceTopKFused", "MoLBruteForceTopKFusedInt8")
SHARD_SMALL = ("MoLNaiveTopK1024", "MoLCombTopK1024_1024")
SHARD_APPROX = ("MoLAvgTopK4096", "MoLCertTopK4096", "MoLTileTopK8", "MoLIVFTopK32")
SHARD_NLIST = 5_792            # IVF lists a shard: shard_bench's max(64, 4 sqrt(X))
SHARD_RUNS = 5
SHARD_TIMEOUT = 300.0
BENCH_ITEMS = 8_000_000        # [shard-bench]: the frontier's corpus
DP_RANKS = 2
DP_STEPS = 3
# (tag, config, train overrides, step 1's gradient limit: max |dp - one| over
# each tensor's largest |value|). Each limit sits between the sound step's
# reading and that of the planted fault `[dp-train]` also runs, the HSTU hash
# streams numbering a rank's rows from 0 (PERF.md records both readings).
DP_CONFIGS = (("ml-20m-hstu-mol", "ml-20m-hstu-mol", {}, 1e-5),
              ("ml-20m-hstu-mol-fast", "ml-20m-hstu-mol-fast", {"pallas_scatter_grad": True},
               1e-3))
DP_LOSS_RTOL = 1e-5            # the step's loss, each of 3 steps
DP_PARAM_RATIO = 1e-2          # |p_dp - p_one| / |p_one - p_start| over every parameter
DP_TIMEOUT = 300.0


def shard_model(device):
    """The [sharded] model: ml-20m-hstu-mol at full width, bf16 as served, K1
    for the encode (`fused_inference`), seeded random weights over
    SHARD_VOCAB items; the batch of SHARD_BATCH synthetic users; the corpus
    embedding function of `cli/shard_bench.py`."""
    import torch

    from rails_tpu_torch.cli.shard_bench import embed_fn
    from rails_tpu_torch.core.config import get_experiment_config
    from rails_tpu_torch.data.datasets import SequenceDataset, generate_synthetic_sequences
    from rails_tpu_torch.models.encoder import SequentialRecommender

    cfg = get_experiment_config("ml-20m-hstu-mol")
    cfg = cfg.replace(hstu=cfg.hstu.replace(fused_inference=True),
                      train=cfg.train.replace(main_module_bf16=True, eval_bf16=True))
    model = SequentialRecommender(cfg, SHARD_VOCAB, compute_dtype=torch.bfloat16, device=device,
                                  generator=torch.Generator().manual_seed(0)).eval()
    seqs = generate_synthetic_sequences(num_users=256, num_items=SHARD_VOCAB, max_len=202, seed=0,
                                        length_distribution="ml20m")
    batch = next(SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1).batches(
        SHARD_BATCH, cfg.train.gr_output_length + 1, shuffle=False, device=device))
    return model, batch.features, embed_fn(model, SHARD_VOCAB, device)


def small_state(model, embed, device):
    """The SHARD_SMALL_ITEMS corpus with standard bf16 tables."""
    import torch

    from rails_tpu_torch.index.top_k import build_mol_topk_state

    ids = torch.arange(1, SHARD_SMALL_ITEMS + 1, dtype=torch.int32, device=device)
    return build_mol_topk_state(model, ids, embed(0, ids), torch.bfloat16)


def sharded_rank(rank: int, world: int, store: str, out_dir: str,
                 device_name: str = "cuda:0") -> None:
    """One [sharded] rank on the card (gloo): builds only its slab of the
    corpus (`build_shard_state`) and its IVF index (`build_rank_ivf`), and
    runs every method through `make_sharded_top_k_fn`; the launch counts
    are this rank's over the methods' runs."""
    import torch

    from rails_tpu_torch.train.profiling import timed_ms
    from rails_tpu_torch.core import distributed
    from rails_tpu_torch.core.config import MeshConfig
    from rails_tpu_torch.core.mesh import make_mesh
    from rails_tpu_torch.index.ivf import build_rank_ivf
    from rails_tpu_torch.index.sharded import (
        build_shard_state,
        make_sharded_top_k_fn,
        pad_and_shard_state,
    )
    from rails_tpu_torch.ops.mol_scoring import quantize_fused_tables

    device = torch.device(device_name)
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(f"file://{store}", world, rank, backend="gloo", device=device)
    mesh = make_mesh(MeshConfig(item_parallel=world))
    out = {}
    with torch.inference_mode():
        model, feats, embed = shard_model(device)
        t0 = time.perf_counter()
        sh = build_shard_state(model, SHARD_ITEMS, embed, mesh)
        sync(device)
        out["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sh = sh._replace(ivf=build_rank_ivf(sh, mesh, nlist=SHARD_NLIST, chunk=16_384))
        sync(device)
        out["ivf_s"] = time.perf_counter() - t0
        out["slab"] = int(sh.item_ids.shape[0])
        states = {m: sh for m in SHARD_EXACT + SHARD_APPROX}
        states["MoLBruteForceTopKFusedInt8"] = sh._replace(
            fused_tables=quantize_fused_tables(sh.fused_tables))
        small = pad_and_shard_state(small_state(model, embed, device), mesh)
        reset_launches()
        q = model.encode(feats)
        for m in SHARD_EXACT + SHARD_APPROX + SHARD_SMALL:
            fn = make_sharded_top_k_fn(m, model, small if m in SHARD_SMALL else states[m], mesh,
                                       k=SHARD_K, avg_top_k=4000, k_per_group=50)
            res = fn(q, feats.user_ids)
            out[m] = (res.scores.float().cpu().numpy(), res.ids.cpu().numpy(),
                      timed_ms(lambda: fn(q, feats.user_ids), SHARD_RUNS, device))
        out["launches"] = launch_counts()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()


def tie_rule(got_ids, want_ids, want_scores, rel: float) -> int:
    """Positions where the ids differ and the reference's score there has no
    other score in its row within `rel` of its |value|; 0 means equal under
    the tie rule."""
    bad = 0
    for b, j in zip(*np.nonzero(got_ids != want_ids)):
        near = np.abs(want_scores[b] - want_scores[b, j]) <= rel * abs(want_scores[b, j])
        bad += int(near.sum() <= 1)
    return bad


def sharded_phase(device, name: str, smi: str) -> dict:
    """[sharded]: SHARD_RANKS ranks on the one card, started by
    `run_ranks` on gloo, serve ml-20m-hstu-mol over a corpus of SHARD_ITEMS
    items sharded over the `item` axis, B=SHARD_BATCH, k=SHARD_K. Gated: the
    exact methods return the single-process exact path's ids on the same
    card (the same K2 scores: a shard's columns score as in the whole
    table); Naive and Comb at full budget over SHARD_SMALL_ITEMS items
    return the plain exact MoL's ids within one bf16 step (2^-7 of a score)
    of a tie; no rank returns id 0 or an id past X; every rank returns the
    same lists; each rank launched K1, K2 (with its tile maxima), K8, K9 and
    K10. Printed: the approximate methods' ms/batch and recall@200 beside
    the unsharded method's. Several ranks on one card check correctness:
    their times say nothing of four cards' speed."""
    import torch

    from rails_tpu_torch.cli.frontier import attach_ivf
    from rails_tpu_torch.train.profiling import timed_ms
    from rails_tpu_torch.core.distributed import run_ranks
    from rails_tpu_torch.index import top_k as tk
    from rails_tpu_torch.index.factory import get_top_k_raw
    from rails_tpu_torch.ops.mol_scoring import quantize_fused_tables

    work = Path("build") / "sharded"
    work.mkdir(parents=True, exist_ok=True)
    for f in work.glob("*"):
        f.unlink()
    with torch.inference_mode():
        model, feats, embed = shard_model(device)
        q, uids = model.encode(feats), feats.user_ids
        ids = torch.arange(1, SHARD_ITEMS + 1, dtype=torch.int32, device=device)
        state = tk.build_fused_state_chunked_on_device(model, ids, embed, tk.BUILD_CHUNK,
                                                       torch.bfloat16)
        want = {"MoLBruteForceTopKFused": tk.mol_brute_force_top_k_fused(model, state, q, SHARD_K,
                                                                         uids),
                "MoLBruteForceTopKFusedInt8": tk.mol_brute_force_top_k_fused(
                    model, state._replace(fused_tables=quantize_fused_tables(state.fused_tables)),
                    q, SHARD_K, uids)}
        small = small_state(model, embed, device)
        exact_small = tk.mol_brute_force_top_k(model, small, q, SHARD_K, uids)
        single = {}
        for m in SHARD_APPROX:
            st = attach_ivf(state, SHARD_NLIST, 10)[0] if m.startswith("MoLIVF") else state
            raw = get_top_k_raw(m)
            res = raw(model, st, q, SHARD_K, uids)
            single[m] = (res.ids.cpu().numpy(),
                         timed_ms(lambda: raw(model, st, q, SHARD_K, uids), SHARD_RUNS, device))
        del state
    t0 = time.perf_counter()
    run_ranks(sharded_rank, SHARD_RANKS, (SHARD_RANKS, str((work / "store").resolve()),
                                         str(work), str(device)), timeout=SHARD_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    outs = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(SHARD_RANKS)]
    print(f"[sharded] ml-20m-hstu-mol bf16 (K1 encode), {SHARD_ITEMS:,} items over "
          f"{SHARD_RANKS} ranks (slab {outs[0]['slab']:,} items), B={SHARD_BATCH}, k={SHARD_K}, "
          f"gloo, all on one card: ranks' wall {ranks_s:.1f} s, each rank's build of its slab "
          f"{[round(o['build_s'], 2) for o in outs]} s and of its IVF index (nlist "
          f"{SHARD_NLIST}) {[round(o['ivf_s'], 2) for o in outs]} s on {name} ({smi}); "
          f"several ranks on one card check correctness, their times say nothing of four "
          f"cards' speed")
    for m in SHARD_EXACT + SHARD_SMALL + SHARD_APPROX:
        for o in outs[1:]:
            if not (np.array_equal(o[m][0], outs[0][m][0]) and np.array_equal(o[m][1], outs[0][m][1])):
                raise AssertionError(f"[sharded] {m}: the ranks returned different lists")
        got_ids = outs[0][m][1]
        if got_ids.min() < 1 or got_ids.max() > SHARD_ITEMS:
            raise AssertionError(f"[sharded] {m}: ids outside [1, {SHARD_ITEMS}]")
    lines = []
    for m in SHARD_EXACT:
        w = want[m]
        bad = tie_rule(outs[0][m][1], w.ids.cpu().numpy(), w.scores.float().cpu().numpy(), 1e-6)
        dev = float(np.max(np.abs(outs[0][m][0] - w.scores.float().cpu().numpy())))
        lines.append(f"{m}: ids == the single-process path's ({bad} mismatches off a tie), "
                     f"max |score diff| {dev:.3g}, {outs[0][m][2]:.3f} ms/batch")
        if bad:
            raise AssertionError(f"[sharded] {m}: {bad} ids differ from the single-process path")
    for m in SHARD_SMALL:
        bad = tie_rule(outs[0][m][1], exact_small.ids.cpu().numpy(),
                       exact_small.scores.float().cpu().numpy(), 2.0 ** -7)
        lines.append(f"{m} over {SHARD_SMALL_ITEMS:,} items (full budget): {bad} ids off the "
                     f"exact MoL's beyond a bf16 tie")
        if bad:
            raise AssertionError(f"[sharded] {m} at full budget is not exact: {bad} ids")
    print("[sharded] " + "; ".join(lines))
    exact_ids = want["MoLBruteForceTopKFused"].ids.cpu().numpy()
    rows = []
    for m in SHARD_APPROX:
        rec, rec1 = (float(np.mean([len(set(a) & set(b)) / SHARD_K for a, b in zip(ids, exact_ids)]))
                     for ids in (outs[0][m][1], single[m][0]))
        rows.append(f"{m} {outs[0][m][2]:.3f} ms/batch recall@{SHARD_K} {rec:.4f} (unsharded "
                    f"{single[m][1]:.3f} ms, {rec1:.4f})")
    print("[sharded] approximate, per-shard budgets (not gated): " + "; ".join(rows))
    need = ("K1", "K2", "K2-bmax", "K8", "K9", "K10")
    for r, o in enumerate(outs):
        if any(not o["launches"][k] for k in need):
            raise AssertionError(f"[sharded] rank {r} launched none of some of {need}: "
                                 f"{o['launches']}")
    print(f"[sharded] launches per rank: "
          f"{[{k: o['launches'][k] for k in need + ('K2-tc', 'K8-tc', 'K9-tc', 'K10-tc')} for o in outs]}")
    return {k: sum(o["launches"][k] for o in outs) for k in need}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def shard_bench_phase(name: str, smi: str) -> dict:
    """[shard-bench]: `cli/shard_bench.py`'s `main` at one rank on NCCL over
    BENCH_ITEMS items, MoLBruteForceTopKFused: build s and ms/batch."""
    from rails_tpu_torch.cli import shard_bench
    from rails_tpu_torch.core import distributed

    reset_launches()
    try:
        summary = shard_bench.main(["--num-items", str(BENCH_ITEMS), "--runs", "10"])
    finally:
        distributed.shutdown()
    counts = launch_counts()
    print(f"[shard-bench] {summary['metric']}: {summary['num_items']:,} items, item_parallel "
          f"{summary['item_parallel']} (one rank, nccl): build {summary['build_seconds']:.2f} s, "
          f"{summary['ms_per_batch']:.3f} ms/batch = {summary['value']:.1f} queries/s; launches "
          f"K2 {counts['K2']}, K2-bmax {counts['K2-bmax']}, K2-tc {counts['K2-tc']} on {name} "
          f"({smi})")
    if not counts["K2-bmax"] or counts["K2-tc"] != counts["K2"]:
        raise AssertionError(f"[shard-bench] K2's tile maxima or tensor cores not used: {counts}")
    return counts


def dp_rank(rank: int, world: int, store: str, out_dir: str, device_name: str = "cuda:0") -> None:
    """One [dp-train] rank (gloo, the card): DP_STEPS data-parallel steps of
    each DP_CONFIGS config over its rows of the global batch; its losses,
    step 1's gradients, the parameters after the steps and its launches;
    then, with the fault planted (the HSTU hash streams number this rank's
    rows from 0, as if it were alone), step 1's gradients again."""
    import torch

    from rails_tpu_torch.core import distributed
    from rails_tpu_torch.core.config import MeshConfig
    from rails_tpu_torch.core.mesh import make_mesh
    from rails_tpu_torch.models import hstu

    device = torch.device(device_name)
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(f"file://{store}", world, rank, backend="gloo", device=device)
    mesh = make_mesh(MeshConfig(data_parallel=world, item_parallel=1))
    out = {tag: dp_steps(device, config, overrides, mesh) for tag, config, overrides, _ in DP_CONFIGS}
    own_row_span, hstu.row_span = hstu.row_span, lambda n: (0, n)
    try:
        for tag, config, overrides, _ in DP_CONFIGS:
            out[tag]["fault_grads"] = dp_steps(device, config, overrides, mesh, steps=1)["grads"]
    finally:
        hstu.row_span = own_row_span
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.shutdown()


def dp_steps(device, config: str, overrides: dict, mesh=None, steps: int = DP_STEPS) -> dict:
    """`steps` steps of `config` from chip_smoke's seeded state on its
    global batch of TRAIN_BATCH rows, this rank's rows with a mesh."""
    import torch

    from rails_tpu_torch.core.config import get_experiment_config
    from rails_tpu_torch.core.mesh import shard_batch
    from rails_tpu_torch.train.loop import create_train_state

    cfg = get_experiment_config(config)
    cfg = cfg.replace(train=cfg.train.replace(**overrides))
    model, state, step, _ = create_train_state(
        cfg, NUM_ITEMS, np.arange(1, NUM_ITEMS + 1, dtype=np.int32), seed=0, device=device,
        mesh=mesh)
    batch = train_batch(cfg, device)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    gen = torch.Generator(device=device).manual_seed(0)
    start = {k: p.detach().to("cpu", copy=True) for k, p in model.named_parameters()}
    reset_launches()
    losses, grads = [], None
    for i in range(steps):
        state, m = step(state, batch, gen)
        losses.append(m["loss"].item())
        if i == 0:
            grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                     if p.grad is not None}
    return dict(losses=losses, grads=grads, launches=launch_counts(), start=start,
                lr=cfg.train.learning_rate,
                params={k: p.detach().cpu() for k, p in model.named_parameters()})


def dp_train_phase(device, name: str, smi: str) -> dict:
    """[dp-train]: DP_RANKS ranks on the one card (gloo), DP_STEPS steps of
    ml-20m-hstu-mol and ml-20m-hstu-mol-fast (K6 scatter) at a global batch
    of TRAIN_BATCH (TRAIN_BATCH / DP_RANKS a rank), dropout at the configs'
    rates. Gated against the single-process port step over the same global
    batch on the card, which differs from it only in the order of its sums:
    each step's loss within DP_LOSS_RTOL; step 1's gradients within the
    config's limit of each tensor's largest value, and the planted fault's
    (a rank's hash streams numbered from 0) beyond it, so the gate
    separates the two; the parameters after the steps
    within DP_PARAM_RATIO of how far the steps moved them (L2 over every
    parameter), and no element further apart than the 2 x lr a step that
    AdamW can move one whose gradient is near 0 either way; the ranks'
    parameters bit-equal; each rank launched K3, K4 and K7, and K5 and K6 for
    -fast."""
    import torch

    from rails_tpu_torch.core.distributed import run_ranks

    work = Path("build") / "dp_train"
    work.mkdir(parents=True, exist_ok=True)
    for f in work.glob("*"):
        f.unlink()
    t0 = time.perf_counter()
    run_ranks(dp_rank, DP_RANKS, (DP_RANKS, str((work / "store").resolve()), str(work),
                                  str(device)), timeout=DP_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    outs = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(DP_RANKS)]
    launches = {}
    for tag, config, overrides, grad_tol in DP_CONFIGS:
        single = dp_steps(device, config, overrides)
        got = [o[tag] for o in outs]
        same = all(torch.equal(p, g["params"][k]) for g in got[1:] for k, p in got[0]["params"].items())
        loss_dev = max(abs(a - b) / abs(b) for a, b in zip(got[0]["losses"], single["losses"]))
        grad_dev, fault_dev = (
            max(float((grads[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                for k, g in single["grads"].items())
            for grads in (got[0]["grads"], got[0]["fault_grads"]))
        diff = torch.cat([(got[0]["params"][k] - p).reshape(-1)
                          for k, p in single["params"].items()]).double()
        moved = torch.cat([(p - single["start"][k]).reshape(-1)
                           for k, p in single["params"].items()]).double()
        p_ratio = float(diff.norm() / moved.norm())
        p_max = float(diff.abs().max())
        p_limit = 2 * single["lr"] * DP_STEPS
        shares = " / ".join(f"{float((diff.abs() > t).double().mean()):.3g}" for t in (1e-6, 1e-4))
        need = ("K3", "K4 fwd", "K4 bwd", "K7") + (("K5 fwd", "K5 bwd", "K6")
                                                   if tag.endswith("-fast") else ())
        counts = [{k: g["launches"][k] for k in need} for g in got]
        print(f"[dp-train] {tag}: {DP_RANKS} ranks x {TRAIN_BATCH // DP_RANKS} rows vs one "
              f"process x {TRAIN_BATCH}, {DP_STEPS} steps: losses {got[0]['losses']} vs "
              f"{single['losses']} (max rel {loss_dev:.3g}); step 1 gradients max "
              f"{grad_dev:.3g} of each tensor's largest (limit {grad_tol:g}; the planted fault, "
              f"hash streams numbered per rank: {fault_dev:.3g}); parameters after {DP_STEPS} steps: "
              f"apart {p_ratio:.3g} of their move (L2), max {p_max:.3g} (limit {p_limit:.3g}), "
              f"share more than 1e-6 / 1e-4 apart {shares} of {diff.numel():,}; ranks' parameters "
              f"bit-equal {same}; launches per rank {counts} (ranks' wall {ranks_s:.1f} s for "
              f"both configs) on {name} ({smi})")
        if not same:
            raise AssertionError(f"[dp-train] {tag}: the ranks' parameters differ")
        if fault_dev <= grad_tol:
            raise AssertionError(f"[dp-train] {tag}: the gradient gate passes the planted fault")
        if (loss_dev > DP_LOSS_RTOL or grad_dev > grad_tol or p_ratio > DP_PARAM_RATIO
                or p_max > p_limit):
            raise AssertionError(f"[dp-train] {tag}: the data-parallel step is off the "
                                 "single-process step")
        if any(not c[k] for c in counts for k in need):
            raise AssertionError(f"[dp-train] {tag}: a rank launched none of {need}")
        launches[tag] = counts
    return launches


CLI_USERS = 1_024              # synthetic users of the [cli] phase: 8 steps of 128 an epoch
CLI_SETS = ("data.dataset_name=synthetic", f"data.synthetic_num_users={CLI_USERS}",
            f"data.synthetic_num_items={NUM_ITEMS}", "hstu.fused_inference=true")
CLI_SWEEP_USERS = 512


def cli_phase(name: str, smi: str) -> dict:
    """[cli]: the port's training and eval CLIs on the card at
    ml-20m-hstu-mol's full width (D=256, 16 blocks, MoL 8x4x128) over
    CLI_USERS synthetic users and 26,744 items, every encode through K1
    (`hstu.fused_inference=true`): `cli.train` one epoch (B=128, the
    checkpoint, the JSONL log, one full eval), then a resume from its
    checkpoint for a second epoch; `cli.eval` with MoLBruteForceTopKFused,
    the latency and the recall against the exact method, once building and
    saving the serving state and once loading it (the two CSV value lines
    equal but for the two timing columns); `cli.train_bench` at its
    defaults, then with `--shared-negatives --fused-mol-loss
    --pallas-scatter` (the ml-20m-hstu-mol-fast step of `[train-fast]`);
    `cli.sweep` over the synthetic menu and CLI_SWEEP_USERS users. Gates:
    the resume's checkpoint continues the first (epoch 1, batch_id and step
    two epochs' steps), finite metrics, equal lines, and K1, K2, K4, K5, K6
    and K7 launched over the phase. The CLIs' own output goes to
    build/cli/cli.log."""
    import torch

    from rails_tpu_torch.cli import eval as eval_cli
    from rails_tpu_torch.cli import sweep, train, train_bench

    work = Path("build") / "cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    sets = [a for kv in CLI_SETS for a in ("--set", kv)]
    common = ["--config", "ml-20m-hstu-mol", *sets]
    log = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    times = {}
    with contextlib.redirect_stdout(log):
        t = time.perf_counter()
        first = train.main(common + ["--workdir", str(work), "--num-epochs", "1"])
        (run_dir,) = [p for p in work.iterdir() if p.is_dir()]
        ckpt0 = run_dir / "ckpts" / "ep0"
        resumed = train.main(common + ["--workdir", str(work), "--num-epochs", "2",
                                       "--restore-from-ckpt", str(ckpt0)])
        times["train"] = time.perf_counter() - t
        ckpt1 = run_dir / "ckpts" / "ep1"
        t = time.perf_counter()
        evals = [eval_cli.main(common + ["--ckpt", str(ckpt1), "--top-k-method",
                                         "MoLBruteForceTopKFused", "--include-eval-time",
                                         "--eval-against-brute-force", flag,
                                         str(work / "serving_state")])
                 for flag in ("--save-serving-state", "--load-serving-state")]
        times["eval"] = time.perf_counter() - t
        t = time.perf_counter()
        bench = train_bench.main([])
        bench_fast = train_bench.main(["--shared-negatives", "--fused-mol-loss",
                                       "--pallas-scatter"])
        times["train_bench"] = time.perf_counter() - t
        t = time.perf_counter()
        rows = sweep.main(common + ["--ckpt", str(ckpt1), "--menu", "synthetic",
                                    "--limit-users", str(CLI_SWEEP_USERS)])
        times["sweep"] = time.perf_counter() - t
    phase_s = time.perf_counter() - t0
    counts = launch_counts()
    (work / "cli.log").write_text(log.getvalue())
    payload = torch.load(ckpt1, map_location="cpu", weights_only=True)
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    print(f"[cli] train: ml-20m-hstu-mol, {CLI_USERS:,} synthetic users, B=128: epoch 0 "
          f"hr@10 {first.final_metrics['hr@10']:.4f} hr@50 {first.final_metrics['hr@50']:.4f}; "
          f"resumed from ep0 for epoch 1: hr@10 {resumed.final_metrics['hr@10']:.4f} hr@50 "
          f"{resumed.final_metrics['hr@50']:.4f}; ep1 epoch {payload['epoch']}, batch_id "
          f"{payload['batch_id']}, step {payload['step']}; {len(records)} JSONL records; "
          f"{times['train']:.1f} s")
    header, saved = evals[0]
    loaded = evals[1][1]
    print(f"[cli] eval (built, saved / loaded serving state), {times['eval']:.1f} s:")
    print(f"[cli]   {header}")
    print(f"[cli]   {saved}")
    print(f"[cli]   {loaded}")
    print(f"[cli] train_bench: {json.dumps(bench)}")
    print(f"[cli] train_bench --shared-negatives --fused-mol-loss --pallas-scatter: "
          f"{json.dumps(bench_fast)}")
    print(f"[cli] sweep ({len(rows)} methods, {CLI_SWEEP_USERS} users, {times['sweep']:.1f} s): "
          + "; ".join(f"{r['algorithm']} hr@10 {r['hr@10']:.4f} recall@10 "
                      f"{r.get('recall@10', 1.0):.4f} {r['EvalTimeAvgMs']:.3f} ms"
                      for r in rows))
    need = ("K1", "K2", "K4 fwd", "K4 bwd", "K5 fwd", "K5 bwd", "K6", "K7")
    print(f"[cli] launches over the phase: {({k: counts[k] for k in need + ('K2-tc',)})}; "
          f"phase {phase_s:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in times.items())}) "
          f"on {name} ({smi})")
    steps = 2 * (CLI_USERS // TRAIN_BATCH)
    if (payload["epoch"], payload["batch_id"], payload["step"]) != (1, steps, steps):
        raise AssertionError("[cli] the resumed run does not continue the first one")
    finite = [first.final_metrics["hr@10"], resumed.final_metrics["mrr"], bench["value"],
              bench_fast["value"]]
    finite += [float(v) for v in saved.split(",")] + [r["hr@10"] for r in rows]
    if not all(np.isfinite(finite)):
        raise AssertionError("[cli] a metric is not finite")
    if saved.split(",")[:-2] != loaded.split(",")[:-2]:
        raise AssertionError("[cli] the loaded serving state evaluates otherwise than the built")
    if any(not counts[k] for k in need):
        raise AssertionError(f"[cli] kernels not launched on the CLIs' paths: {counts}")
    return counts


COMPAT_STEPS = 3               # torch AdamW steps before the import


def compat_phase(name: str, smi: str) -> dict:
    """[compat]: checkpoints of the original torch repo at ml-20m-hstu-mol's
    full width, through the port's CLIs and `[cli]`'s run (its CLI_SETS and
    its ep1): export ep1 to the reference's payload; make a second payload
    with an `optimizer_state_dict`, that of `torch.optim.AdamW` (the
    reference's optimizer: the config's betas and weight decay, eps 1e-8,
    the port schedule's learning rate) over the first payload's parameters
    as `nn.Parameter`s in its key order, after COMPAT_STEPS steps of seeded
    gradients; import both. Gates: the first import's weights bit-equal to
    ep1's; the second's weights and moments bit-equal to torch's after the
    mapping, count COMPAT_STEPS; one more step through the port's
    `FusedAdamW` (K7) on the mapped gradients within rtol 2e-5, atol 1e-7 of
    torch's next step (JAX's limits, `tests/test_torch_import.py:570-573`);
    `cli.eval` (MoLBruteForceTopKFused) of the first import prints ep1's
    CSV line but for the two timing columns; `cli.train` resumes from the
    second for one epoch with finite losses, epoch, batch_id and step
    continuing; export and import of the resumed checkpoint give it back;
    K1, K2, K4 and K7 launched over the phase. The CLIs' output goes to
    build/compat/compat.log."""
    import copy

    import torch

    from rails_tpu_torch.cli import eval as eval_cli
    from rails_tpu_torch.cli import export_checkpoint, import_checkpoint, train
    from rails_tpu_torch.cli.train import apply_override
    from rails_tpu_torch.compat.torch_import import fresh_model, state_dict_from_reference
    from rails_tpu_torch.core.config import get_experiment_config
    from rails_tpu_torch.train.fused_adamw import FusedAdamWState, adamw_update_leaves
    from rails_tpu_torch.train.loop import make_optimizer

    device = torch.device("cuda", 0)
    (cli_run,) = [p for p in (Path("build") / "cli").iterdir() if (p / "ckpts").is_dir()]
    ep1 = str(cli_run / "ckpts" / "ep1")
    work = Path("build") / "compat"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    common = ["--config", "ml-20m-hstu-mol", *[a for kv in CLI_SETS for a in ("--set", kv)]]
    cfg = get_experiment_config("ml-20m-hstu-mol")
    for kv in CLI_SETS:
        cfg = apply_override(cfg, *kv.split("=", 1))

    def load(path):
        return torch.load(path, map_location="cpu", weights_only=True)

    def same(a: dict, b: dict) -> bool:
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    log = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    times = {}
    with contextlib.redirect_stdout(log):
        t = time.perf_counter()
        ref_ep1 = export_checkpoint.main(common + ["--ckpt", ep1, "--out", str(work / "ref_ep1")])
        times["export"] = time.perf_counter() - t

        # The reference's optimizer over the exported parameters; the port's
        # model and FusedAdamW for the step after the import.
        ref = load(ref_ep1)
        sd = ref["model_state_dict"]
        names = [k for k in sd if not k.endswith("_attn_mask")]
        params = [torch.nn.Parameter(sd[k].to(device)) for k in names]
        model = fresh_model(cfg, NUM_ITEMS, device)
        optimizer = make_optimizer(cfg, model)

        def lr_at(count: int) -> float:
            lr = optimizer.learning_rate
            return float(np.float32(lr(count) if callable(lr) else lr))

        tr = cfg.train
        opt = torch.optim.AdamW(params, lr=lr_at(0), betas=(tr.beta1, tr.beta2), eps=1e-8,
                                weight_decay=tr.weight_decay)
        gen = torch.Generator(device).manual_seed(22)

        def torch_step(count: int) -> list:
            grads = [torch.randn(p.shape, generator=gen, device=device) for p in params]
            for p, g in zip(params, grads):
                p.grad = g
            for group in opt.param_groups:
                group["lr"] = lr_at(count)
            opt.step()
            return grads

        for count in range(COMPAT_STEPS):
            torch_step(count)
        it = iter(params)
        payload = dict(ref, optimizer_state_dict=copy.deepcopy(opt.state_dict()))
        payload["model_state_dict"] = {k: v if k.endswith("_attn_mask") else next(it).detach()
                                       for k, v in sd.items()}
        torch.save(payload, work / "ref_adamw")
        t = time.perf_counter()
        imported = import_checkpoint.main(common + ["--ckpt", ref_ep1,
                                                    "--out", str(work / "imported")])
        times["import"] = time.perf_counter() - t
        t = time.perf_counter()
        imported2 = import_checkpoint.main(common + ["--ckpt", str(work / "ref_adamw"),
                                                     "--out", str(work / "imported_adamw")])
        times["import with AdamW"] = time.perf_counter() - t

        def mapped(tensors) -> dict:
            return state_dict_from_reference(dict(zip(names, tensors)), cfg, validate=False)

        got2 = load(imported2)
        state = [opt.state[p] for p in params]
        weights_ok = same(got2["model"], mapped(p.detach() for p in params))
        moments_ok = (same(got2["opt_state"]["mu"], mapped(s["exp_avg"] for s in state))
                      and same(got2["opt_state"]["nu"], mapped(s["exp_avg_sq"] for s in state)))
        model.load_state_dict(got2["model"], strict=True)
        opt_state = got2["opt_state"]
        optimizer.state = FusedAdamWState(
            opt_state["count"], *({k: v.to(device) for k, v in opt_state[m].items()}
                                  for m in ("mu", "nu")))
        k7 = adamw_update_leaves.launches
        grads = torch_step(COMPAT_STEPS)
        optimizer.step({k: v.to(device) for k, v in mapped(grads).items()})
        k7 = adamw_update_leaves.launches - k7
        want = mapped(p.detach() for p in params)
        step_err, step_ok = 0.0, True
        for k, p in model.named_parameters():
            diff = (p.detach().cpu() - want[k]).abs()
            step_err = max(step_err, float(diff.max()))
            step_ok &= bool((diff <= 1e-7 + 2e-5 * want[k].abs()).all())

        t = time.perf_counter()
        eval_args = ["--top-k-method", "MoLBruteForceTopKFused", "--include-eval-time",
                     "--eval-against-brute-force"]
        evals = [eval_cli.main(common + ["--ckpt", c] + eval_args) for c in (ep1, imported)]
        times["eval x2"] = time.perf_counter() - t
        t = time.perf_counter()
        epoch2 = got2["epoch"]
        resumed = train.main(common + ["--set", "train.eval_interval=1", "--workdir",
                                       str(work / "resume"), "--num-epochs", str(epoch2 + 2),
                                       "--restore-from-ckpt", imported2])
        times["resume"] = time.perf_counter() - t
        (run_dir,) = [p for p in (work / "resume").iterdir() if p.is_dir()]
        resumed_ckpt = str(run_dir / "ckpts" / f"ep{epoch2 + 1}")
        t = time.perf_counter()
        again = import_checkpoint.main(common + [
            "--ckpt", export_checkpoint.main(common + ["--ckpt", resumed_ckpt,
                                                       "--out", str(work / "ref_resumed")]),
            "--out", str(work / "again")])
        times["export + import"] = time.perf_counter() - t
    phase_s = time.perf_counter() - t0
    counts = launch_counts()
    (work / "compat.log").write_text(log.getvalue())

    got1, orig = load(imported), load(ep1)
    after, back = load(resumed_ckpt), load(again)
    losses = [r["train/loss"] for r in map(json.loads, (run_dir / "metrics.jsonl").read_text()
                                            .splitlines()) if "train/loss" in r]
    steps = CLI_USERS // TRAIN_BATCH
    print(f"[compat] export of [cli]'s ep1 {times['export']:.2f} s, import "
          f"{times['import']:.2f} s, with AdamW moments {times['import with AdamW']:.2f} s "
          f"(ml-20m-hstu-mol, {NUM_ITEMS:,} items, {len(names)} tensors); weights bit-equal to "
          f"ep1: {same(got1['model'], orig['model'])}; after {COMPAT_STEPS} torch AdamW steps "
          f"weights {weights_ok}, moments {moments_ok}, count {opt_state['count']}")
    print(f"[compat] step {COMPAT_STEPS + 1}: FusedAdamW (K7 launches {k7}) vs torch.optim.AdamW: "
          f"max abs err {step_err:.3e}, within rtol 2e-5 atol 1e-7: {step_ok}")
    print(f"[compat] eval of ep1 / of its import ({times['eval x2']:.1f} s):")
    print(f"[compat]   {evals[0][0]}")
    print(f"[compat]   {evals[0][1]}")
    print(f"[compat]   {evals[1][1]}")
    print(f"[compat] resumed from the AdamW import for epoch {epoch2 + 1} "
          f"({times['resume']:.1f} s): {len(losses)} losses {losses[0]:.5f} .. {losses[-1]:.5f}, "
          f"hr@10 {resumed.final_metrics['hr@10']:.4f}; epoch {after['epoch']}, batch_id "
          f"{after['batch_id']}, step {after['step']}; export + import again "
          f"{times['export + import']:.2f} s, identity "
          f"{same(back['model'], after['model'])}")
    need = ("K1", "K2", "K4 fwd", "K4 bwd", "K7")
    print(f"[compat] launches over the phase: {({k: counts[k] for k in need + ('K2-tc',)})}; "
          f"phase {phase_s:.1f} s on {name} ({smi})")
    if not same(got1["model"], orig["model"]):
        raise AssertionError("[compat] the import of the export is not ep1")
    if not (weights_ok and moments_ok and opt_state["count"] == COMPAT_STEPS):
        raise AssertionError("[compat] torch's weights or AdamW state did not import exactly")
    if not step_ok or not k7:
        raise AssertionError("[compat] the step after the import does not match torch's")
    if evals[0][0] != evals[1][0] or evals[0][1].split(",")[:-2] != evals[1][1].split(",")[:-2]:
        raise AssertionError("[compat] the imported checkpoint evaluates otherwise than ep1")
    if ((after["epoch"], after["batch_id"], after["step"])
            != (epoch2 + 1, got2["batch_id"] + steps, COMPAT_STEPS + steps)
            or len(losses) != steps or not np.isfinite(losses + [
                resumed.final_metrics["hr@10"]]).all()):
        raise AssertionError("[compat] the resumed run does not continue the import")
    if not same(back["model"], after["model"]) or (back["epoch"], back["batch_id"]) != (
            after["epoch"], after["batch_id"]):
        raise AssertionError("[compat] export and import of the resumed checkpoint differ")
    if any(not counts[k] for k in need):
        raise AssertionError(f"[compat] kernels not launched on the phase's paths: {counts}")
    return counts


def main() -> None:
    import torch

    from rails_tpu_torch.core.config import get_experiment_config
    from rails_tpu_torch.core.device import require_cuda
    from rails_tpu_torch.ops import _build
    from rails_tpu_torch.ops.hstu_block_train import (
        tc_bwd_route,
        tc_fwd_route,
        tf32_bwd_route,
        tf32_fwd_route,
        variant_name,
    )

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
    print(f"[build] every kernel for sm_90a in {time.perf_counter() - t0:.1f} s -> {lib_path}")
    print(f"[build] registers per thread (spilled bytes): "
          f"{ptxas_summary((lib_path.parent / 'build.log').read_text())}")
    sass = tensor_core_sass(lib_path)
    print(f"[build] tensor-core instructions in the SASS (HMMA, HGMMA) of K1's bf16 kernels "
          f"(<DVP, 1>: K4's TRAIN attention), K4's bf16 backward kernels, K4's f32 route "
          f"(tc_tf32_*: TF32 HMMA) and K2's, K5's and K8/K9's tensor-core kernels: "
          f"{ {k: tuple(v) for k, v in sass.items()} }")

    k1 = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n in (64, MAX_SEQ_LEN):
            k1[(dtype, n)] = check_k1(BATCH, n, dtype, device)
    k1_stages = check_k1_stages(BATCH, MAX_SEQ_LEN, device)
    k1_tf32 = check_k1_tf32_stages(BATCH, MAX_SEQ_LEN, device)
    untouched_hashes(device)
    chunked_hashes(device)
    preprocessor_hashes(device)
    for dtype in (torch.float32, torch.bfloat16):
        check_k1(BATCH, K1_GEOMS["books"][4], dtype, device, "books")
        check_k1(BATCH, MAX_SEQ_LEN, dtype, device, "ml-1m")
        check_k1(BATCH, MAX_SEQ_LEN, dtype, device, "h=4", "softmax_rel_bias")
    torch.cuda.empty_cache()
    k2 = {kind: check_k2(BATCH, NUM_ITEMS, kind, device)
          for kind in ("float32", "bfloat16", "int8")}
    e2e = end_to_end(device, name, smi)
    launches = dict(e2e["bfloat16"])
    torch.cuda.empty_cache()
    k3 = check_k3(device)
    k4_fwd, k4_bwd = check_k4(device, torch.float32)
    k4_fwd16, k4_bwd16 = check_k4(device, torch.bfloat16)
    k4_stages = check_k4_stages(device)
    k4_tf32 = check_k4_tf32_stages(device)
    k7 = check_k7(device)
    torch.cuda.empty_cache()
    # Each path reports the launches of the kernels it adds.
    train = train_phase(device, name, smi)
    launches.update({k: train[k] for k in ("K3", "K4 fwd", "K4 bwd", "K7") + K4_TF32_STAGES})
    torch.cuda.empty_cache()
    train16 = train_phase(device, name, smi, tag="train-bf16", main_module_bf16=True)
    torch.cuda.empty_cache()
    k5_fwd, k5_bwd = check_k5(device)
    ml1m = get_experiment_config("ml-1m-hstu-mol-fast").mol
    check_k5(device, geom=(ml1m.query_dot_product_groups, ml1m.item_dot_product_groups,
                           ml1m.dot_product_dimension),
             rates=(ml1m.softmax_dropout_rate, ml1m.gating_qi_dropout_rate), what="ML-1M")
    torch.cuda.empty_cache()
    cfg = get_experiment_config("ml-20m-hstu-mol")
    k6 = check_k6(device, train_batch(cfg, device).features.ids)
    books_cfg = get_experiment_config("amzn-books-hstu-mol")
    check_k6(device, train_batch(books_cfg, device, BOOKS_BATCH, BOOKS_ITEMS, "uniform")
             .features.ids, BOOKS_ITEMS + 1, books_cfg.train.item_embedding_dim)
    # Zipf-popular items in a batch of 1,024 users: ~600 rows of more than
    # 32 updates over 53 chunks of 4,096 ids, where the long rows' placement
    # does most of its work.
    check_k6(device, zipf_ids(device, (1024, 211), NUM_ITEMS), long_sums=True)
    torch.cuda.empty_cache()
    fast = train_phase(device, name, smi, "ml-20m-hstu-mol-fast", "train-fast",
                       pallas_scatter_grad=True)
    launches.update({k: fast[k] for k in ("K5 fwd", "K5 bwd", "K6")})
    torch.cuda.empty_cache()
    bounds = check_bounds(device)
    bmax = check_k2_blockmax(device)
    torch.cuda.empty_cache()
    with torch.inference_mode():
        approx_phase(device, name, smi)
    torch.cuda.empty_cache()
    approx = approx_e2e(device, name, smi)
    launches.update({k: approx[k] for k in ("K8", "K9", "K10", "K8-tc", "K9-tc", "K10-tc")})
    torch.cuda.empty_cache()
    with torch.inference_mode():
        ivf_phase(device, name, smi)
    torch.cuda.empty_cache()
    with torch.inference_mode():
        launches.update(int8_phase(device, name, smi))
    torch.cuda.empty_cache()
    e2e8 = int8_e2e(device, name, smi)
    launches.update({k: e2e8[k] for k in ("K2-int8", "K8-int8")})
    if e2e8["K2-tc"] != e2e8["K2"] or e2e8["K8-tc"] != e2e8["K8"]:
        raise AssertionError(f"[int8-e2e]: int8 K2 / K8 off the tensor cores: {e2e8}")
    torch.cuda.empty_cache()
    front = frontier_phase(device, name, smi)
    launches.update({k: front[k] for k in ("K4 fwd (bf16)", "K4 bwd (bf16)")})
    torch.cuda.empty_cache()

    # Amazon Books: the 8x8x32 kernels at its serving shapes, the bf16 K5 at
    # its training shapes, then its serving and training paths.
    k2b = {kind: check_k2(BOOKS_BATCH, BOOKS_ITEMS, kind, device, BOOKS_GEOM)
           for kind in ("float32", "bfloat16", "int8")}
    torch.cuda.empty_cache()
    boundsb = check_bounds(device, BOOKS_BATCH, BOOKS_ITEMS, BOOKS_GEOM)
    bmaxb = check_k2_blockmax(device, BOOKS_BATCH, BOOKS_ITEMS, BOOKS_GEOM, BOOKS_INVALID)
    torch.cuda.empty_cache()
    k5b_fwd, k5b_bwd = check_k5(
        device, BOOKS_BATCH * (books_cfg.max_seq_len_padded - 1), books_cfg.train.num_negatives,
        BOOKS_GEOM, "bfloat16",
        (books_cfg.mol.softmax_dropout_rate, books_cfg.mol.gating_qi_dropout_rate), "Books")
    torch.cuda.empty_cache()
    books = books_e2e(device, name, smi)
    torch.cuda.empty_cache()
    books_train = {"lengths": "uniform", "batch_size": BOOKS_BATCH, "num_items": BOOKS_ITEMS}
    train_phase(device, name, smi, "amzn-books-hstu-mol", "books-train", **books_train)
    torch.cuda.empty_cache()
    fastb = train_phase(device, name, smi, "amzn-books-hstu-mol-fast", "books-train-fast",
                        **books_train)
    books.update({k: fastb[k] for k in ("K5 fwd (bf16)", "K5 bwd (bf16)")})
    torch.cuda.empty_cache()

    # K1's variants at ML-20M width and their serving runs; the cost probes.
    k1v = {(inst, dtype): check_k1_variant(BATCH, MAX_SEQ_LEN, dtype, device, inst)
           for inst in K1_VAR_INSTANCES for dtype in (torch.float32, torch.bfloat16)}
    torch.cuda.empty_cache()
    k1v_runs = variants_e2e(device, name, smi)
    torch.cuda.empty_cache()
    p1 = p1_phase(device, name, smi)
    torch.cuda.empty_cache()
    p2 = p2_phase(device, name, smi)
    torch.cuda.empty_cache()

    # K4's variants at ML-20M width and a training run of each.
    k4v = {(inst, dtype): check_k4(device, dtype, inst)
           for inst in K4_VAR_INSTANCES for dtype in (torch.float32, torch.bfloat16)}
    torch.cuda.empty_cache()
    k4v_runs = train_var_phase(device, name, smi)
    torch.cuda.empty_cache()

    # SASRec and the dot-product similarity at ml-20m widths, the other
    # registry configs they open, and the options no registry config sets
    # with the K1/K4/K6 instances they reach.
    serve_phase(device, name, smi, "sasrec-e2e", "ml-20m-sasrec-mol", NUM_ITEMS, BATCH, 3)
    torch.cuda.empty_cache()
    train_phase(device, name, smi, "ml-20m-sasrec-mol", "sasrec-train")
    torch.cuda.empty_cache()
    serve_phase(device, name, smi, "dot-e2e", "ml-20m-hstu-dot", NUM_ITEMS, BATCH, 3)
    torch.cuda.empty_cache()
    train_phase(device, name, smi, "ml-20m-hstu-dot", "dot-train")
    torch.cuda.empty_cache()
    models_phase(device, name, smi)
    var_runs = models_var_phase(device, name, smi)
    k1p = {(geom, dtype): check_k1(BATCH, K1_GEOMS[geom][4], dtype, device, geom)
           for geom in ("rated", "combined") for dtype in (torch.float32, torch.bfloat16)}
    torch.cuda.empty_cache()
    k4p = {(geom, dtype): check_k4(device, dtype, geom_name=geom)
           for geom in ("rated", "combined") for dtype in (torch.float32, torch.bfloat16)}
    torch.cuda.empty_cache()
    cat_cfg = configure(get_experiment_config("ml-20m-hstu-mol"), VAR_OPTIONS["categorical"])
    cat_ids = train_batch(cat_cfg, device).features.ids
    cat_rows = torch.as_tensor(category_map(cat_cfg, NUM_ITEMS), device=device)[
        (cat_ids.long() - 1).clamp(min=0)] + 1
    k6c = check_k6(device, torch.where(cat_ids == 0, 0, cat_rows).to(torch.int32),
                   NUM_CATEGORIES + 1, D, long_sums=True)
    torch.cuda.empty_cache()
    data_phase(device, name, smi)
    torch.cuda.empty_cache()
    # The scale slice: an item-sharded corpus over 4 ranks, shard_bench at
    # one rank, data-parallel training over 2 ranks, all on this card.
    sharded_phase(device, name, smi)
    torch.cuda.empty_cache()
    shard_bench_phase(name, smi)
    torch.cuda.empty_cache()
    dp_train_phase(device, name, smi)
    torch.cuda.empty_cache()
    # The training driver and the CLIs (train, resume, eval, train_bench, sweep).
    cli_phase(name, smi)
    torch.cuda.empty_cache()
    # Checkpoints of the original torch repo: export, import, resume.
    compat_phase(name, smi)

    def entry(name_, source, replaces, key, measured, counts=launches):
        # The MUFU term of a bound is an operations term.
        return {"name": name_, "route": "cuda", "source": f"rails_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": counts[key],
                **{k: measured[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")},
                "bound_by": "bytes" if measured["bound_by"] == "bytes" else "operations",
                "library_ms": measured["library_ms"]}

    summary = [
        entry("fused_hstu_block", "hstu_block.cu", "rails_tpu/ops/pallas/hstu_block.py:432",
              "K1", k1[(torch.bfloat16, MAX_SEQ_LEN)]),
        entry("fused_mol_scores_t", "mol_scoring_tc.cuh",
              "rails_tpu/ops/pallas/mol_scoring.py:724", "K2-tc", k2["bfloat16"]),
        entry("hash_keep_mask", "hash_dropout.cu", "rails_tpu/ops/pallas/hash_dropout.py:26",
              "K3", k3),
        entry("fused_train_block_forward", "hstu_train_tf32.cuh",
              "rails_tpu/ops/pallas/hstu_block_train.py:574", "K4 fwd", k4_fwd),
        entry("attn_backward", "hstu_train_tf32.cuh",
              "rails_tpu/ops/pallas/hstu_block_train.py:629", "K4 bwd", k4_bwd),
        entry("fused_mol_loss_forward", "mol_loss_tc.cuh",
              "rails_tpu/ops/pallas/mol_loss_train.py:143", "K5 fwd", k5_fwd),
        entry("fused_mol_loss_backward", "mol_loss_tc.cuh",
              "rails_tpu/ops/pallas/mol_loss_train.py:159", "K5 bwd", k5_bwd),
        entry("scatter_add_rows", "scatter_add.cu", "rails_tpu/ops/pallas/scatter_add.py:172",
              "K6", k6),
        entry("adamw_update_leaves", "fused_adamw.cu", "rails_tpu/train/fused_adamw.py:87",
              "K7", k7),
        entry("fused_mol_ub_t (mol_bounds_tc_kernel)", "mol_bounds.cu",
              "rails_tpu/ops/pallas/mol_scoring.py:427", "K8-tc", bounds["K8"]),
        entry("fused_mol_group_block_max (mol_bounds_tc_kernel)", "mol_bounds.cu",
              "rails_tpu/ops/pallas/mol_scoring.py:346", "K9-tc", bounds["K9"]),
        entry("fused_mol_scores_tiles", "mol_scoring_tc.cuh",
              "rails_tpu/ops/pallas/mol_scoring.py:875", "K10-tc", bounds["K10"]),
        entry("fused_mol_scores_t (int8 tables, mol_tc_kernel)", "mol_scoring_tc.cuh",
              "rails_tpu/ops/pallas/mol_scoring.py:724", "K2-int8", k2["int8"]),
        entry("fused_mol_scores_t (emit_blockmax)", "mol_scoring_tc.cuh",
              "rails_tpu/ops/pallas/mol_scoring.py:724", "K2-bmax", bmax),
        entry("fused_mol_ub_t (int8 tables, mol_bounds_tc_kernel)", "mol_bounds.cu",
              "rails_tpu/ops/pallas/mol_scoring.py:427", "K8-int8", bounds["K8-int8"]),
        entry("fused_mol_group_block_max (int8 tables, mol_bounds_tc_kernel)", "mol_bounds.cu",
              "rails_tpu/ops/pallas/mol_scoring.py:346", "K9-int8", bounds["K9-int8"]),
        entry("fused_mol_scores_tiles (int8 tables, mol_tc_kernel)", "mol_scoring_tc.cuh",
              "rails_tpu/ops/pallas/mol_scoring.py:875", "K10-int8", bounds["K10-int8"]),
        entry("fused_train_block_forward (bf16)", "hstu_block_tc.cuh",
              "rails_tpu/ops/pallas/hstu_block_train.py:574", "K4 fwd (bf16)", k4_fwd16),
        entry("attn_backward (bf16)", "hstu_train_tc.cuh",
              "rails_tpu/ops/pallas/hstu_block_train.py:629", "K4 bwd (bf16)", k4_bwd16),
        entry("fused_mol_scores_t (8x8x32)", "mol_scoring_tc.cuh",
              "rails_tpu/ops/pallas/mol_scoring.py:724", "K2-tc", k2b["bfloat16"], books),
        entry("fused_mol_scores_t (8x8x32, int8 tables, mol_tc_kernel)", "mol_scoring_tc.cuh",
              "rails_tpu/ops/pallas/mol_scoring.py:724", "K2-int8", k2b["int8"], books),
        entry("fused_mol_scores_t (8x8x32, emit_blockmax)", "mol_scoring_tc.cuh",
              "rails_tpu/ops/pallas/mol_scoring.py:724", "K2-bmax", bmaxb, books),
        entry("fused_mol_ub_t (8x8x32, mol_bounds_tc_kernel)", "mol_bounds.cu",
              "rails_tpu/ops/pallas/mol_scoring.py:427", "K8-tc", boundsb["K8"], books),
        entry("fused_mol_ub_t (8x8x32, int8 tables, mol_bounds_tc_kernel)", "mol_bounds.cu",
              "rails_tpu/ops/pallas/mol_scoring.py:427", "K8-int8", boundsb["K8-int8"], books),
        entry("fused_mol_group_block_max (8x8x32, mol_bounds_tc_kernel)", "mol_bounds.cu",
              "rails_tpu/ops/pallas/mol_scoring.py:346", "K9-tc", boundsb["K9"], books),
        entry("fused_mol_group_block_max (8x8x32, int8 tables, mol_bounds_tc_kernel)",
              "mol_bounds.cu", "rails_tpu/ops/pallas/mol_scoring.py:346", "K9-int8",
              boundsb["K9-int8"], books),
        entry("fused_mol_scores_tiles (8x8x32)", "mol_scoring_tc.cuh",
              "rails_tpu/ops/pallas/mol_scoring.py:875", "K10-tc", boundsb["K10"], books),
        entry("fused_mol_scores_tiles (8x8x32, int8 tables, mol_tc_kernel)", "mol_scoring_tc.cuh",
              "rails_tpu/ops/pallas/mol_scoring.py:875", "K10-int8", boundsb["K10-int8"], books),
        entry("fused_mol_loss_forward (bf16, 8x8x32)", "mol_loss_tc.cuh",
              "rails_tpu/ops/pallas/mol_loss_train.py:143", "K5 fwd (bf16)", k5b_fwd, books),
        entry("fused_mol_loss_backward (bf16, 8x8x32)", "mol_loss_tc.cuh",
              "rails_tpu/ops/pallas/mol_loss_train.py:159", "K5 bwd (bf16)", k5b_bwd, books),
    ]
    summary += [
        entry(f"fused_hstu_block ({inst}, bf16)", "hstu_block.cu",
              "rails_tpu/ops/pallas/hstu_block.py:432", "K1", k1v[(inst, torch.bfloat16)],
              k1v_runs[(inst, "bfloat16")])
        for inst in K1_VAR_INSTANCES
    ]
    tc_src, k1_site = "hstu_block_tc.cuh", "rails_tpu/ops/pallas/hstu_block.py:432"
    summary += [
        entry("tc_proj_kernel (K1 LayerNorm + projection, bf16)", tc_src, k1_site, "K1 proj",
              k1_stages["project"]),
        entry("tc_attn_kernel (K1 attention + o_input, bf16)", tc_src, k1_site, "K1 attn",
              k1_stages["attention"]),
        entry("tc_softmax_kernel (K1 softmax attention + o_input, bf16)", tc_src, k1_site,
              "K1 attn", k1_stages["attention softmax"], k1v_runs[("softmax", "bfloat16")]),
        entry("tc_out_kernel (K1 output GEMM, bf16)", tc_src, k1_site, "K1 out",
              k1_stages["out_gemm"]),
    ]
    # K1's f32 route (3xTF32): the block on the f32 serving path, its kernels
    # (launches from [e2e] f32; the softmax kernel's from its variant's f32
    # serving run) and its f32 variant instances.
    serve_src, f32_runs = "hstu_serve_tf32.cuh", e2e["float32"]
    summary += [
        entry("fused_hstu_block (f32, 3xTF32)", "hstu_serve_tf32.cu", k1_site, "K1",
              k1[(torch.float32, MAX_SEQ_LEN)], f32_runs),
        entry("serve_proj_kernel (K1 LayerNorm + projection, f32 3xTF32)", serve_src,
              k1_site, "K1 f32 proj", k1_tf32["project"], f32_runs),
        entry("serve_attn_kernel (K1 pointwise attention, f32 3xTF32)", serve_src, k1_site,
              "K1 f32 attn", k1_tf32["attention"], f32_runs),
        entry("serve_softmax_kernel (K1 softmax attention, f32 3xTF32)", serve_src, k1_site,
              "K1 f32 softmax", k1_tf32["attention softmax"], k1v_runs[("softmax", "float32")]),
        entry("serve_out_kernel (K1 o_input + output GEMM, f32 3xTF32)", serve_src,
              k1_site, "K1 f32 out", k1_tf32["out_gemm"], f32_runs),
    ]
    summary += [
        entry(f"fused_hstu_block ({inst}, f32, 3xTF32)", "hstu_serve_tf32.cu", k1_site, "K1",
              k1v[(inst, torch.float32)], k1v_runs[(inst, "float32")])
        for inst in K1_VAR_INSTANCES if (inst, "float32") in k1v_runs
    ]
    k4_fwd_site = "rails_tpu/ops/pallas/hstu_block_train.py:574"
    k4_bwd_site = "rails_tpu/ops/pallas/hstu_block_train.py:629"
    summary += [
        entry("tc_attn_kernel<32, TRAIN> (K4 attention + dropout + o_input, bf16)", tc_src,
              k4_fwd_site, "K4 attn", k4_stages["K4 attn"], train16),
        entry("tc_bwd_rows_kernel (K4 attn recompute + LN backward, bf16)", "hstu_train_tc.cuh",
              k4_bwd_site, "K4 bwd rows", k4_stages["K4 bwd rows"], train16),
        entry("tc_bwd_dq_kernel (K4 d_q + dbias, bf16)", "hstu_train_tc.cuh", k4_bwd_site,
              "K4 bwd dq", k4_stages["K4 bwd dq"], train16),
        entry("tc_bwd_dkv_kernel (K4 d_k + d_v, bf16)", "hstu_train_tc.cuh", k4_bwd_site,
              "K4 bwd dkv", k4_stages["K4 bwd dkv"], train16),
    ]
    tf32_src = "hstu_train_tf32.cuh"
    summary += [
        entry(f"{kernel} ({what}, f32 3xTF32)", tf32_src, site, stage, k4_tf32[stage])
        for kernel, what, site, stage in (
            ("tc_tf32_proj_kernel", "K4 LayerNorm + projection", k4_fwd_site, "K4 f32 proj"),
            ("tc_tf32_attn_kernel", "K4 attention", k4_fwd_site, "K4 f32 attn"),
            ("tc_tf32_out_kernel", "K4 o_input + output GEMM", k4_fwd_site, "K4 f32 out"),
            ("tc_tf32_dq_kernel", "K4 d_q + dbias", k4_bwd_site, "K4 f32 bwd dq"),
            ("tc_tf32_dkv_kernel", "K4 d_k + d_v", k4_bwd_site, "K4 f32 bwd dkv"))
    ]
    summary += [
        entry("encode_probe_block (full)", "encode_probe.cu",
              "rails_tpu/cli/encode_probe.py:150", "P1", p1["full"], {"P1": p1["launches"]}),
        entry("mol_probe_scores (full)", "mol_scoring_tc.cuh", "rails_tpu/cli/mol_probe.py:156",
              "P2", p2["full"], {"P2": p2["launches"]}),
    ]
    for inst in K4_VAR_INSTANCES:
        meta, has_bias = k4_meta(inst)
        variant = variant_name(meta, has_bias)
        for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, ", bf16")):
            fwd, bwd = k4v[(inst, dtype)]
            runs = k4v_runs[(inst, dtype)]
            fwd_src = ("hstu_block_tc.cuh" if tc_fwd_route(dtype, D, meta) else
                       "hstu_train_tf32.cuh" if tf32_fwd_route(dtype, D, MAX_SEQ_LEN, meta) else
                       "hstu_block_train.cu")
            bwd_src = ("hstu_train_tc.cuh" if tc_bwd_route(dtype, meta) else
                       "hstu_train_tf32.cuh" if tf32_bwd_route(dtype, MAX_SEQ_LEN, meta) else
                       "hstu_softmax_train.cu" if meta.softmax else "hstu_block_train.cu")
            summary += [
                entry(f"fused_train_block_forward ({inst}{suffix})", fwd_src,
                      "rails_tpu/ops/pallas/hstu_block_train.py:574", f"K4 fwd [{variant}]", fwd,
                      runs),
                entry(f"attn_backward ({inst}{suffix})", bwd_src,
                      "rails_tpu/ops/pallas/hstu_block_train.py:629", f"K4 bwd [{variant}]", bwd,
                      runs),
            ]
    for geom in ("rated", "combined"):
        d, n = K1_GEOMS[geom][0], K1_GEOMS[geom][4]
        meta, _ = k4_meta(None, n)
        for dtype, dt in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
            k1_src = {K1_TF32_ROUTE: "hstu_serve_tf32.cu", "bf16 tensor cores": "hstu_block_tc.cuh",
                      "CUDA cores": "hstu_block.cu"}[k1_route(dtype, d, n, H, DQK, DV, "silu")]
            fwd_src = ("hstu_block_tc.cuh" if tc_fwd_route(dtype, d, meta) else
                       "hstu_train_tf32.cuh" if tf32_fwd_route(dtype, d, n, meta) else
                       "hstu_block_train.cu")
            bwd_src = ("hstu_train_tc.cuh" if tc_bwd_route(dtype, meta) else
                       "hstu_train_tf32.cuh" if tf32_bwd_route(dtype, n, meta) else
                       "hstu_block_train.cu")
            what = f"{geom} preprocessor, D={d}, n={n}, {'bf16' if dt == 'bfloat16' else 'f32'}"
            fwd, bwd = k4p[(geom, dtype)]
            summary += [
                entry(f"fused_hstu_block ({what})", k1_src, k1_site, "K1", k1p[(geom, dtype)],
                      var_runs[(geom, dt, "serve")]),
                entry(f"fused_train_block_forward ({what})", fwd_src, k4_fwd_site, "K4 fwd", fwd,
                      var_runs[(geom, dt, "train")]),
                entry(f"attn_backward ({what})", bwd_src, k4_bwd_site, "K4 bwd", bwd,
                      var_runs[(geom, dt, "train")]),
            ]
    summary.append(entry(f"scatter_add_rows (categorical table ({NUM_CATEGORIES + 1}, {D}))",
                         "scatter_add.cu", "rails_tpu/ops/pallas/scatter_add.py:172", "K6", k6c,
                         var_runs[("categorical", "float32", "train")]))
    missing = [e["name"] for e in summary if not e["launches"]]
    if missing:
        raise AssertionError(f"kernels never launched on their path: {missing}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
