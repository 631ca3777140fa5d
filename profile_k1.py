"""K1 (the serving HSTU block) and its probe P1 per stage, on one CUDA card.

Run from the root of a checkout: `python3 profile_k1.py [--skip-var]
[--skip-p1] [--dtype bf16|f32|both]`. It builds the kernels, then prints for
K1 at ML-20M widths (B=512, n in {64, 211}, f32 and bf16) the `[K1]` line of `chip_smoke.py`
(error, kernel, plain and bound ms, and one call's device us per stage under
torch.profiler); the `[K1-var]` line of every variant instance in f32 and
bf16 at n=211; and for P1 at B=512, n=192, bf16, each mode's kernel and plain
ms and its stages. Every time is the card's, with its name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np

import chip_smoke


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--skip-var", action="store_true", help="no [K1-var] lines")
    parser.add_argument("--skip-p1", action="store_true", help="no [P1] lines")
    parser.add_argument("--dtype", choices=("bf16", "f32", "both"), default="both",
                        help="the [K1] lines' operand types")
    args = parser.parse_args()

    import torch

    from rails_tpu_torch.core.device import require_cuda
    from rails_tpu_torch.ops import _build

    require_cuda()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}")
    _build.load_library()

    dtypes = {"bf16": (torch.bfloat16,), "f32": (torch.float32,),
              "both": (torch.bfloat16, torch.float32)}[args.dtype]
    for dtype in dtypes:
        for n in (64, chip_smoke.MAX_SEQ_LEN):
            chip_smoke.check_k1(chip_smoke.BATCH, n, dtype, device)
            torch.cuda.empty_cache()

    if not args.skip_var:
        for inst in chip_smoke.K1_VAR_INSTANCES:
            for dtype in (torch.bfloat16, torch.float32):
                chip_smoke.check_k1_variant(chip_smoke.BATCH, chip_smoke.MAX_SEQ_LEN, dtype,
                                            device, inst)
            torch.cuda.empty_cache()

    if not args.skip_p1:
        from rails_tpu_torch.cli import encode_probe as cli
        from rails_tpu_torch.ops import encode_probe as ep

        n = chip_smoke.P1_LENGTH
        d = cli.probe_data(chip_smoke.BATCH, n, 1, np.random.default_rng(2), device)
        pargs = (d["x0"], d["colmask"], d["uvqk"][0], d["ow"][0], d["ob"][0], d["rel_pos"],
                 d["ext"], d["tsw"])
        kw = dict(num_heads=chip_smoke.H, dqk=chip_smoke.DQK, dv=chip_smoke.DV, inv_n=1.0 / n)
        for mode in ep.MODES:
            ms = chip_smoke.cuda_ms(lambda: ep.encode_probe_block(mode, *pargs, **kw))
            plain_ms = chip_smoke.cuda_ms(
                lambda: ep.encode_probe_block_reference(mode, *pargs, **kw), iters=3, warmup=1)
            print(f"[P1] {mode} B={chip_smoke.BATCH} n={n} bf16: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms; stages "
                  f"{chip_smoke.stage_split(lambda: ep.encode_probe_block(mode, *pargs, **kw))}")
    print(f"[done] {smi}")


if __name__ == "__main__":
    main()
