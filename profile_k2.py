"""K2 (the exact MoL corpus scorer), K10 and the probe P2 at the shapes of
their paths, on one CUDA card.

Run from the root of a checkout: `python3 profile_k2.py [--only
k2,bmax,k10,p2,frontier]`. It builds the kernels, then runs `chip_smoke.py`'s
checks of these kernels at more shapes than the smoke does. Each line gives
the route, the kernel's time from CUDA events, one call's device time under
torch.profiler, the plain version's time and the check against it, and the
bound (FLOPs, bytes and the MUFU results the function needs at the SM clock
read under load):
  - k2: `[K2]` at ML-20M (B=512 over 26,744 items, MoL 8x4x128; f32, bf16,
    int8 tables), ML-1M (8x4x64 over 3,706 items, bf16) and Amazon Books
    (B=64 over 695,762 items, 8x8x32; f32, bf16, int8);
  - bmax: `[K2-bmax]` at B=32 over 1,048,575 items (8x4x128) and at the
    Books shape;
  - k10: `[K8]`, `[K9]` and `[K10]` on f32, bf16 and int8 tables at B=32
    over 1,048,576 items (8x4x128) and at the Books shape;
  - p2: `[P2]` per mode at B=32 over 2,000,000 items;
  - frontier: `[K2]` bf16 at B=32 over the frontier's 8,000,000 items (no
    plain run: its scores do not fit).
The checks take the same calls on a tree without the tensor-core route, so
the script also times a `git archive` of an earlier commit: copy it and
`chip_smoke.py` into that tree and run it there.
"""

from __future__ import annotations

import argparse
import subprocess

import chip_smoke as cs

ML1M_GEOM, ML1M_ITEMS = (8, 4, 64), 3_706
GROUPS = ("k2", "bmax", "k10", "p2", "frontier")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default=",".join(GROUPS),
                        help=f"comma-separated groups of lines: {', '.join(GROUPS)}")
    only = set(parser.parse_args().only.split(","))

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
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    _build.load_library()

    if "k2" in only:
        for kind in ("bfloat16", "float32", "int8"):
            cs.check_k2(cs.BATCH, cs.NUM_ITEMS, kind, device)
        cs.check_k2(cs.BATCH, ML1M_ITEMS, "bfloat16", device, ML1M_GEOM)
        for kind in ("bfloat16", "float32", "int8"):
            cs.check_k2(cs.BOOKS_BATCH, cs.BOOKS_ITEMS, kind, device, cs.BOOKS_GEOM)
        torch.cuda.empty_cache()
    if "bmax" in only:
        cs.check_k2_blockmax(device)
        cs.check_k2_blockmax(device, cs.BOOKS_BATCH, cs.BOOKS_ITEMS, cs.BOOKS_GEOM,
                             cs.BOOKS_INVALID)
        torch.cuda.empty_cache()
    if "k10" in only:
        cs.check_bounds(device)
        cs.check_bounds(device, cs.BOOKS_BATCH, cs.BOOKS_ITEMS, cs.BOOKS_GEOM)
        torch.cuda.empty_cache()
    if "p2" in only:
        cs.check_p2(device, cs.p2_operands(device))
        torch.cuda.empty_cache()
    if "frontier" in only:
        cs.check_k2(cs.APPROX_BATCH, cs.FRONTIER_ITEMS, "bfloat16", device, plain=False)
    print(f"[done] {smi}", flush=True)


if __name__ == "__main__":
    main()
