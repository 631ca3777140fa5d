"""K8 and K9 (the MoL score bounds), and K2 and K10 on int8 tables, at the
shapes of their paths on one CUDA card, and hashes of the outputs that must
not move.

Run from the root of a checkout: `python3 profile_bounds.py [--skip-hash]
[--skip-time]`. It builds the kernels, then
  - `[bounds-hash]`: a sha256 prefix of the output bytes of bf16 K2 (ML-20M
    B=512 over 26,744 items, ML-1M's 8x4x64 over 3,706, Amazon Books' 8x8x32
    B=64 over 695,762; emit_blockmax at B=32 over 1,048,575), bf16 K10
    (1,024 tile ids of 1,048,576 and of Books' 695,808 items), P2 in each
    mode (B=32 over 2,000,000 items), and of the CUDA-core instances: f32
    K2, K8, K9 at ML-20M and Books widths and K8, K9 at synthetic-small's
    4x2x16 (f32, bf16, int8), all on operands drawn from fixed seeds;
  - `[bounds-time]`: kernel ms (CUDA events, mean of 10 calls) of K8 and
    K9 on bf16 and int8 tables at B=32 over 1,048,576 items (8x4x128) and
    B=64 over 695,808 (8x8x32), K2 on int8 tables at B=512 over 26,744 and
    B=64 over 695,762, and K10 on int8 tables over 1,024 tile ids at both,
    with the f32 K8 and K9 beside them.
The script takes only calls an earlier tree also has, so the same file,
copied into a `git archive` of the parent commit, prints that tree's hashes
and times: run both in one call and compare the lines.
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess

import chip_smoke as cs

ML1M_GEOM, ML1M_ITEMS = (8, 4, 64), 3_706
SMALL_GEOM = (4, 2, 16)


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def tile_ids(nb: int, device):
    """`check_bounds`'s K10 tile list: seeded, the last tile and a duplicate."""
    import torch

    gen = torch.Generator(device=device).manual_seed(10)
    tiles = torch.randint(0, nb, (cs.K10_TILES,), generator=gen, device=device,
                          dtype=torch.int32)
    tiles[0], tiles[2] = nb - 1, tiles[1]
    return tiles


def hashes(device, smi: str) -> None:
    import torch

    from rails_tpu_torch.ops import mol_probe as mp
    from rails_tpu_torch.ops import mol_scoring as ms

    def line(what, *tensors):
        print(f"[bounds-hash] {what}: {digest(*tensors)}", flush=True)

    for what, b, x, geom in (("ML-20M", cs.BATCH, cs.NUM_ITEMS, cs.ML20M_GEOM),
                             ("ML-1M", cs.BATCH, ML1M_ITEMS, ML1M_GEOM),
                             ("Books", cs.BOOKS_BATCH, cs.BOOKS_ITEMS, cs.BOOKS_GEOM)):
        for dtype in (torch.bfloat16, torch.float32):
            args = cs.bound_inputs(b, x, dtype, device, seed=1, geom=geom)
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            line(f"K2 {name} {what} B={b} X={x}", ms.fused_mol_scores_t(*args))
            if dtype == torch.float32 and what != "ML-1M":
                q, items, t = args[0], args[2], args[5]
                line(f"K8 f32 {what} B={b} X={x}", ms.fused_mol_ub_t(q, items, t))
                line(f"K9 f32 {what} B={b} X={x}", ms.fused_mol_group_block_max(q, items, t))
            del args
    for what, b, x, geom in (("ML-20M", cs.APPROX_BATCH, cs.APPROX_ITEMS, cs.ML20M_GEOM),
                             ("Books", cs.BOOKS_BATCH, cs.BOOKS_ITEMS, cs.BOOKS_GEOM)):
        args = cs.bound_inputs(b, x, torch.bfloat16, device, geom=geom)
        q, qp = args[0], args[1]
        tiles = tile_ids(args[2].shape[2] // ms.BLOCK_X, device)
        line(f"K10 bf16 {what} B={b} T={cs.K10_TILES} of X={x}",
             ms.fused_mol_scores_tiles(q, qp, tiles, *args[2:]))
        if what == "ML-20M":
            valid = torch.ones(x - 1, device=device)
            valid[list(cs.BMAX_INVALID)] = 0.0
            args = cs.bound_inputs(b, x - 1, torch.bfloat16, device, geom=geom)
            line(f"K2-bmax bf16 {what} B={b} X={x - 1}",
                 *ms.fused_mol_scores_t(*args, emit_blockmax=True, valid=valid))
        del args
        torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        args = cs.bound_inputs(37, 700, torch.float32 if dtype == torch.float32 else
                               torch.bfloat16, device, seed=3, geom=SMALL_GEOM)
        if dtype == torch.int8:
            args = cs.quantized(args)
        q, items, t = args[0], args[2], args[5]
        scale = args[6] if dtype == torch.int8 else None
        name = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}[dtype]
        line(f"K8 {name} 4x2x16 B=37 X=700", ms.fused_mol_ub_t(q, items, t, scale))
        line(f"K9 {name} 4x2x16 B=37 X=700", ms.fused_mol_group_block_max(q, items, t, scale))
    ops = cs.p2_operands(device)
    for mode in mp.MODES:
        line(f"P2 {mode} B={ops[0].shape[0]} X={ops[2].shape[2]}", mp.mol_probe_scores(mode, *ops))
    del ops
    torch.cuda.empty_cache()
    print(f"[bounds-hash] done on {smi}", flush=True)


def times(device, smi: str) -> None:
    import torch

    from rails_tpu_torch.ops import mol_scoring as ms

    def line(what, fn):
        print(f"[bounds-time] {what}: {cs.cuda_ms(fn):.4f} ms on {smi}", flush=True)

    for b, x, geom in ((cs.APPROX_BATCH, cs.APPROX_ITEMS, cs.ML20M_GEOM),
                       (cs.BOOKS_BATCH, cs.BOOKS_ITEMS, cs.BOOKS_GEOM)):
        shape = f"{'x'.join(map(str, geom))} B={b}"
        for kind in ("float32", "bfloat16", "int8"):
            args = cs.bound_inputs(b, x, torch.float32 if kind == "float32" else
                                   torch.bfloat16, device, geom=geom)
            if kind == "int8":
                args = cs.quantized(args)
            q, qp, items, t = args[0], args[1], args[2], args[5]
            scale = args[6] if kind == "int8" else None
            xp = items.shape[2]
            line(f"K8 {kind} {shape} X={xp}", lambda: ms.fused_mol_ub_t(q, items, t, scale))
            line(f"K9 {kind} {shape} X={xp}",
                 lambda: ms.fused_mol_group_block_max(q, items, t, scale))
            if kind == "int8":
                tiles = tile_ids(xp // ms.BLOCK_X, device)
                line(f"K10 int8 {shape} T={cs.K10_TILES} of X={xp}",
                     lambda: ms.fused_mol_scores_tiles(q, qp, tiles, *args[2:]))
            del args, q, qp, items
            torch.cuda.empty_cache()
    for b, x, geom in ((cs.BATCH, cs.NUM_ITEMS, cs.ML20M_GEOM),
                       (cs.BOOKS_BATCH, cs.BOOKS_ITEMS, cs.BOOKS_GEOM)):
        args = cs.quantized(cs.bound_inputs(b, x, torch.bfloat16, device, seed=1, geom=geom))
        line(f"K2 int8 {'x'.join(map(str, geom))} B={b} X={x}",
             lambda: ms.fused_mol_scores_t(*args))
        del args
        torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--skip-hash", action="store_true")
    parser.add_argument("--skip-time", action="store_true")
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
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    _build.load_library()
    if not args.skip_hash:
        hashes(device, smi)
    if not args.skip_time:
        times(device, smi)
    print(f"[done] {smi}", flush=True)


if __name__ == "__main__":
    main()
