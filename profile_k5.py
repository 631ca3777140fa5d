"""K5, the fused shared-negatives MoL loss, alone on one CUDA card.

Run from the root of a checkout: `python3 profile_k5.py [--seeds 1-8]
[--skip-seeds]`. It builds the kernels, then
  - `[K5-seeds]`: each route's error against its plain version over the
    seeds (`chip_smoke.check_k5` untimed: operands, cotangent and masks drawn
    from each seed) at ml-20m-hstu-mol-fast's and ml-1m-hstu-mol-fast's f32
    shapes and amzn-books-hstu-mol-fast's bf16 shapes, as the largest share
    of its tolerance (1 at the limit): the forward's of K2_TOL_F32 or
    K5_BF16_TOL, the gradients' of GRAD_REL_TOL or K5_BF16_TOL;
  - `[K5]`: `chip_smoke.check_k5` at the same three shapes (kernel, plain and
    bound ms of each direction).
`--skip-seeds` runs the `[K5]` lines alone, with the arguments an earlier
tree's `check_k5` also takes: copy this script into a `git archive` of the
earlier commit and run it there with `--skip-seeds`, then here, to compare
two trees in one call on one card. `--time-only` times each direction at the
three shapes and checks nothing (`[K5-time]`): for a copy of the package
whose kernel is patched to drop a part, so that its share of the time shows.
"""

from __future__ import annotations

import argparse
import inspect
import subprocess

import chip_smoke as cs


def seed_list(text: str) -> list:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def time_only(device, what: str, smi: str, m: int = cs.TRAIN_BATCH * (cs.MAX_SEQ_LEN - 1),
              r: int = cs.NUM_NEGATIVES, geom: tuple = cs.ML20M_GEOM,
              dtype_name: str = "float32", rates: tuple = cs.K5_RATES) -> None:
    """`[K5-time]`: kernel ms of each direction on `check_k5`'s operands, unchecked."""
    import torch

    from rails_tpu_torch.ops import mol_loss_train as mlt

    args = cs.k5_inputs(device, m, r, geom, getattr(torch, dtype_name))
    kw = dict(p_q=geom[0], p_x=geom[1], temperature=cs.TEMPERATURE, qi_rate=rates[1],
              pi_rate=rates[0], eps=1e-6)
    cot = torch.randn(m, r, generator=torch.Generator(device=device).manual_seed(6),
                      device=device)
    fwd = cs.cuda_ms(lambda: mlt.fused_mol_loss_forward(*args, 424_242, **kw))
    bwd = cs.cuda_ms(lambda: mlt.fused_mol_loss_backward(*args, 424_242, cot, **kw), iters=5)
    print(f"[K5-time] {what} {dtype_name} M={m} R={r} MoL {'x'.join(map(str, geom))}: forward "
          f"{fwd:.3f} ms, backward {bwd:.3f} ms (unchecked) on {smi}", flush=True)


def main() -> None:
    import torch

    from rails_tpu_torch.core.config import get_experiment_config
    from rails_tpu_torch.core.device import require_cuda
    from rails_tpu_torch.ops import _build

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", default="1-8", help="a seed or a range, e.g. 1-8")
    parser.add_argument("--skip-seeds", action="store_true")
    parser.add_argument("--time-only", action="store_true")
    args = parser.parse_args()
    require_cuda()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    _build.load_library()
    ml1m = get_experiment_config("ml-1m-hstu-mol-fast")
    books = get_experiment_config("amzn-books-hstu-mol-fast")
    m_books = cs.BOOKS_BATCH * (books.max_seq_len_padded - 1)
    cases = {
        "ML-20M": dict(),
        "ML-1M": dict(geom=(8, 4, ml1m.mol.dot_product_dimension),
                      rates=(ml1m.mol.softmax_dropout_rate, ml1m.mol.gating_qi_dropout_rate)),
        "Books": dict(m=m_books, r=books.train.num_negatives, geom=cs.BOOKS_GEOM,
                      dtype_name="bfloat16",
                      rates=(books.mol.softmax_dropout_rate, books.mol.gating_qi_dropout_rate)),
    }
    if args.time_only:
        for what, kw in cases.items():
            time_only(device, what, smi, **kw)
        return
    if not args.skip_seeds:
        for what, kw in cases.items():
            uses = {s: cs.check_k5(device, **kw, what=what, seed=s, timed=False)
                    for s in seed_list(args.seeds)}
            fwd = max(uses, key=lambda s: uses[s][0])
            grad = max(uses, key=lambda s: uses[s][1])
            print(f"[K5-seeds] {what}, seeds {args.seeds}: forward at most {uses[fwd][0]:.3f} of "
                  f"its tolerance (seed {fwd}), gradients at most {uses[grad][1]:.3f} (seed "
                  f"{grad}) on {smi}", flush=True)
            torch.cuda.empty_cache()
    labelled = "what" in inspect.signature(cs.check_k5).parameters   # not on earlier trees
    for what, kw in cases.items():
        cs.check_k5(device, **kw, **({"what": what} if labelled else {}))
        torch.cuda.empty_cache()
    print(f"[done] {smi}", flush=True)


if __name__ == "__main__":
    main()
