"""Amazon Books' serving and training paths alone, on one CUDA card.

Run from the root of a checkout: `python3 profile_books.py`. It builds the
kernels, then runs `chip_smoke.py`'s `[books-e2e]` (amzn-books-hstu-mol
serving over 695,762 items at B=64 through every `BOOKS_METHODS` spelling,
ms/batch against the plain path), `[books-train]` and `[books-train-fast]`
(20 steps at B=64, N=61, ms/step) phases, with their checks, and nothing else.
The phases take the same calls on an earlier tree, so two trees compare in
one call on one card: copy this script into a `git archive` of the earlier
commit and run it there, then here, then here again, then there again.
"""

from __future__ import annotations

import subprocess

import chip_smoke as cs


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
    print(f"[device] {name}; {smi}", flush=True)
    _build.load_library()
    cs.books_e2e(device, name, smi)
    torch.cuda.empty_cache()
    books_train = {"lengths": "uniform", "batch_size": cs.BOOKS_BATCH,
                   "num_items": cs.BOOKS_ITEMS}
    cs.train_phase(device, name, smi, "amzn-books-hstu-mol", "books-train", **books_train)
    torch.cuda.empty_cache()
    cs.train_phase(device, name, smi, "amzn-books-hstu-mol-fast", "books-train-fast",
                   **books_train)
    print(f"[done] {smi}", flush=True)


if __name__ == "__main__":
    main()
