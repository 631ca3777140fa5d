"""Where P2's kernel-vs-plain error comes from, on one CUDA card.

Run from the root of a checkout: `python3 profile_p2_agreement.py [SEED ...]`
(default 9, the seed of `chip_smoke.py`'s `[P2]` lines, then 10 to 16).
For each seed it draws P2's operands as `chip_smoke.p2_operands` does (B=32
over 2,000,000 items, MoL 8x4x128, H=128, bf16 tables) and scores them, in
each mode that runs the qi MLP (full, nosilu, noexp), by five compositions:
  plain    `mol_probe_scores_reference`: logits and MLP summed in f32
  kernel   `mol_probe_scores` (the tensor-core kernel on the card)
  klogits  the kernel's own f32 logits fed to plain's MLP and combine; the
           kernel gives logit (n, m) as its writeonly output once component
           n and item group m are rolled into slot 0
  f64lg    plain with the logits summed in f64, rounded to f32
  f64      every sum in f64, with plain's bf16 rounding points
It prints, per mode, the largest |a - b| over all scores of six pairs as a
share of `mol_probe_error_bound` (the `[P2]` check's measure, derived from
one bf16 rounding flip of an MLP input; at most 1 passes), in `full` the
kernel's share on each seeded fault of `chip_smoke.P2_FAULTS` (above 1
rejects it), and per seed how far the kernel's and plain's f32 logits lie
from the f64 ones and how many of their bf16 roundings (the MLP's input)
differ from those of the f64 logits.
"""

from __future__ import annotations

import argparse
import subprocess

import chip_smoke as cs

MODES = ("full", "nosilu", "noexp")
CHUNK = 8192          # corpus columns a step, as the plain version's
PAIRS = (("kernel", "plain"), ("klogits", "plain"), ("kernel", "klogits"),
         ("f64lg", "plain"), ("f64", "plain"), ("kernel", "f64"))


def kernel_logits(ops):
    """(B, X, L) f32: the logits the kernel computes, l = n * P_X + m."""
    import torch

    from rails_tpu_torch.ops import mol_probe as mp

    q, qp, item, ip, w = ops
    p_q, p_x = q.shape[1], item.shape[0]
    out = torch.empty(q.shape[0], item.shape[2], p_q * p_x, device=q.device)
    for n in range(p_q):
        qn = q.roll(-n, dims=1).contiguous()
        for m in range(p_x):
            out[:, :, n * p_x + m] = mp.mol_probe_scores(
                "writeonly", qn, qp, item.roll(-m, dims=0).contiguous(), ip, w)
    return out


def logits(q, items, dt):
    """Plain's logits of a chunk (B, C, L), summed in dt, times 1/T."""
    import torch

    from rails_tpu_torch.ops.mol_probe import INV_TEMPERATURE

    b, l = q.shape[0], q.shape[1] * items.shape[0]
    return (torch.einsum("bnd,mdx->bxnm", q.to(dt), items.to(dt)).reshape(b, -1, l)
            * INV_TEMPERATURE)


def mixture(mode, lg, qp, ipc, w, dt):
    """Plain's MLP and combine of a chunk's logits lg (B, C, L), summed in
    dt; the MLP's inputs round to f32, then to bf16, as plain's do."""
    import torch

    bf = torch.bfloat16
    w1, w2 = w.w1.to(bf).to(dt), w.w2.to(bf).to(dt)
    lg = lg.to(dt)
    h = lg.float().to(bf).to(dt) @ w1 + w.b1.to(dt)
    h = h * torch.sigmoid(h)
    qi = h.float().to(bf).to(dt) @ w2 + w.b2.to(dt)
    gi = qp.to(dt)[:, None, :] * ipc.to(dt).T[None] + qi
    gw = gi if mode == "nosilu" else gi * torch.sigmoid(gi)
    e = gw if mode == "noexp" else torch.exp(gw - gw.amax(dim=-1, keepdim=True))
    return (e * lg).sum(dim=-1) / e.sum(dim=-1)


def seed_study(device, seed: int) -> None:
    import torch

    from rails_tpu_torch.ops import mol_probe as mp

    ops = cs.p2_operands(device, seed)
    q, qp, item, ip, w = ops
    x = item.shape[2]
    klg = kernel_logits(ops)
    lg_err = {"kernel": 0.0, "plain": 0.0}
    flips = {"kernel": 0, "plain": 0}
    for c in range(0, x, CHUNK):
        items = item[:, :, c : c + CHUNK]
        exact = logits(q, items, torch.float64).float()
        for what, lg in (("kernel", klg[:, c : c + CHUNK]),
                         ("plain", logits(q.float(), items.float(), torch.float32))):
            lg_err[what] = max(lg_err[what], (lg - exact).abs().max().item())
            flips[what] += int((lg.to(torch.bfloat16) != exact.to(torch.bfloat16)).sum())
    n = q.shape[0] * x * klg.shape[2]
    print(f"[P2-agree] seed {seed}: max |f32 logit - f64 logit| kernel {lg_err['kernel']:.3e}, "
          f"plain {lg_err['plain']:.3e}; bf16 roundings that differ from the f64 logits' "
          f"kernel {flips['kernel']}, plain {flips['plain']} of {n}", flush=True)
    for mode in MODES:
        scores = {"plain": mp.mol_probe_scores_reference(mode, *ops),
                  "kernel": mp.mol_probe_scores(mode, *ops)}
        for name in ("klogits", "f64lg", "f64", "plain32"):
            scores[name] = torch.empty(q.shape[0], x, device=device,
                                       dtype=torch.float64 if name == "f64" else torch.float32)
        for c in range(0, x, CHUNK):
            items, ipc = item[:, :, c : c + CHUNK], ip[:, c : c + CHUNK]
            lg64 = logits(q, items, torch.float64)
            cols = slice(c, c + CHUNK)
            scores["klogits"][:, cols] = mixture(mode, klg[:, cols], qp, ipc, w, torch.float32)
            scores["f64lg"][:, cols] = mixture(mode, lg64.float(), qp, ipc, w, torch.float32)
            scores["f64"][:, cols] = mixture(mode, lg64, qp, ipc, w, torch.float64)
            scores["plain32"][:, cols] = mixture(
                mode, logits(q.float(), items.float(), torch.float32), qp, ipc, w, torch.float32)
        bound = mp.mol_probe_error_bound(mode, *ops).double()
        shares = {f"{a}-{b}": ((scores[a].double() - scores[b].double()).abs() / bound).max().item()
                  for a, b in PAIRS}
        if mode == "full":
            for fault, wrong in cs.p2_faults(ops).items():
                shares[fault] = ((mp.mol_probe_scores(mode, *wrong).double()
                                  - scores["plain"].double()).abs() / bound).max().item()
        same = torch.equal(scores["plain32"], scores["plain"])
        print(f"[P2-agree] seed {seed} {mode}: largest share of the one-flip bound "
              f"{ {k: float(f'{v:.4f}') for k, v in shares.items()} }; this script's f32 "
              f"composition bit-equal to the plain version: {same}", flush=True)
        del scores, bound
        torch.cuda.empty_cache()
    del klg, ops


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("seeds", nargs="*", type=int, default=list(range(9, 17)))
    seeds = parser.parse_args().seeds

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
    for seed in seeds:
        seed_study(device, seed)
    print(f"[done] {smi}", flush=True)


if __name__ == "__main__":
    main()
