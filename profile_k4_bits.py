"""Digests of K4's outputs on the instances that keep their CUDA-core
kernels, to hold two trees bit for bit in one call on one CUDA card.

Run from the root of a checkout: `python3 profile_k4_bits.py`. At
ml-20m-hstu-mol's train block (B=128, n=211, o_input dropout 0.2;
`chip_smoke.check_k4`'s inputs) it runs `fused_train_block_forward` and
`attn_backward` on the f32 default, f32 softmax, bf16 softmax (the attention
backward: its forward runs on the tensor cores) and bf16
linear_activation="none" instances, and prints one line with the first 16
hex digits of the SHA-256 of each output's bytes, computed twice (the two
calls must agree). Run it in two trees (the older one unpacked by `git
archive`, this script copied in) and compare the lines.
"""

from __future__ import annotations

import hashlib
import subprocess

import chip_smoke

INSTANCES = (("default", "float32", "both"), ("softmax", "float32", "both"),
             ("softmax", "bfloat16", "backward"), ("activation none", "bfloat16", "both"))


def digest(tensors) -> str:
    """The tensors' bits (bf16 widened to f32, which keeps them) hashed."""
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().float().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> None:
    import torch

    from rails_tpu_torch.core.device import require_cuda
    from rails_tpu_torch.ops import _build
    from rails_tpu_torch.ops import hstu_block_train as hbt
    from rails_tpu_torch.ops.hash_dropout import hash_keep_mask
    from rails_tpu_torch.ops.hstu_block import ln

    require_cuda()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    _build.load_library()
    b, n = chip_smoke.TRAIN_BATCH, chip_smoke.MAX_SEQ_LEN
    out = {}
    for instance, dtype_name, which in INSTANCES:
        dtype = getattr(torch, dtype_name)
        meta, has_bias = chip_smoke.k4_meta(None if instance == "default" else instance)
        (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw), _ = chip_smoke.k1_inputs(
            b, n, dtype, device, seed=3)
        x = x * colmask[..., None].to(dtype)
        seed = 987_654_321
        fargs = (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, seed, meta)
        n0 = ln(x.float(), meta.eps)
        z = n0.to(dtype).float() @ uvqk.float()
        y = (z * torch.sigmoid(z) if meta.activation == "silu" else z).to(dtype)
        w = torch.cos(torch.arange(x.numel(), device=device, dtype=torch.float32)
                      * 0.01).reshape(x.shape)
        d_o = ((w.to(dtype).float() @ o_kernel.float().T)
               * hash_keep_mask(b, n, meta.o_width, seed, meta.rate, device)).to(dtype)
        for rep in range(2):
            fwd = hbt.fused_train_block_forward(*fargs)
            attn = None if dtype == torch.bfloat16 else fwd[1]
            bwd = hbt.attn_backward(y, d_o, attn, colmask, rel_pos, ext, tsw, meta, seed)
            parts = {"forward": fwd, "backward": bwd}
            keys = ("forward", "backward") if which == "both" else (which,)
            for key in keys:
                name = f"{instance} {dtype_name} {key}"
                value = digest(parts[key])
                if out.setdefault(name, value) != value:
                    raise AssertionError(f"{name}: two calls differ")
    print(f"[K4-bits] {out} on {smi}")


if __name__ == "__main__":
    main()
