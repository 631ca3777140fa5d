"""How far K1's stages move the served ranking, on one CUDA card.

Run from the root of a checkout: `python3 profile_k1_agreement.py
[--dtype bf16|f32] [INSTANCE ...]` (keys of `chip_smoke.K1_VAR_INSTANCES`,
default "activation none"; "default" for ml-20m-hstu-mol as configured). For
each instance it serves one batch of 512 (bf16 by default) through K1 + K2
(`chip_smoke.serving_setup`) with each HSTU block composed of K1's three
stages, each either its tensor-core kernel (bf16: `project`,
`attention_oinput`, `out_gemm`; f32: the 3xTF32 route's `tf32_project`,
`tf32_attention`, `tf32_out_gemm`, SiLU instances only), its plain version,
or the plain version with its GEMM in f64, and prints the share of rows
whose rank and of top-120 ids that agree with the plain path (the `[e2e]`
measures of `chip_smoke.py`), and the same for `fused_hstu_block` as routed
(`tc_block`, `tf32_block`).
"""

from __future__ import annotations

import argparse

import chip_smoke

KERNEL, PLAIN, F64 = "kernel", "plain", "f64"
# (projection, attention, output GEMM) compositions of a block.
MIXES = ((PLAIN, PLAIN, PLAIN), (KERNEL, PLAIN, PLAIN), (PLAIN, KERNEL, PLAIN),
         (PLAIN, PLAIN, KERNEL), (KERNEL, KERNEL, KERNEL), (F64, PLAIN, PLAIN),
         (PLAIN, PLAIN, F64), (F64, PLAIN, F64))


def composed_block(mix):
    """`fused_hstu_block`'s signature over the stages named by `mix`."""
    import torch

    from rails_tpu_torch.ops import hstu_block as hb

    def block(x, colmask, uvqk, o_kernel, o_bias, rel_pos=None, ext=None, tsw=None, *,
              num_heads, dqk, dv, inv_n, eps=1e-6, num_buckets=128, bias=None,
              mask_in_bias=False, activation="silu", normalization="rel_bias"):
        softmax = normalization == "softmax_rel_bias"
        lay = dict(num_heads=num_heads, dqk=dqk, dv=dv)
        pkw = dict(lay, inv_n=inv_n, eps=eps, activation=activation, softmax=softmax)
        if mix[0] == KERNEL:
            u, vqk = hb.project(x, uvqk, **pkw)
            v, q, k = hb.split_vqk(vqk, **lay)
        elif mix[0] == PLAIN:
            u, v, q, k = hb.project_reference(x, uvqk, **pkw)
        else:   # project_reference with its GEMM in f64
            y = (hb.ln(x.float(), eps).to(uvqk.dtype).double() @ uvqk.double()).float()
            if activation == "silu":
                y = y * torch.sigmoid(y)
            hv, hq = num_heads * dv, num_heads * dqk
            u, v = y[..., :hv], y[..., hv : 2 * hv]
            v = (v if softmax else v * inv_n).to(uvqk.dtype)
            q = y[..., 2 * hv : 2 * hv + hq].to(uvqk.dtype)
            k = y[..., 2 * hv + hq :].to(uvqk.dtype)
        akw = dict(lay, eps=eps, num_buckets=num_buckets, bias=bias, mask_in_bias=mask_in_bias,
                   softmax=softmax, concat_ua=o_kernel.shape[0] == 3 * num_heads * dv)
        if mix[1] == KERNEL:
            vqk = hb.pack_vqk(v, q, k, **lay).contiguous()
            o_input = hb.attention_oinput(u.contiguous(), vqk, colmask, rel_pos, ext, tsw, **akw)
        else:
            o_input = hb.attention_oinput_reference(u, v, q, k, colmask, rel_pos, ext, tsw, **akw)
        if mix[2] == KERNEL:
            return hb.out_gemm(o_input.contiguous(), o_kernel, o_bias, x)
        if mix[2] == PLAIN:
            return hb.out_gemm_reference(o_input, o_kernel, o_bias, x)
        return (o_input.double() @ o_kernel.double() + o_bias.double()
                + x.double()).to(x.dtype)

    return block


def composed_block_f32(mix):
    """`composed_block` for f32 operands over the 3xTF32 route's stages."""
    import torch

    from rails_tpu_torch.ops import hstu_block as hb

    def block(x, colmask, uvqk, o_kernel, o_bias, rel_pos=None, ext=None, tsw=None, *,
              num_heads, dqk, dv, inv_n, eps=1e-6, num_buckets=128, bias=None,
              mask_in_bias=False, activation="silu", normalization="rel_bias"):
        lay = dict(num_heads=num_heads, dqk=dqk, dv=dv)
        if mix[0] == KERNEL:
            y = hb.tf32_project(x, uvqk, **lay, eps=eps)
        elif mix[0] == PLAIN:
            y = hb.tf32_project_reference(x, uvqk, eps=eps)
        else:   # tf32_project_reference with its GEMM in f64
            y = (hb.ln(x, eps).double() @ uvqk.double()).float()
            y = y * torch.sigmoid(y)
        akw = dict(lay, inv_n=inv_n, num_buckets=num_buckets, bias=bias,
                   mask_in_bias=mask_in_bias, softmax=normalization == "softmax_rel_bias")
        attention = hb.tf32_attention if mix[1] == KERNEL else hb.tf32_attention_reference
        attn = attention(y, colmask, rel_pos, ext, tsw, **akw)
        if mix[2] == KERNEL:
            return hb.tf32_out_gemm(x, y, attn, o_kernel, o_bias, **lay, eps=eps)
        if mix[2] == PLAIN:
            return hb.tf32_out_gemm_reference(x, y, attn, o_kernel, o_bias, num_heads=num_heads,
                                              dv=dv, eps=eps)
        u, a_ln = y[..., :num_heads * dv], hb.ln(attn, eps)
        o_in = (torch.cat([u, a_ln, u * a_ln], dim=-1)
                if o_kernel.shape[0] == 3 * num_heads * dv else u * a_ln)
        return (o_in.double() @ o_kernel.double() + o_bias.double() + x.double()).float()

    return block


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("instances", nargs="*", default=["activation none"])
    parser.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    args = parser.parse_args()

    import subprocess

    import torch

    from rails_tpu_torch.core.device import require_cuda
    from rails_tpu_torch.models import hstu
    from rails_tpu_torch.ops import _build

    require_cuda()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    _build.load_library()
    for inst in args.instances:
        overrides = () if inst == "default" else chip_smoke.variant_config(inst)[0]
        dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16
        model, es, step, batches = chip_smoke.serving_setup(dtype, device, 1,
                                                            overrides=overrides)

        def serve(f, t, es=es, step=step):
            return step(es.topk_state, f, t)

        with chip_smoke.plain_kernels():
            outs_p, _ = chip_smoke.run_batches(serve, batches)
        rp, ip = (torch.cat([o[i] for o in outs_p]) for i in (0, 1))
        for mix in MIXES + ("fused_hstu_block",):
            routed = hstu.fused_hstu_block
            if mix != "fused_hstu_block":
                compose = composed_block_f32 if args.dtype == "f32" else composed_block
                hstu.fused_hstu_block = compose(mix)
            try:
                outs, _ = chip_smoke.run_batches(serve, batches)
            finally:
                hstu.fused_hstu_block = routed
            rk, ik = (torch.cat([o[i] for o in outs]) for i in (0, 1))
            label = mix if isinstance(mix, str) else "(proj, attention, out) = " + ", ".join(mix)
            agree = (rk == rp).float().mean().item()
            print(f"[agreement] {inst} {args.dtype}, {label}: ranks agree on {agree:.4f} of {rk.numel()} "
                  f"rows, top-120 overlap {chip_smoke.id_overlap(ik, ip):.4f} with the plain "
                  f"path ({smi})")
        del model, es, step, batches
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
