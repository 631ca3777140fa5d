"""K1's f32 serving route (3xTF32, csrc/hstu_serve_tf32.cuh) on one CUDA
card: each stage's time and error, variants of its sources side by side, and
the hashes of the outputs the route must leave alone.

Run from the root of a checkout: `python3 profile_k1_tf32.py [--variant NAME
...] [--hash]`. It builds the kernels, then at ml-20m-hstu-mol's serving block
(B = 512, n = 211, D = 256, h = 8, dqk = dv = 32; `chip_smoke.k1_inputs`)
prints
  - `[K1-tf32-time]` for this tree's library and for each variant: the
    projection, the pointwise and the softmax attention (over the plain y)
    and the output GEMM (over the plain y and attn), ms per call between
    CUDA events (mean of 10), and each stage's max |err| / max |plain|
    against K1_TF32_STAGE_TOL; the tree's line first and last, the variants
    between. A variant (`VARIANTS`) rewrites the sources in a copy under
    build/k1_variant/NAME/ and compiles hstu_serve_tf32.cu alone there with
    the library's nvcc flags (all variants at once): `1xtf32` drops the lo
    terms of every product (hi.hi alone), the fault the stage limit must
    catch; `accurate-silu` takes the pointwise attention's SiLU by expf and
    an IEEE reciprocal, `accurate-silu-proj` the projection's; `soft8` runs
    the softmax block as 8 warps (2 key or value-column warps a row tile,
    not 4); `proj8w` runs the projection's 128-row blocks as 8 warps of 64 x
    32 outputs, not 16 of 32 x 32; `proj3` and `proj5` give its uvqk ring 3
    and 5 stages, not 4;
  - `[K1-hash]` with --hash: `chip_smoke.untouched_hashes`, which takes only
    calls an older tree also has: copy this file and chip_smoke.py into a
    `git archive` of the parent and run both trees in one call.
Every line ends with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
CSRC = Path("rails_tpu_torch") / "csrc"
# name -> [(file under csrc, text, replacement)], each text found exactly once.
VARIANTS = {
    "1xtf32": [("tf32_mma.cuh", "tc::mma_tf32(c[j], a.lo, b[j].hi);", "{}"),
               ("tf32_mma.cuh", "tc::mma_tf32(c[j], a.hi, b[j].lo);", "{}")],
    "accurate-silu": [("hstu_serve_tf32.cuh",
                       "{ return __fdividef(s, 1.0f + __expf(-s)); }",
                       "{ return s * __frcp_rn(1.f + expf(-s)); }")],
    "accurate-silu-proj": [("hstu_serve_tf32.cuh",
                            "{ return __fdividef(v, 1.0f + __expf(-v)); }",
                            "{ return v * __frcp_rn(1.f + expf(-v)); }")],
    "soft8": [("hstu_serve_tf32.cuh", "constexpr int kSoftColWarps = 4;",
               "constexpr int kSoftColWarps = 2;")],
    "proj3": [("hstu_serve_tf32.cuh", "kRMI = kRWarpM / 16, kRStages = 4;",
               "kRMI = kRWarpM / 16, kRStages = 3;")],
    "proj5": [("hstu_serve_tf32.cuh", "kRMI = kRWarpM / 16, kRStages = 4;",
               "kRMI = kRWarpM / 16, kRStages = 5;")],
    "proj8w": [("hstu_serve_tf32.cuh", "constexpr int kRWarpsM = 4;",
                "constexpr int kRWarpsM = 2;")],
}


def build_variants(names: list) -> dict:
    """name -> the path of its library: hstu_serve_tf32.cu of a rewritten
    copy of the sources, compiled alone; every variant at once."""
    from rails_tpu_torch.ops import _build

    procs = {}
    for name in names:
        tree = ROOT / "build" / "k1_variant" / name
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(ROOT / CSRC, tree / "csrc")
        for rel, old, new in VARIANTS[name]:
            path = tree / "csrc" / rel
            text = path.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} found {text.count(old)} times")
            path.write_text(text.replace(old, new))
        lib = tree / f"libk1_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(tree / "csrc" / "hstu_serve_tf32.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed:\n{out[-4000:]}")
        print(f"[K1-tf32-variant] {name}: {'; '.join(f'{o!r} -> {n!r}' for _, o, n in VARIANTS[name])}"
              f"; ptxas: {cs.ptxas_summary(out)}", flush=True)
        libs[name] = lib
    return libs


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The f32 route's four entry points of a library, as `_build` declares
    them."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rails_hstu_serve_tf32_project.argtypes = [p] * 3 + [i] * 6 + [f, p]
    lib.rails_hstu_serve_tf32_attention.argtypes = [p] * 7 + [i] * 5 + [f, f] + [i] * 3 + [p]
    lib.rails_hstu_serve_tf32_out.argtypes = [p] * 6 + [i] * 6 + [f, i, p]
    for fn in (lib.rails_hstu_serve_tf32_project, lib.rails_hstu_serve_tf32_attention,
               lib.rails_hstu_serve_tf32_out):
        fn.restype = i
    return lib


def stage_line(label: str, lib, ops: dict, smi: str) -> None:
    """One library's four stages: ms per call and error shares."""
    import torch

    b, n, d, h, dqk, dv = ops["shape"]
    stream = torch.cuda.current_stream().cuda_stream
    x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw = ops["args"]
    y_p, attn_p = ops["y"], ops["attn"]
    outs = {k: torch.empty_like(v) for k, v in ops["plain"].items()}
    ptr = lambda t: t.data_ptr()  # noqa: E731
    calls = {
        "project": lambda: lib.rails_hstu_serve_tf32_project(
            ptr(x), ptr(uvqk), ptr(outs["project"]), b, n, d, h, dqk, dv, 1e-6, stream),
        "attention": lambda: lib.rails_hstu_serve_tf32_attention(
            ptr(y_p), ptr(colmask), ptr(rel_pos), ptr(ext), ptr(tsw), None,
            ptr(outs["attention"]), b, n, h, dqk, dv, ops["inv_n"], 1.0 / dqk ** 0.5, 127, 0, 0,
            stream),
        "softmax": lambda: lib.rails_hstu_serve_tf32_attention(
            ptr(y_p), ptr(colmask), ptr(rel_pos), ptr(ext), ptr(tsw), None,
            ptr(outs["softmax"]), b, n, h, dqk, dv, ops["inv_n"], 1.0 / dqk ** 0.5, 127, 0, 1,
            stream),
        "out_gemm": lambda: lib.rails_hstu_serve_tf32_out(
            ptr(attn_p), ptr(y_p), ptr(o_kernel), ptr(o_bias), ptr(x), ptr(outs["out_gemm"]), b,
            n, d, h, dqk, dv, 1e-6, 0, stream),
    }
    parts = []
    for name, call in calls.items():
        if call() != 0:
            raise RuntimeError(f"{label} {name}: launch refused")
        torch.cuda.synchronize()
        share = cs.rel_err(outs[name], ops["plain"][name])
        ms = cs.cuda_ms(call)
        flag = "" if share <= cs.K1_TF32_STAGE_TOL else " OUTSIDE"
        parts.append(f"{name} {ms:.4f} ms (err {share:.2e}{flag})")
    print(f"[K1-tf32-time] {label} f32 B={b} n={n}: {'; '.join(parts)}; stage limit "
          f"{cs.K1_TF32_STAGE_TOL}; on {smi}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", nargs="*", default=[], choices=sorted(VARIANTS))
    ap.add_argument("--hash", action="store_true", help="the [K1-hash] lines")
    flags = ap.parse_args()

    import torch

    from rails_tpu_torch.core.device import require_cuda
    from rails_tpu_torch.ops import _build
    from rails_tpu_torch.ops import hstu_block as hb

    require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    if flags.hash:
        _build.load_library()
        cs.untouched_hashes(device)
        print(f"[K1-hash] on {smi}")
        if not hasattr(hb, "tf32_block"):   # a tree without the route: its hashes only
            return
    libs = {"this tree": _build.build()}
    libs.update(build_variants(flags.variant))
    b, n = cs.BATCH, cs.MAX_SEQ_LEN
    d, h, dqk, dv, _ = cs.K1_GEOMS["ml-20m"]
    args, kw = cs.k1_inputs(b, n, torch.float32, device)
    x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw = args
    lay = dict(num_heads=h, dqk=dqk, dv=dv, inv_n=kw["inv_n"])
    y = hb.tf32_project_reference(x, uvqk)
    attn = hb.tf32_attention_reference(y, colmask, rel_pos, ext, tsw, **lay)
    ops = {"shape": (b, n, d, h, dqk, dv), "args": args, "y": y, "attn": attn,
           "inv_n": kw["inv_n"], "plain": {
               "project": y, "attention": attn,
               "softmax": hb.tf32_attention_reference(y, colmask, rel_pos, ext, tsw, **lay,
                                                      softmax=True),
               "out_gemm": hb.tf32_out_gemm_reference(x, y, attn, o_kernel, o_bias,
                                                      num_heads=h, dv=dv)}}
    loaded = {k: declare(ctypes.CDLL(str(v))) for k, v in libs.items()}
    order = ["this tree"] + flags.variant + (["this tree"] if flags.variant else [])
    for label in order:
        stage_line(label, loaded[label], ops, smi)


if __name__ == "__main__":
    main()
