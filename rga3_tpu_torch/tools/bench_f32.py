"""Check and time the f32 GEMM and attention of `csrc/f32_ops.cu` at the f32
calls of one release train step (the SAM2 Hiera-L encoder and decoder under
f32 parameters, 8 frames at 1024^2, as `chip_smoke.py` phase 7 records them
from phase 6b), each against its f32 plain version with TF32 off, with the
time of the plain version and of the PyTorch library call (cuBLAS f32,
SDPA's math path) and its bound at the 3xTF32 peak and at the CUDA cores'.
The checks are `chip_smoke.py`'s own (`check_gemm_f32`, `check_window_f32`,
`check_flash_f32`); q, k and v are strided views of one packed qkv, as the
encoder's blocks pass them.

    PYTHONPATH=. python3 rga3_tpu_torch/tools/bench_f32.py [--reps N] [--sass FILE]

Needs an NVIDIA GPU and nvcc (sm_90a). Prints ptxas's lines for the f32
kernels, a line per call, each kernel's totals over one train step's
launches, and a JSON object as the last line. `--sass FILE` also writes the
SASS of the f32 kernels (cuobjdump) and prints each one's instruction mix.
"""
import argparse
import collections
import json
import re
import subprocess
import sys

# (M, N, K, epilogue, launches in one train step)
GEMM_CALLS = (
    (524288, 432, 144, "bias", 16), (524288, 144, 144, "res_bf16", 16),
    (524288, 576, 144, "gelu_tanh", 16), (524288, 144, 576, "res_bf16", 16),
    (524288, 288, 144, "bias", 8), (524288, 864, 144, "bias", 8),
    (131072, 288, 288, "res_bf16", 48), (131072, 1152, 288, "gelu_tanh", 48),
    (131072, 288, 1152, "res_bf16", 48), (131072, 864, 288, "bias", 40),
    (131072, 576, 288, "bias", 8), (131072, 1728, 288, "bias", 8),
    (32768, 576, 576, "res_bf16", 288), (32768, 2304, 576, "gelu_tanh", 288),
    (32768, 576, 2304, "res_bf16", 288), (32768, 1728, 576, "bias", 280),
    (32768, 1152, 576, "bias", 8), (32768, 3456, 576, "bias", 8),
    (8192, 1152, 1152, "res_bf16", 32), (8192, 4608, 1152, "gelu_tanh", 32),
    (8192, 1152, 4608, "res_bf16", 8), (8192, 3456, 1152, "bias", 24),
    (8192, 1152, 4608, "res_f32", 24),
)
# (B, Lq, Lk, H, window, q_window, launches) at D = 72
WINDOW_CALLS = (
    (8, 65536, 65536, 2, 64, 64, 16), (8, 16384, 65536, 4, 64, 16, 8),
    (8, 16384, 16384, 4, 16, 16, 40), (8, 4096, 16384, 8, 16, 4, 8),
    (8, 4096, 4096, 8, 256, 256, 256), (8, 1024, 4096, 16, 256, 64, 8),
    (8, 1024, 1024, 16, 64, 64, 24),
)
# (B, Lq, Lk, H, D, launches): Hiera's global blocks and the decoder's
# image -> token attention
FLASH_CALLS = ((8, 4096, 4096, 8, 72, 24), (8, 4096, 9, 8, 16, 16))
F32_KERNELS = ("gemm_3xtf32_kernel", "attention_3xtf32_kernel")


def contiguous_strides(shape):
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def packed(b, l, h, d):
    """q, k or v of a packed (B, L, 3, H, D) qkv: its (B, L, H, D) strides."""
    return (l * 3 * h * d, 3 * h * d, d, 1)


def ptxas_lines(log: str):
    entry, out = "", []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif ("registers" in line or "spill" in line.lower()) and any(
                k in entry for k in F32_KERNELS):
            out.append(f"{entry}: {line.strip()}")
    return out


def sass_mix(lib_path: str, out_path: str):
    """Each f32 kernel's SASS instruction counts (by opcode)."""
    sass = subprocess.run(["cuobjdump", "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    mixes, name, keep = {}, None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in F32_KERNELS) else None
            if name:
                mixes[name] = collections.Counter()
        if name:
            keep.append(line)
            op = re.match(r"\s*/\*[0-9a-f]{4,6}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if op:
                mixes[name][op.group(1).split(".")[0]] += 1
    with open(out_path, "w") as f:
        f.write("\n".join(keep))
    return mixes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_f32: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from rga3_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    lib = _kernels.library()
    for line in ptxas_lines(_kernels.build_log):
        print(f"ptxas: {line}", flush=True)
    if args.sass:
        for name, mix in sass_mix(lib._name, args.sass).items():
            print(f"sass {name}: {sum(mix.values())} instructions; "
                  + ", ".join(f"{op} {n}" for op, n in mix.most_common(16)), flush=True)

    gen = torch.Generator("cuda").manual_seed(0)
    totals = {}

    def run(kernel, r, n):
        t = totals.setdefault(kernel, dict(launches=0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                                           bound_ms=0.0, cuda_core_bound_ms=0.0, rel=0.0))
        t["launches"] += n
        t["ms"] += n * r["ms"]
        t["plain_ms"] += n * r["plain_ms"]
        t["library_ms"] += n * r["lib_ms"]
        t["bound_ms"] += n * r["bound"][0]
        t["cuda_core_bound_ms"] += n * r["cuda_core_bound"][0]
        t["rel"] = max(t["rel"], r["rel"])
        print(f"{kernel} [{r['desc']}] x{n}: row err {r['rel']:.3e}, ms {r['ms']:.4f}, "
              f"plain {r['plain_ms']:.4f}, library {r['lib_ms']:.4f}, bound {r['bound'][0]:.4f} "
              f"({r['bound'][1]}, share {r['bound'][0] / r['ms']:.3f}), CUDA-core bound "
              f"{r['cuda_core_bound'][0]:.4f} (share {r['cuda_core_bound'][0] / r['ms']:.3f}), "
              f"TFLOP/s {r['flops'] / r['ms'] / 1e9:.1f} (library "
              f"{r['flops'] / r['lib_ms'] / 1e9:.1f})", flush=True)

    for m, n, k, epi, launches in GEMM_CALLS:
        run("gemm_f32", cs.check_gemm_f32((m, n, k, epi), None, gen, args.reps), launches)
        torch.cuda.empty_cache()
    for b, lq, lk, h, w, qw, launches in WINDOW_CALLS:
        d = 72
        qstride = packed(b, lk, h, d) if qw == w else contiguous_strides((b, lq, h, d))
        key = ((b, lq, h, d), qstride, packed(b, lk, h, d), packed(b, lk, h, d), w, d ** -0.5,
               (b, lk, h, d), qw)
        run("window_attention_f32", cs.check_window_f32(key, None, gen, args.reps), launches)
        torch.cuda.empty_cache()
    for b, lq, lk, h, d, launches in FLASH_CALLS:
        if lq == lk:
            qs = ks = packed(b, lk, h, d)
        else:
            qs, ks = contiguous_strides((b, lq, h, d)), contiguous_strides((b, lk, h, d))
        key = ((b, lq, h, d), qs, (b, lk, h, d), ks, ks, False, d ** -0.5)
        run("flash_attention_f32", cs.check_flash_f32(key, None, gen, args.reps), launches)
        torch.cuda.empty_cache()
    for kernel, t in totals.items():
        print(f"{kernel} over one train step: {t['launches']} launches, ms {t['ms']:.2f}, "
              f"plain {t['plain_ms']:.2f}, library {t['library_ms']:.2f}, 3xTF32 bound "
              f"{t['bound_ms']:.2f} (share {t['bound_ms'] / t['ms']:.3f}), CUDA-core bound "
              f"{t['cuda_core_bound_ms']:.2f}, worst row err {t['rel']:.3e}", flush=True)
    print(json.dumps({"card": card, "kernels": totals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
