"""Time `csrc/gemm.cu` at the Hiera-L products of the main path, and, for a
source that chooses its output-tile width per call (a `pick_bn` over a set
of widths, as gemm.cu did before it settled on one width), each width
forced alone.

The source as it is runs as "pick"; each forced width is built from a copy
whose `pick_bn` set holds that width alone. Every variant runs at every
call, interleaved round by round in one process, so that all share the
card's clock and power state. Times are medians of CUDA-event means.

    PYTHONPATH=. python3 rga3_tpu_torch/tools/bench_gemm_tiles.py [--out FILE]

Needs an NVIDIA GPU and nvcc (sm_90a). Prints a line per call, the totals
over one `segment_video_multi` call, and a JSON object as the last line.
"""
import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

# (M, N, K, epilogue, launches in one segment_video_multi call): the `gemm`
# calls of SAM2 Hiera-L at 1024^2 on 8 frames, as chip_smoke.py records them
CALLS = (
    (524288, 432, 144, "bias", 2), (524288, 144, 144, "res_bf16", 2),
    (524288, 576, 144, "gelu_tanh", 2), (524288, 144, 576, "res_bf16", 2),
    (524288, 288, 144, "bias", 1), (524288, 864, 144, "bias", 1),
    (131072, 288, 288, "res_bf16", 6), (131072, 1152, 288, "gelu_tanh", 6),
    (131072, 288, 1152, "res_bf16", 6), (131072, 864, 288, "bias", 5),
    (131072, 576, 288, "bias", 1), (131072, 1728, 288, "bias", 1),
    (32768, 576, 576, "res_bf16", 36), (32768, 2304, 576, "gelu_tanh", 36),
    (32768, 576, 2304, "res_bf16", 36), (32768, 1728, 576, "bias", 35),
    (32768, 1152, 576, "bias", 1), (32768, 3456, 576, "bias", 1),
    (8192, 1152, 1152, "res_bf16", 4), (8192, 4608, 1152, "gelu_tanh", 4),
    (8192, 1152, 4608, "res_bf16", 1), (8192, 3456, 1152, "bias", 3),
    (8192, 1152, 4608, "res_f32", 3),
)
EPILOGUES = {"bias": 0, "gelu_tanh": 1, "gelu_erf": 2, "res_bf16": 3, "res_f32": 4}
WIDTHS = re.compile(r"for \(int bn : \{([0-9, ]+)\}\)")


def build(src: Path, tmp: Path, nvcc_flags) -> dict:
    """One library per variant: "pick" (the source as it is) and each width
    of a pick_bn set alone, if the source has one. nvcc runs for all of them
    at once."""
    text = src.read_text()
    variants = {"pick": text}
    found = WIDTHS.search(text)
    for w in [] if found is None else [int(w) for w in found.group(1).split(",")]:
        variants[f"bn{w}"] = text[:found.start(1)] + str(w) + text[found.end(1):]
    procs = {}
    for name, body in variants.items():
        cu = tmp / f"gemm_{name}.cu"
        cu.write_text(body)
        procs[name] = subprocess.Popen(
            ["nvcc", *nvcc_flags, "-I", str(src.parent), "-shared", str(cu), "-o",
             str(tmp / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        p_, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rga3_gemm_bf16.argtypes = [p_, i64, p_, i64, p_, p_, i64, p_, i64, i, i, i, i, p_]
        lib.rga3_gemm_bf16.restype = i
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=Path(__file__).resolve().parent.parent / "csrc" / "gemm.cu")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from rga3_tpu_torch.ops import _kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output"
    print(f"card: {card}", flush=True)
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_kernels.BUILD_DIR) as tmp:
        libs = build(args.source, Path(tmp), _kernels.NVCC_FLAGS)
        names = list(libs)
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        stream = torch.cuda.current_stream(dev)
        rows = []
        for m, n, k, epi, launches in CALLS:
            a = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
            w = (torch.randn(n, k, device=dev, generator=gen) * k ** -0.5).to(torch.bfloat16)
            bias = (torch.randn(n, device=dev, generator=gen) * 0.1).to(torch.bfloat16)
            res = (torch.randn(m, n, device=dev, generator=gen).to(torch.bfloat16)
                   if epi.startswith("res") else None)
            outs = {name: torch.empty(m, n, device=dev, dtype=torch.bfloat16) for name in names}

            def run(name):
                err = libs[name].rga3_gemm_bf16(
                    a.data_ptr(), k, w.data_ptr(), k, bias.data_ptr(),
                    None if res is None else res.data_ptr(), n, outs[name].data_ptr(), n,
                    m, n, k, EPILOGUES[epi], stream.cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err} at M={m} N={n} K={k} {epi}")

            for name in names:
                run(name)
            torch.cuda.synchronize()
            same = {name: torch.equal(outs[name], outs["pick"]) for name in names}
            times = {name: [] for name in names}
            for _ in range(args.rounds):
                for name in names:
                    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
                    start.record()
                    for _ in range(args.iters):
                        run(name)
                    end.record()
                    end.synchronize()
                    times[name].append(start.elapsed_time(end) / args.iters)
            ms = {name: statistics.median(t) for name, t in times.items()}
            flops = 2.0 * m * n * k
            print(f"M={m} N={n} K={k} {epi} x{launches}: " + "  ".join(
                f"{name} {ms[name]:.4f} ms ({flops / ms[name] / 1e9:.0f} TFLOP/s"
                f"{'' if same[name] else ', bits differ'})" for name in names), flush=True)
            rows.append(dict(m=m, n=n, k=k, epilogue=epi, launches=launches, ms=ms,
                             same_bits=same))
            del a, w, bias, res, outs
    totals = {name: sum(r["ms"][name] * r["launches"] for r in rows) for name in names}
    print("over one segment_video_multi call: " +
          "  ".join(f"{name} {t:.3f} ms" for name, t in totals.items()), flush=True)
    result = dict(card=card, rows=rows, totals_ms=totals)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(dict(card=card, totals_ms=totals)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
