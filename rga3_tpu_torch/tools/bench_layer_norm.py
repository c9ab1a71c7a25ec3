"""Check and time `csrc/row_ops.cu`'s bf16 LayerNorm at the main path's
widths: the source as it is, the variants given with `--set` (the source
with some of its constexpr constants changed, such as kLnMinBlocks), and
another tree's `row_ops.cu` (`--parent`), built as it is; beside them
`F.layer_norm` and a `copy_` of the same bytes (what the card's memory
gives a stream that reads and writes them with no arithmetic).

Each variant is a library of its own, built from a copy of the source;
nvcc runs for all of them at once. Every variant runs at every width,
interleaved round by round in one process, so that all share the card's
clock and power state. Times are medians over the rounds of CUDA-event
means, in two settings: "warm", the same input again and again (as
`chip_smoke.py` phase 7 times a kernel: an input that fits in the 50 MB L2
stays there), and "rotated", over enough copies of the input and output to
pass twice the L2 between two reads of one copy. The bound is 4 R D bytes
over 3.35 TB/s. Each variant's output is held to the plain version within
one bf16 ulp (`ulp_err`, below).

    PYTHONPATH=. python3 rga3_tpu_torch/tools/bench_layer_norm.py [--set ...] [--parent FILE]
        [--out FILE]

Needs an NVIDIA GPU and nvcc (sm_90a). Prints a line per width and
variant, the totals over one 8-frame Hiera-L forward, and a JSON object as
the last line.
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
import torch.nn.functional as F

# (rows, D, launches in one 8-frame forward of SAM2 Hiera-L at 1024^2), as
# chip_smoke.py records the main path's `layer_norm` calls
CALLS = ((524288, 144, 5), (131072, 288, 12), (32768, 576, 72), (8192, 1152, 7))
EPS = 1e-6
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ROTATE_BYTES = 100e6  # twice the H100's 50 MB L2


def ulp_err(out, ref) -> float:
    """max |out - ref| in bf16 ulps of ref, each element's ulp taken at
    max(|ref|, 2^-8 of its row's max|ref|): below that the f32 statistics'
    own rounding (the mean's, at |mean| up to ~100x the spread) is larger
    than the ulp of a value near zero."""
    out, ref = out.float(), ref.float()
    floor = ref.abs().amax(-1, keepdim=True).clamp_min(1e-30) * 2.0 ** -8
    _, e = torch.frexp(torch.maximum(ref.abs(), floor))
    return ((out - ref).abs() / torch.ldexp(torch.ones_like(ref), e - 8)).max().item()


def variant_body(text: str, settings: dict) -> str:
    """The source with each `constexpr <type> NAME = ...;` of `settings` set
    to its value."""
    for name, value in settings.items():
        pat = re.compile(rf"(constexpr \w+ {name} = )([^;]+);")
        if not pat.search(text):
            raise SystemExit(f"no constexpr {name} in the source")
        text = pat.sub(lambda m: m.group(1) + value + ";", text, count=1)
    return text


def parse_set(spec: str):
    """NAME=CONST:VALUE[,CONST:VALUE...] -> (NAME, {CONST: VALUE})."""
    name, _, body = spec.partition("=")
    return name, dict(kv.split(":", 1) for kv in body.split(",") if kv)


def build(src: Path, parents, sets, tmp: Path) -> dict:
    """One library per variant: the source, each `--set`, and each
    `--parent` source as it is."""
    from rga3_tpu_torch.ops import _kernels

    text = src.read_text()
    bodies = {"source": text}
    bodies.update((name, variant_body(text, settings)) for name, settings in sets)
    includes = {}
    for spec in parents:
        name, _, path = str(spec).rpartition("=")
        name = name or "parent"
        bodies[name] = Path(path).read_text()
        includes[name] = Path(path).parent
    procs = {}
    for name, body in bodies.items():
        cu = tmp / f"row_ops_{name}.cu"
        cu.write_text(body)
        inc = includes.get(name, src.parent)
        procs[name] = subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(inc), "-shared", str(cu), "-o",
             str(tmp / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{out}")
        entry = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "layer_norm" in entry and ("registers" in line or "spill" in line):
                print(f"ptxas {name}: {entry}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        p_, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        lib.rga3_layer_norm_bf16.argtypes = [i, p_, i64, p_, p_, p_, i64, i, i, f, p_]
        lib.rga3_layer_norm_bf16.restype = i
        libs[name] = lib
    return libs


def launcher(lib, x, g, b, y):
    rows, d = x.shape
    dev = x.device.index

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rga3_layer_norm_bf16(dev, x.data_ptr(), d, g.data_ptr(), b.data_ptr(),
                                       y.data_ptr(), d, rows, d, EPS, stream)
        if err:
            raise RuntimeError(f"rga3_layer_norm_bf16: cudaError {err}")
    return run


def time_ms(fns, reps: int) -> float:
    """Mean ms a call over reps calls, cycling through `fns`."""
    for fn in fns:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=Path(__file__).resolve().parent.parent / "csrc" / "row_ops.cu")
    ap.add_argument("--parent", action="append", default=[],
                    help="another tree's row_ops.cu, timed as it is (repeatable; "
                         "NAME=PATH names it)")
    ap.add_argument("--set", action="append", default=[], metavar="NAME=CONST:VALUE,...",
                    help="a variant: the source with these constexpr constants set "
                         "(e.g. b4=kLnMinBlocks:4)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the kernels run only on the card", file=sys.stderr)
        return 1
    from rga3_tpu_torch.ops import fused_block as fb

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    rows_out = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(args.source, args.parent, [parse_set(v) for v in args.set], Path(tmp))
        for rows, d, launches in CALLS:
            # |mean| about 3x the spread, as LayerNorm inputs of a residual stream
            x = (torch.randn((rows, d), generator=gen, device="cuda") * 2 + 6).bfloat16()
            g = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
            b = (0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
            ref = fb.layer_norm_reference(x, g, b, EPS)
            nbytes = 4.0 * rows * d
            copies = max(1, int(ROTATE_BYTES // nbytes) + 1)
            xs = [x] + [x.clone() for _ in range(copies - 1)]
            ys = [torch.empty_like(x) for _ in range(copies)]
            runs = {name: [launcher(lib, xc, g, b, yc) for xc, yc in zip(xs, ys)]
                    for name, lib in libs.items()}
            runs["F.layer_norm"] = [lambda xc=xc: F.layer_norm(xc, (d,), g, b, EPS) for xc in xs]
            # the same bytes read and written with no arithmetic: what the
            # card's memory gives such a stream
            runs["copy"] = [lambda xc=xc, yc=yc: yc.copy_(xc) for xc, yc in zip(xs, ys)]
            errs = {}
            for name, fns in runs.items():
                if name in ("F.layer_norm", "copy"):
                    errs[name] = ulp_err(fns[0](), ref) if name == "F.layer_norm" else None
                    continue
                fns[0]()
                torch.cuda.synchronize()
                errs[name] = ulp_err(ys[0], ref)
            warm = {name: [] for name in runs}
            cold = {name: [] for name in runs}
            for _ in range(args.rounds):
                for name, fns in runs.items():
                    warm[name].append(time_ms(fns[:1], args.reps))
                    cold[name].append(time_ms(fns, max(args.reps, copies)))
            bound = nbytes / PEAK_BYTES * 1e3
            for name in runs:
                w, c = statistics.median(warm[name]), statistics.median(cold[name])
                row = dict(variant=name, rows=rows, d=d, launches=launches, ulp_err=errs[name],
                           warm_ms=w, rotated_ms=c, bound_ms=bound, warm_share=bound / w,
                           rotated_share=bound / c)
                rows_out.append(row)
                err = "-" if errs[name] is None else f"{errs[name]:.2f}"
                print(f"D={d} rows={rows} {name}: ulp err {err}, warm {w * 1e3:.2f} us "
                      f"(share {bound / w:.3f}{', L2-resident' if bound / w > 1 else ''}), "
                      f"rotated {c * 1e3:.2f} us (share {bound / c:.3f}), bound {bound * 1e3:.2f} us",
                      flush=True)
            del xs, ys, runs
            torch.cuda.empty_cache()
    totals = {}
    for r in rows_out:
        t = totals.setdefault(r["variant"], dict(warm_ms=0.0, rotated_ms=0.0, bound_ms=0.0))
        for k in ("warm_ms", "rotated_ms", "bound_ms"):
            t[k] += r["launches"] * r[k]
    for name, t in totals.items():
        print(f"one forward ({sum(c[2] for c in CALLS)} launches) {name}: warm {t['warm_ms']:.4f} ms, "
              f"rotated {t['rotated_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms, shares "
              f"{t['bound_ms'] / t['warm_ms']:.3f} / {t['bound_ms'] / t['rotated_ms']:.3f}",
              flush=True)
    bad = [r for r in rows_out if r["variant"] not in ("F.layer_norm", "copy")
           and r["ulp_err"] > 1.0]
    result = dict(card=smi, calls=rows_out, totals=totals, ok=not bad)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(dict(ok=not bad, card=smi, totals=totals)))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
