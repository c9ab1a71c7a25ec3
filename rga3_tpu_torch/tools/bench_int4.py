"""Check and time `int4_matmul` (csrc/int4_matmul.cu) on the card at the
Qwen2.5-VL-7B LM's projections.

    PYTHONPATH=. python3 rga3_tpu_torch/tools/bench_int4.py [--check-only]

Needs an NVIDIA GPU and nvcc (sm_90a). It first holds the kernel against
`int4_matmul_reference` per output row (within 2e-2 of the row's max|ref|)
at the card-only tests' shapes and checks that two launches give equal
bits, then times each call: the decode calls at M = 1 and 4 and the
prefill calls at M = 1280 (a chat prompt) and 5120 (a batch of four), each
by CUDA-graph replays over copies of the weights that together exceed the
L2 cache, beside `F.linear` on the weight dequantized to bf16 (a yardstick
the port never calls). Run with `PYTHONPATH=<tree>` to time another tree's
kernel, e.g. an unpacked parent commit.
"""
from __future__ import annotations

import argparse
import itertools
import subprocess
import sys

import torch
import torch.nn.functional as F

PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM dense bf16, HBM3
L2_ROTATE_BYTES = 100e6
TOL = 2e-2
# (in, out, launches a forward): q, k, v, o, gate, up, down of 28 layers
LM = ((3584, 3584, 56), (3584, 512, 56), (3584, 18944, 56), (18944, 3584, 28))
CHECKS = [(m, i, o) for m in (1, 2, 3, 4, 5, 8, 64, 65, 128, 129, 300, 1280)
          for i, o in ((3584, 512), (3584, 3584), (18944, 3584), (96, 200), (64, 512))]
CHECKS += [(5111, 3584, 18944), (1, 3584, 152064), (4, 3584, 152064), (7, 96, 256)]


def time_graph(fn, copies, reps=20):
    n = len(copies) * -(-reps // len(copies))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in copies:
            fn(c)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in itertools.islice(itertools.cycle(copies), n):
            fn(c)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * n)


def weights(in_dim, out, gen):
    from rga3_tpu_torch.ops import quant as tq

    w = torch.randn((in_dim, out), generator=gen, device="cuda") * 0.02
    return tq.quantize_int4(w)


def check(gen) -> None:
    from rga3_tpu_torch.ops import quant as tq

    worst = 0.0
    for m, in_dim, out in CHECKS:
        q, s = weights(in_dim, out, gen)
        x = torch.randn((m, in_dim), generator=gen, device="cuda").bfloat16()
        y, y2 = tq.int4_matmul(x, q, s), tq.int4_matmul(x, q, s)
        ref = tq.int4_matmul_reference(x, q, s)
        torch.cuda.synchronize()
        rel = ((y.float() - ref.float()).abs().amax(-1)
               / ref.float().abs().amax(-1).clamp_min(1e-6)).max().item()
        same = torch.equal(y, y2)
        worst = max(worst, rel)
        print(f"check M={m} in={in_dim} out={out}: row err {rel:.3e} equal bits {same}",
              flush=True)
        if not (torch.isfinite(y).all() and rel <= TOL and same):
            raise SystemExit(f"int4_matmul wrong at M={m} in={in_dim} out={out}")
    print(f"checks passed: worst row error {worst:.3e}", flush=True)


def bench(gen) -> None:
    from rga3_tpu_torch.ops import quant as tq

    for m in (1, 4, 1280, 5120):
        tot = tot_lib = tot_bound = 0.0
        shapes = LM + (((3584, 152064, 1),) if m <= 4 else ())
        for in_dim, out, n in shapes:
            q, s = weights(in_dim, out, gen)
            x = torch.randn((m, in_dim), generator=gen, device="cuda").bfloat16()
            wbytes = q.numel() + 4 * s.numel()
            copies = [(q, s)] + [(q.clone(), s.clone())
                                 for _ in range(min(63, int(L2_ROTATE_BYTES // wbytes)))]
            ms = time_graph(lambda qs: tq.int4_matmul(x, *qs), copies)
            del copies
            wd = tq.dequantize_int4(q, s).t().contiguous().bfloat16()
            lib = [wd] + [wd.clone() for _ in range(min(15, int(L2_ROTATE_BYTES // (2 * wd.numel()))))]
            lib_ms = time_graph(lambda w: F.linear(x, w), lib)
            del lib, wd
            flops = 2.0 * m * in_dim * out
            nbytes = 2.0 * m * in_dim + wbytes + 2.0 * m * out
            b = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
            by = "operations" if flops / PEAK_FLOPS >= nbytes / PEAK_BYTES else "bytes"
            tot, tot_lib, tot_bound = tot + n * ms, tot_lib + n * lib_ms, tot_bound + n * b
            print(f"time M={m} in={in_dim} out={out} x{n}: ms {ms:.4f} library {lib_ms:.4f} "
                  f"bound {b:.4f} ({by}) share {b / ms:.3f} TFLOP/s {flops / ms / 1e9:.1f} "
                  f"(library {flops / lib_ms / 1e9:.1f}) splits "
                  f"{tq.int4_splits(m, in_dim, out) if hasattr(tq, 'int4_splits') else '-'}",
                  flush=True)
        print(f"time M={m}: a forward's {sum(n for *_, n in shapes)} calls {tot:.4f} ms, "
              f"library {tot_lib:.4f}, bound {tot_bound:.4f}", flush=True)


def sweep(gen) -> None:
    """Each decode call at every split count the kernel can take (the
    wrapper's choice forced), to choose the policy from."""
    from rga3_tpu_torch.ops import quant as tq

    policy = tq.int4_splits
    try:
        for m in (1, 4):
            for in_dim, out, _ in LM:
                q, s = weights(in_dim, out, gen)
                x = torch.randn((m, in_dim), generator=gen, device="cuda").bfloat16()
                copies = [(q, s)] + [(q.clone(), s.clone()) for _ in range(
                    min(63, int(L2_ROTATE_BYTES // (q.numel() + 4 * s.numel()))))]
                stages = -(-in_dim // 2 // tq.INT4_STAGE_ROWS)
                times = []
                for splits in sorted({-(-stages // per) for per in range(1, stages + 1)}):
                    tq.int4_splits = lambda *_a, _s=splits, **_k: _s
                    times.append((splits, time_graph(lambda qs: tq.int4_matmul(x, *qs), copies)))
                tq.int4_splits = policy
                print(f"sweep M={m} in={in_dim} out={out}: policy {policy(m, in_dim, out)}; "
                      + " ".join(f"{sp}:{ms * 1e3:.2f}us" for sp, ms in times), flush=True)
                del copies
    finally:
        tq.int4_splits = policy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the decode calls at every split count")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_int4: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from rga3_tpu_torch.ops import _kernels
    from rga3_tpu_torch.ops import quant as tq

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}; torch {torch.__version__}; package {tq.__file__}", flush=True)
    _kernels.library()
    entry = ""
    for line in _kernels.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "arning" in line or "int4" in entry and ("registers" in line
                                                       or "spill" in line.lower()):
            print(f"ptxas {entry}: {line.strip()}", flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    check(gen)
    if not args.check_only:
        bench(gen)
    if args.sweep:
        sweep(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
