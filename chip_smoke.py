#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (rga3_tpu_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each timed on its own line:
  1. device: the card, its power limit, TF32 off for the comparisons;
  2. build: the CUDA kernels from rga3_tpu_torch/csrc with nvcc;
  3. main path: `UniGRSegmentor.segment_video_multi` with UniGR at the release
     width (Qwen2.5-VL-7B + SAM2 Hiera-L at 1024^2, unfused Hiera), random
     bf16 weights made on the card from the seed, on an 8-frame 480x854
     video with 2 expressions, then once more warm, then once more under
     torch.profiler (device time by kernel, and the device's busy share of
     the untraced warm call). The kernels' launch counts and the calls they
     saw are reset just before the first call and read just after it; each
     kernel must have been launched;
  4. plain route: the same LLM forward and one SAM chunk with attention
     routed to the plain versions, on the same weights;
  5. kernels: each hand-written kernel against its plain PyTorch version at
     every call the main path made (its shapes, strides, causal flag and
     segment ids; bf16 inputs; per output row within ROW_TOL of the row's
     max|plain|), with its time, its bound, the plain version's time and the
     time of `torch.nn.functional.scaled_dot_product_attention` on the same
     work (a yardstick only: the port never calls it);
  6. reference: a small model on the card against the same model in f32 on
     the CPU.

The line before the last is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it. Without
a CUDA device, or outside the repository, the script exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# per output row (b, token, head): max_d |kernel - plain| <= ROW_TOL * max_d
# |plain|. bf16 outputs on both sides, f32 accumulation in both: a right
# kernel differs by about one bf16 ulp of the row's largest value (2^-7 of
# it); a kernel that skipped a quarter of the keys would be off by ~1x.
ROW_TOL = 2e-2
REPS = 10  # timed launches per kernel shape, after one warm-up
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


# --------------------------------------------------------------------------
# each kernel against its plain version, at the calls the main path made
# --------------------------------------------------------------------------


def randn_strided(shape, stride, gen):
    """bf16 N(0, 1) values in a tensor with the given shape and strides."""
    import torch

    t = torch.empty_strided(shape, stride, device="cuda", dtype=torch.bfloat16)
    return t.normal_(generator=gen)


def row_rel_err(out, ref, rows):
    """max over (b, row, h) of max_d |out - ref| / max_d |ref|, on `rows`
    (B, L) that have at least one valid key."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1).clamp_min(1e-6)
    return (diff / scale)[rows].max().item(), diff[rows].max().item()


def check_flash(key, segs, gen, reps):
    import torch
    import torch.nn.functional as F
    from rga3_tpu_torch.ops.attention import flash_attention, mha_reference

    qshape, qstride, kshape, kstride, vstride, causal, scale = key
    b, lq, h, d = qshape
    lk, hkv = kshape[1], kshape[2]
    q = randn_strided(qshape, qstride, gen)
    k = randn_strided(kshape, kstride, gen)
    v = randn_strided(kshape, vstride, gen)
    qseg, kseg = segs if segs is not None else (None, None)
    kw = dict(causal=causal, segment_ids=qseg, kv_segment_ids=kseg, scale=scale)
    out = flash_attention(q, k, v, **kw)
    ref = mha_reference(q, k, v, **kw)
    # the (q, k) pairs this call's masks allow: rows with none are only
    # checked for being finite (the kernel follows the TPU kernel's rule there)
    allowed = None
    if qseg is not None:
        allowed = qseg[:, :, None] == kseg[:, None, :]
    if causal:
        tril = torch.ones(lq, lk, dtype=torch.bool, device="cuda").tril()[None]
        allowed = tril if allowed is None else allowed & tril
    if allowed is None:
        rows, pairs = torch.ones(b, lq, dtype=torch.bool, device="cuda"), b * lq * lk
    else:
        allowed = allowed.expand(b, lq, lk)
        rows, pairs = allowed.any(-1), allowed.sum().item()
    if not torch.isfinite(out).all():
        raise AssertionError(f"flash {qshape}: non-finite output")
    rel, err = row_rel_err(out, ref, rows)
    if rel > ROW_TOL:
        raise AssertionError(f"flash {qshape}: row error {rel} > {ROW_TOL} of max|ref|")
    ms = time_ms(lambda: flash_attention(q, k, v, **kw), reps)
    plain_ms = time_ms(lambda: mha_reference(q, k, v, **kw), max(2, reps // 4))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_kw = {"enable_gqa": True} if hkv != h else {}
    if qseg is not None and bool((qseg != qseg[0, 0]).any() or (kseg != qseg[0, 0]).any()):
        lib_kw["attn_mask"] = allowed[:, None]
    else:
        lib_kw["is_causal"] = causal
    try:
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=scale, **lib_kw), reps)
    except TypeError:  # a torch without enable_gqa: no one-call yardstick
        lib_ms = None
    flops = 4.0 * h * d * pairs
    nbytes = 2.0 * (2 * b * lq * h * d + 2 * b * lk * hkv * d)
    if qseg is not None:
        nbytes += 4.0 * b * (lq + lk)
    desc = (f"B={b} Lq={lq} Lk={lk} H={h}/{hkv} D={d} causal={causal} "
            f"segments={'none' if qseg is None else qseg.unique().numel()}")
    return dict(desc=desc, err=err, rel=rel, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                bound=bound(flops, nbytes))


def check_window(key, _extra, gen, reps):
    import torch
    import torch.nn.functional as F
    from rga3_tpu_torch.ops.attention import window_attention, window_reference

    shape, qstride, kstride, vstride, w, scale = key
    b, l, h, d = shape
    q = randn_strided(shape, qstride, gen)
    k = randn_strided(shape, kstride, gen)
    v = randn_strided(shape, vstride, gen)
    out = window_attention(q, k, v, w, scale=scale)
    ref = window_reference(q, k, v, w, scale)
    if not torch.isfinite(out).all():
        raise AssertionError(f"window {shape}: non-finite output")
    rel, err = row_rel_err(out, ref, torch.ones(b, l, dtype=torch.bool, device="cuda"))
    if rel > ROW_TOL:
        raise AssertionError(f"window {shape}: row error {rel} > {ROW_TOL} of max|ref|")
    ms = time_ms(lambda: window_attention(q, k, v, w, scale=scale), reps)
    plain_ms = time_ms(lambda: window_reference(q, k, v, w, scale), max(2, reps // 4))

    def lib():
        def win(t):
            return t.reshape(b * (l // w), w, h, d).transpose(1, 2)
        return F.scaled_dot_product_attention(win(q), win(k), win(v), scale=scale)

    lib_ms = time_ms(lib, reps)
    flops = 4.0 * b * h * l * w * d
    nbytes = 2.0 * 4 * b * l * h * d
    return dict(desc=f"B={b} L={l} H={h} D={d} window={w}", err=err, rel=rel, ms=ms,
                plain_ms=plain_ms, lib_ms=lib_ms, bound=bound(flops, nbytes))


# --------------------------------------------------------------------------
# a small model on the card against the same weights on the CPU
# --------------------------------------------------------------------------


def small_reference(seed: int) -> None:
    import numpy as np
    import torch
    from rga3_tpu_torch.config import SegHeadConfig
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.evaluation.segmentor import UniGRSegmentor
    from rga3_tpu_torch.models.qwen25vl import tiny_config
    from rga3_tpu_torch.models.sam2.config import tiny_sam2_config, unfused
    from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
    from rga3_tpu_torch.ops.attention import flash_attention, window_attention

    proc = QwenVLProcessor.from_pretrained(
        "dummy", min_pixels=4 * 28 * 28, max_pixels=64 * 28 * 28,
        video_max_pixels=64 * 28 * 28)
    sam = unfused(tiny_sam2_config(128))
    # windows of 16 tokens everywhere: the kernel's smallest window
    sam = sam.replace(hiera=sam.hiera.replace(window_spec=(4, 4, 4, 4)))
    cfg = UniGRConfig(qwen=tiny_config(152_000), sam2=sam,
                      seg=SegHeadConfig(out_dim=sam.d_model, seg_token_id=proc.seg_token_id))
    cpu = UniGR(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(seed), std=0.1)
    gpu = UniGR(cfg, device="cuda", dtype=torch.bfloat16)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (112, 168, 3), dtype=np.uint8) for _ in range(2)]
    res = {}
    for name, model in (("cpu_f32", cpu), ("gpu_bf16", gpu)):
        seg = UniGRSegmentor(model, proc, num_frames_mllm=2, sam_chunk=2)
        f0, w0 = flash_attention.launches, window_attention.launches
        emb, has = seg._seg_embedding(frames, "the thing")
        logits = seg.decode_logits(seg.encode_frames(frames), emb)
        res[name] = (emb.float().cpu(), logits.float().cpu(), has,
                     flash_attention.launches - f0, window_attention.launches - w0)
    (ec, lc, hc, _, _), (eg, lg, hg, fl, wl) = res["cpu_f32"], res["gpu_bf16"]
    if not (hc and hg) or fl == 0 or wl == 0:
        raise AssertionError(f"small reference: has_seg {hc}/{hg}, launches {fl}/{wl}")
    emb_rel = ((eg - ec).norm() / ec.norm()).item()
    logit_rel = ((lg - lc).abs().max() / lc.abs().max()).item()
    agree = ((lg > 0) == (lc > 0)).float().mean().item()
    log(f"small reference (tiny UniGR, bf16 on the card vs f32 plain on the CPU): "
        f"[SEG] rel err {emb_rel:.3e}, mask logit max err / max|logit| "
        f"{logit_rel:.3e}, mask agreement {agree:.5f}")
    if not (emb_rel < 5e-2 and logit_rel < 5e-2 and agree > 0.97):
        raise AssertionError("small reference: the card disagrees with the CPU")


def device_breakdown(run, top: int = 20) -> float:
    """Run `run()` under torch.profiler, print the device time by kernel
    name and the host wall time around it, and return the device busy ms
    (the tracer slows the host, so that wall time is not the call's)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    evs.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    log(f"profile: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall (traced); "
        f"{len(evs)} kernel names; top {top}:")
    for e in evs[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x  {e.key[:100]}")
    return busy_ms


# --------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import rga3_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the rga3_tpu_torch package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    import numpy as np
    from rga3_tpu_torch.config import SegHeadConfig
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.evaluation.segmentor import UniGRSegmentor
    from rga3_tpu_torch.models.qwen25vl import QWEN25_VL_7B
    from rga3_tpu_torch.models.sam2.config import Sam2Config, unfused
    from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
    from rga3_tpu_torch.ops import _kernels
    from rga3_tpu_torch.ops.attention import (
        flash_attention, reset_launches, set_plain_attention, window_attention,
    )

    t_all = time.perf_counter()
    # ---- 1. device
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card_line = smi[0] if smi else "nvidia-smi: no output"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {kind} x{torch.cuda.device_count()}; nvidia-smi: {card_line}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    log(f"phase device: {time.perf_counter() - t0:.2f} s")

    # ---- 2. build
    t0 = time.perf_counter()
    _kernels.library()
    log(f"build: nvcc {_kernels.build_seconds if _kernels.build_seconds is not None else 0.0:.2f} s")
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "spill" in line.lower():
            log(f"  ptxas: {line.strip()}")
    log(f"phase build: {time.perf_counter() - t0:.2f} s")

    # ---- 3. main path at full width
    t0 = time.perf_counter()
    seed = args.seed
    rng = np.random.default_rng(seed)
    n_frames, fh, fw = 8, 480, 854
    frames = [rng.integers(0, 256, (fh, fw, 3), dtype=np.uint8) for _ in range(n_frames)]
    expressions = ["the person on the left", "the red car moving away"]
    proc = QwenVLProcessor.from_pretrained("dummy")
    cfg = UniGRConfig(
        qwen=QWEN25_VL_7B, sam2=unfused(Sam2Config()),
        seg=SegHeadConfig(out_dim=256, seg_token_id=proc.seg_token_id),
    )
    chunk = 8
    model = UniGR(cfg, device="cuda", dtype=torch.bfloat16)
    model.init_weights(torch.Generator("cuda").manual_seed(seed))
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"model: UniGR Qwen2.5-VL-7B + SAM2 Hiera-L (unfused), {n_params / 1e9:.3f} B "
        f"params in bf16, built on the card in {time.perf_counter() - t0:.2f} s")
    seg = UniGRSegmentor(model, proc, num_frames_mllm=8, sam_chunk=chunk)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    masks = seg.segment_video_multi(frames, expressions)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    wrappers = {"flash_attention": flash_attention, "window_attention": window_attention}
    launches = {k: f.launches for k, f in wrappers.items()}
    # a snapshot: the calls after this one add to the wrappers' records
    calls = {k: {key: tuple(rec) for key, rec in f.shapes.items()}
             for k, f in wrappers.items()}
    log(f"main path: segment_video_multi {wall:.3f} s; phases (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in seg.phase_seconds.items()))
    log(f"main path: masks {masks.shape} {masks.dtype}, foreground {masks.mean():.4f}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"main path launches: {launches}; distinct calls: "
        + ", ".join(f"{k} {len(v)}" for k, v in calls.items()))
    if masks.shape != (len(expressions), n_frames, fh, fw):
        raise AssertionError(f"mask shape {masks.shape}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was not launched on the main path")
    # the same call again, warm (kernels loaded, allocator and cuBLAS set up)
    for k in seg.phase_seconds:
        seg.phase_seconds[k] = 0.0
    t1 = time.perf_counter()
    seg.segment_video_multi(frames, expressions)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t1
    log(f"main path, warm call: segment_video_multi {warm:.3f} s; "
        "phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in seg.phase_seconds.items()))
    # where the device time goes: one more call, traced
    busy = device_breakdown(lambda: seg.segment_video_multi(frames, expressions))
    log(f"profile: device busy in the traced call / wall of the untraced warm call "
        f"of this run: {busy:.1f} / {warm * 1e3:.1f} ms = {busy / (warm * 1e3):.3f}")
    log(f"phase main_path: {time.perf_counter() - t0:.2f} s")

    # ---- 4. the plain route, called explicitly, on the same weights
    t0 = time.perf_counter()
    emb_k, has_k = seg._seg_embedding(frames, expressions[0])
    logits_k = seg.decode_logits(seg.encode_frames(frames[:chunk]), emb_k)
    set_plain_attention(model, True)
    emb_p, has_p = seg._seg_embedding(frames, expressions[0])
    logits_p = seg.decode_logits(seg.encode_frames(frames[:chunk]), emb_k)
    set_plain_attention(model, False)
    for name, t in (("[SEG] kernel", emb_k), ("[SEG] plain", emb_p),
                    ("mask logits kernel", logits_k), ("mask logits plain", logits_p)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name}: non-finite values")
    emb_rel = ((emb_k.float() - emb_p.float()).norm() / emb_p.float().norm()).item()
    agree = ((logits_k > 0) == (logits_p > 0)).float().mean().item()
    logit_rel = ((logits_k - logits_p).abs().max() / logits_p.abs().max()).item()
    log(f"plain route: has_seg {has_k}/{has_p}; [SEG] embeddings and mask logits "
        f"{tuple(logits_k.shape)} finite; [SEG] embedding rel err {emb_rel:.3e}; "
        f"mask logits max err / max|logit| "
        f"{logit_rel:.3e}, mask agreement {agree:.5f}")
    if not (has_k and has_p and emb_rel < 0.1 and agree > 0.95):
        raise AssertionError("the kernel route disagrees with the plain route")
    del model, seg, emb_k, emb_p, logits_k, logits_p
    torch.cuda.empty_cache()
    log(f"phase plain_route: {time.perf_counter() - t0:.2f} s")

    # ---- 5. each kernel against its plain version, at every call the main
    # path made (shapes, strides, masks and segment ids as recorded)
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(seed)
    kernels = []
    for kname, check, src, replaces in (
        ("flash_attention", check_flash,
         "rga3_tpu_torch/csrc/flash_attention.cu", "rga3_tpu/ops/attention.py:75"),
        ("window_attention", check_window,
         "rga3_tpu_torch/csrc/window_attention.cu", "rga3_tpu/ops/attention.py:228"),
    ):
        tot = dict(ms=0.0, plain_ms=0.0, lib_ms=0.0, bound_ms=0.0, ops_ms=0.0, err=0.0)
        for key, (n, extra) in calls[kname].items():
            r = check(key, extra, gen, REPS)
            log(f"kernel {kname} [{r['desc']}]: launches/call {n}, "
                f"max_abs_err {r['err']:.3e}, row err / max|ref| {r['rel']:.3e} "
                f"(tol {ROW_TOL}), ms {r['ms']:.4f}, bound_ms {r['bound'][0]:.4f} "
                f"({r['bound'][1]}), plain_ms {r['plain_ms']:.4f}, library_ms {r['lib_ms']}")
            tot["ms"] += n * r["ms"]
            tot["plain_ms"] += n * r["plain_ms"]
            tot["lib_ms"] = (None if tot["lib_ms"] is None or r["lib_ms"] is None
                             else tot["lib_ms"] + n * r["lib_ms"])
            tot["bound_ms"] += n * r["bound"][0]
            if r["bound"][1] == "operations":
                tot["ops_ms"] += n * r["bound"][0]
            tot["err"] = max(tot["err"], r["err"])
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": tot["err"], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops_ms"] * 2 >= tot["bound_ms"] else "bytes",
            "library_ms": tot["lib_ms"],
        })
    torch.cuda.empty_cache()
    log(f"phase kernels: {time.perf_counter() - t0:.2f} s")

    # ---- 6. a small model on the card against the same model on the CPU
    t0 = time.perf_counter()
    small_reference(seed)
    log(f"phase reference: {time.perf_counter() - t0:.2f} s")

    log(f"total: {time.perf_counter() - t_all:.2f} s")
    log("kernel ms/plain_ms/bound_ms/library_ms: per segment_video_multi call, "
        "the per-call times above times their launches")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
