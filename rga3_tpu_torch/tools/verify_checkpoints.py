"""One-command checkpoint verification, counterpart of
`scripts/verify_checkpoints.py`: loader -> per-block activation diff ->
small eval slices of the measurement configs, one JSON report.

    python -m rga3_tpu_torch.tools.verify_checkpoints --tiny --device cpu --out verify.json
    python -m rga3_tpu_torch.tools.verify_checkpoints --unigr_dir /path/UniGR-7B \
        --sam2_ckpt /path/sam2_hiera_large.pt --cotracker_ckpt /path/scaled_offline.pth \
        --out verify.json [--skip_act_diff]

Stages (each isolated and timed: one failure does not stop the rest):
  load              checkpoint -> the port's model, for every component given
  act_diff          per-block drift against HF transformers (a subprocess of
                    `tools/activation_diff.py`; needs transformers, so the
                    card, which has none, runs with --skip_act_diff)
  config1_qa        demo QA: frames -> processor -> prefill + decode -> text
  config2_vip       ViP-Bench-style region QA (a rasterized overlay)
  config3_seg       ReasonSeg-style [SEG] -> SAM2 mask (gIoU on a synth box)
  config4_vos       MeViS-style video [SEG] -> per-frame masks (J&F)
  config5_int4      the int4 serving path (int4 LM, int8 vision)
  config6_spec      speculative decoding: the answer equals greedy's
  config7_stom      STOM overlay propagation, then QA on the frames
  config8_prequant  int8 save_quantized -> load_quantized: bit-equal, decodes
  config9_learned   the in-repo learned tiny checkpoint
                    (runs/learning_proof_tiny/params_f16.npz) on a fresh
                    learnable tree: gIoU must beat 0.5

`--tiny` draws a random tiny UniGR (f32 on the CPU, bf16 on the card);
`--unigr_dir` reads a merged UniGR directory (safetensors or .bin) with the
port's loader into the Qwen2.5-VL size whose shapes it has (7b, 3b or
tiny), in bf16 (f32 at tiny on the CPU). A directory without tokenizer files
(an export of a run from `--model_dir dummy`) takes the dummy word
tokenizer, which the report names. Every stage runs on `--device` (default
the card). The report is written to `--out`; the last line printed is
`{"verify_checkpoints": mode, "all_ok", "out"}`; the exit code is 0 when
`load` and every config passed, else 1.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Dict, Optional, Sequence

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
LEARNED_NPZ = os.path.join(ROOT, "runs", "learning_proof_tiny", "params_f16.npz")
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tiny", action="store_true",
                   help="random tiny models end-to-end (no checkpoints)")
    p.add_argument("--unigr_dir", default=None,
                   help="merged UniGR HF dir (SurplusDeficit/UniGR-7B)")
    p.add_argument("--sam2_ckpt", default=None,
                   help="sam2_hiera_large.pt (standalone check; the UniGR dir already "
                   "embeds SAM2 weights)")
    p.add_argument("--cotracker_ckpt", default=None, help="CoTracker3 scaled_offline.pth")
    p.add_argument("--samples", type=int, default=5, help="eval-slice samples per config")
    p.add_argument("--skip_act_diff", action="store_true")
    p.add_argument("--out", default="verify_checkpoints.json")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def stage(report: Dict, name: str, fn) -> None:
    """Run `fn`, recording {"ok", "seconds", **its dict} or the error."""
    t0 = time.time()
    try:
        out = fn() or {}
        report[name] = {"ok": True, "seconds": round(time.time() - t0, 1), **out}
        print(f"[verify] {name}: ok ({report[name]['seconds']}s)", flush=True)
    except Exception as e:  # isolate stages
        report[name] = {
            "ok": False, "seconds": round(time.time() - t0, 1),
            "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc(limit=4),
        }
        print(f"[verify] {name}: FAIL — {e}", flush=True)


def giou_ciou(pred: np.ndarray, gt: np.ndarray) -> float:
    inter = float(np.logical_and(pred, gt).sum())
    union = float(np.logical_or(pred, gt).sum())
    return inter / max(union, 1.0)


def _unigr_size(sd: Dict[str, torch.Tensor]) -> str:
    """The Qwen2.5-VL size (with its SAM2) whose UniGR state-dict shapes
    are `sd`'s, compared on the meta device."""
    from ..config import SegHeadConfig
    from ..models.sam2.config import Sam2Config, tiny_sam2_config
    from ..models.unigr.build import QWEN_SIZES, qwen_config
    from ..models.unigr.model import UniGR, UniGRConfig

    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    for size in QWEN_SIZES:
        scfg = tiny_sam2_config() if size == "tiny" else Sam2Config()
        cfg = UniGRConfig(qwen=qwen_config(size), sam2=scfg,
                          seg=SegHeadConfig(out_dim=scfg.d_model))
        want = {k: tuple(v.shape) for k, v in UniGR(cfg, device="meta").state_dict().items()}
        if want == shapes:
            return size
    raise ValueError(f"the checkpoint's {len(shapes)} tensors match no UniGR of {QWEN_SIZES}")


def _processor(unigr_dir: str):
    """(processor, its source): the directory's tokenizer, or the dummy
    word tokenizer when the directory has none."""
    from ..data.processor import QwenVLProcessor

    if any(os.path.exists(os.path.join(unigr_dir, f)) for f in TOKENIZER_FILES):
        return QwenVLProcessor.from_pretrained(unigr_dir), unigr_dir
    return QwenVLProcessor.from_pretrained("dummy"), "dummy (the directory has no tokenizer)"


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from ..config import SegHeadConfig
    from ..data.processor import QwenVLProcessor
    from ..device import resolve_device
    from ..evaluation.segmentor import UniGRChat, UniGRSegmentor
    from ..models.unigr.model import UniGR, UniGRConfig

    device = resolve_device(args.device)
    report: Dict = {"mode": "tiny" if args.tiny else "real", "device": str(device),
                    "configs": {}}
    rng = np.random.default_rng(0)
    state: Dict = {}

    # ---------------- load ------------------------------------------
    def do_load():
        info: Dict = {}
        if args.tiny:
            from ..models.qwen25vl import tiny_config
            from ..models.sam2.config import tiny_sam2_config

            qcfg = tiny_config(vocab_size=152_000)
            scfg = tiny_sam2_config(image_size=64).replace(d_model=32)
            proc = QwenVLProcessor.from_pretrained(
                "dummy", max_pixels=16 * 28 * 28, video_max_pixels=16 * 28 * 28)
            cfg = UniGRConfig(qwen=qcfg, sam2=scfg,
                              seg=SegHeadConfig(out_dim=32, seg_token_id=proc.seg_token_id))
            dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
            model = UniGR(cfg, device=device, dtype=dtype)
            model.init_weights(torch.Generator(device).manual_seed(0))
            info["params_mb"] = round(sum(
                p.numel() * p.element_size() for p in model.parameters()) / 1e6, 1)
        else:
            if not args.unigr_dir:
                raise ValueError("--unigr_dir required without --tiny")
            from ..models.qwen25vl.loader import load_unigr_state_dict
            from ..models.sam2.config import Sam2Config, tiny_sam2_config
            from ..models.unigr.build import qwen_config

            proc, info["processor"] = _processor(args.unigr_dir)
            t0 = time.time()
            sd = load_unigr_state_dict(args.unigr_dir, torch.bfloat16)
            info["read_seconds"] = round(time.time() - t0, 1)
            size = _unigr_size(sd)
            scfg = tiny_sam2_config() if size == "tiny" else Sam2Config()
            cfg = UniGRConfig(qwen=qwen_config(size), sam2=scfg,
                              seg=SegHeadConfig(out_dim=scfg.d_model,
                                                seg_token_id=proc.seg_token_id))
            dtype = torch.float32 if size == "tiny" and device.type == "cpu" else torch.bfloat16
            model = UniGR(cfg, device=device, dtype=dtype)
            model.load_state_dict(sd, strict=True)
            del sd
            info["size"] = size
            info["n_params"] = sum(p.numel() for p in model.parameters())
        state.update(model=model.eval(), proc=proc, cfg=cfg)
        if args.sam2_ckpt:
            from ..models.sam2.loader import load_sam2_state_dict

            info["sam2_leaves"] = len(load_sam2_state_dict(args.sam2_ckpt))
        if args.cotracker_ckpt:
            # the config inferred from the checkpoint's own tensor shapes
            from ..models.stom.convert import build_cotracker3_from_checkpoint

            ct = build_cotracker3_from_checkpoint(args.cotracker_ckpt, device=device)
            info["cotracker_leaves"] = len(ct.state_dict())
            info["cotracker_input_dim"] = ct.cfg.input_dim
            info["cotracker_flow"] = [ct.cfg.flow_emb_dim, ct.cfg.flow_cat_coords]
            state["cotracker"] = ct
        return info

    stage(report, "load", do_load)
    if not report["load"]["ok"]:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(json.dumps({"verify": "load failed"}))
        return 1

    # ---------------- activation diff -------------------------------
    if not args.skip_act_diff:
        def do_act():
            cmd = [sys.executable, "-m", "rga3_tpu_torch.tools.activation_diff",
                   "--dtype", "bf16", "--device", args.device]
            cmd += ["--tiny"] if args.tiny else ["--hf_dir", args.unigr_dir]
            # the oracle is transformers' torch model: its TensorFlow and
            # flax back ends stay unimported
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600, cwd=ROOT,
                               env={**os.environ, "PYTHONPATH": ROOT, "USE_TF": "0",
                                    "USE_FLAX": "0"})
            if r.returncode != 0:
                raise RuntimeError(r.stderr[-800:])
            return {"tail": r.stdout.strip().splitlines()[-8:]}

        stage(report, "act_diff", do_act)

    model, proc, cfg = state["model"], state["proc"], state["cfg"]

    def synth_frames(n, size=64):
        return [rng.integers(0, 255, (size, size, 3), dtype=np.uint8) for _ in range(n)]

    # ---------------- config 1: demo QA -----------------------------
    def do_qa():
        chat = UniGRChat(model, proc, max_new_tokens=8)
        state["chat"] = chat
        outs = [chat.answer("What is happening in this video?", video_frames=synth_frames(2))
                for _ in range(min(args.samples, 2) if args.tiny else args.samples)]
        assert all(isinstance(o, str) for o in outs)
        return {"n": len(outs), "sample": outs[0][:80]}

    stage(report["configs"], "config1_qa", do_qa)

    # ---------------- config 2: ViP-Bench region QA -----------------
    def do_vip():
        from PIL import Image

        from ..data.visual_prompts.generator import image_blending

        chat = state.get("chat") or UniGRChat(model, proc, max_new_tokens=8)
        img = Image.fromarray(synth_frames(1, 96)[0])
        img, _ = image_blending(img, shape="rectangle", bbox_coord=(10, 10, 60, 60),
                                rgb_value=(255, 0, 0), image_size_anchor=96)
        out = chat.answer("What is within the red rectangle?", images=[np.asarray(img)])
        assert isinstance(out, str)
        return {"sample": out[:80]}

    stage(report["configs"], "config2_vip", do_vip)

    # ---------------- config 3: image [SEG] -------------------------
    def do_seg_img():
        seg = UniGRSegmentor(model, proc, num_frames_mllm=2, sam_chunk=2)
        state["seg"] = seg
        frames = synth_frames(2)
        gt = np.zeros((64, 64), bool)
        gt[16:48, 16:48] = True
        masks = seg.segment_video(frames, "the bright square")
        pred = np.asarray(masks[0]) > 0
        return {"pred_area": int(pred.sum()), "giou_vs_synth_gt": round(giou_ciou(pred, gt), 4)}

    stage(report["configs"], "config3_seg", do_seg_img)

    # ---------------- config 4: video [SEG] (J&F) -------------------
    def do_vos():
        from ..evaluation.jf_metrics import db_eval_boundary, db_eval_iou

        seg = state.get("seg")
        if seg is None:
            raise RuntimeError("config3 segmentor unavailable")
        frames = synth_frames(4)
        masks = seg.segment_video(frames, "the moving object")
        gt = np.zeros((len(masks), 64, 64), np.uint8)
        gt[:, 20:44, 20:44] = 1
        js, fs = [], []
        for m, g in zip(masks, gt):
            pm = (np.asarray(m) > 0).astype(np.uint8)
            js.append(db_eval_iou(g, pm))
            fs.append(db_eval_boundary(g, pm))
        return {"J_mean": round(float(np.mean(js)), 4), "F_mean": round(float(np.mean(fs)), 4),
                "frames": len(masks)}

    stage(report["configs"], "config4_vos", do_vos)

    # ---------------- config 5: int4 serving path --------------------
    # an int4 LM and an int8 vision tower through the transform that
    # quantizes real weights (`quantize_for_serving`), on a copy
    def do_int4():
        from ..models.qwen25vl.language import QuantLinear
        from ..ops.quant import quantize_for_serving

        qwen4 = quantize_for_serving(copy.deepcopy(model.qwen), "int4")
        try:
            out = UniGRChat(qwen4, proc, max_new_tokens=8).answer(
                "What is happening?", video_frames=synth_frames(2))
            n_q4 = sum(1 for m in qwen4.modules() if isinstance(m, QuantLinear) and m.bits == 4)
        finally:
            del qwen4
            _release(device)
        assert isinstance(out, str)
        assert n_q4 > 0, "no int4-packed kernels in the serving model"
        return {"int4_kernels": n_q4, "sample": out[:80]}

    stage(report["configs"], "config5_int4", do_int4)

    # ---------------- config 6: speculative decoding ------------------
    # a self-draft (the same weights, as the JAX script's draft params):
    # draft-and-verify greedy is token-exact, so the answers are equal
    def do_spec():
        frames = synth_frames(2)
        plain = state["chat"].answer("Describe the scene.", video_frames=frames)
        chat_s = UniGRChat(model, proc, max_new_tokens=8, draft_model=model.qwen, spec_k=2)
        spec = chat_s.answer("Describe the scene.", video_frames=frames)
        assert spec == plain, f"speculative != greedy: {spec!r} vs {plain!r}"
        return {"sample": spec[:80], "token_exact": True}

    stage(report["configs"], "config6_spec", do_spec)

    # ---------------- config 7: STOM propagation (BASELINE config 5) --
    # the overlay propagated by a CoTracker3, then the propagated frames go
    # through the QA path: the whole region-QA pipeline
    def do_stom():
        from PIL import Image, ImageDraw

        from ..models.stom import STOM
        from ..models.stom.cotracker3 import (
            CoTracker3Offline, CoTracker3Predictor, shipped_tracker, tiny_cotracker3_config,
        )

        if state.get("cotracker") is not None:
            tracker = CoTracker3Predictor(state["cotracker"], device=device, max_points=64)
            backend = "official_ckpt"
        else:
            tracker = None if args.tiny else shipped_tracker(device=device, max_points=64)
            backend = "shipped"
            if tracker is None:
                cmodel = CoTracker3Offline(tiny_cotracker3_config())
                cmodel.init_weights(torch.Generator().manual_seed(1))
                tracker = CoTracker3Predictor(cmodel.to(device).eval(), device=device,
                                              max_points=64)
                backend = "tiny_random"
        stom = STOM(tracker=tracker)
        frames = []
        for i in range(4):
            f = rng.integers(0, 80, (96, 128, 3)).astype(np.uint8)
            f[30 + 4 * i:60 + 4 * i, 40 + 6 * i:80 + 6 * i] = 210
            frames.append(f)
        vip = Image.new("RGBA", (128, 96), (0, 0, 0, 0))
        # an ellipse outline centred at (60, 45), axes (25, 20), 3 px wide
        ImageDraw.Draw(vip).ellipse((35, 25, 85, 65), outline=(255, 0, 0, 255), width=3)
        out_frames = stom.propagate_in_video(frames, np.asarray(vip), 0, "ellipse")
        assert len(out_frames) == len(frames)
        assert not np.array_equal(np.asarray(out_frames[0]), frames[0]), \
            "key frame not composited"
        ans = state["chat"].answer("What is the marked region doing?",
                                   video_frames=[np.asarray(f) for f in out_frames])
        assert isinstance(ans, str)
        n_prop = sum(int(not np.array_equal(np.asarray(o), f))
                     for o, f in zip(out_frames[1:], frames[1:]))
        return {"backend": backend, "propagated_frames": n_prop, "sample": ans[:80]}

    stage(report["configs"], "config7_stom", do_stom)

    # ---------------- config 8: pre-quantized checkpoint load ---------
    # save_quantized -> load_quantized reproduces the in-memory quantized
    # model exactly, and the loaded model still decodes
    def do_prequant():
        from ..ops.quant import load_quantized, quantize_for_serving, save_quantized

        qmodel = copy.deepcopy(model)
        quantize_for_serving(qmodel.qwen, "int8")  # int8 LM + int8 vision
        try:
            with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(args.out))) as d:
                save_quantized(qmodel, d, {"quant": "int8", "mode": "int8", "tiny": args.tiny})
                loaded, meta = load_quantized(d)
            want = qmodel.state_dict()
            assert set(loaded) == set(want), "state dict names drifted"
            for k, v in want.items():
                got = loaded[k].to(v.device)
                same = (torch.equal(got, v) if not v.is_floating_point()
                        else torch.equal(got.float(), v.float()))
                assert same, f"roundtrip mismatch at {k}"
            qcfg = cfg.qwen.replace(text=cfg.qwen.text.replace(quant_int8=True),
                                    vision=cfg.qwen.vision.replace(quant_int8=True))
            del qmodel
            _release(device)
            model8 = UniGR(cfg.replace(qwen=qcfg), device=device, dtype=model.dtype)
            model8.load_state_dict({k: v.to(model.dtype) if v.is_floating_point() else v
                                    for k, v in loaded.items()}, strict=True)
            del loaded
            out = UniGRChat(model8.eval(), proc, max_new_tokens=8).answer(
                "What is happening?", video_frames=synth_frames(2))
            del model8
        finally:
            _release(device)
        assert isinstance(out, str)
        return {"meta": meta, "sample": out[:80]}

    stage(report["configs"], "config8_prequant", do_prequant)

    # ---------------- config 9: the LEARNED tiny checkpoint -----------
    # the learning-proof run's best parameters (a committed f16 npz) on a
    # fresh learnable tree (positions unseen in training): the masks must
    # clearly beat chance, where the random-init model scores ~0
    def do_learned():
        if not os.path.exists(LEARNED_NPZ):
            return {"skipped": "no learned checkpoint committed"}
        from ..evaluation.image_seg_eval import run_reason_seg_val
        from .synth_trees import build_learn_root

        lmodel, lproc = learned_tiny_model(device)
        with tempfile.TemporaryDirectory() as d:
            build_learn_root(d, seed=11)
            scores = run_reason_seg_val(UniGRSegmentor(lmodel, lproc, num_frames_mllm=2), d,
                                        split="val", max_samples=6)
        assert scores["gIoU"] > 0.5, (
            f"learned checkpoint gIoU {scores['gIoU']:.3f} <= 0.5: does not beat chance")
        return {"gIoU": round(scores["gIoU"], 4), "cIoU": round(scores["cIoU"], 4),
                "n": scores["n"], "dtype": str(lmodel.dtype).replace("torch.", "")}

    stage(report["configs"], "config9_learned", do_learned)

    ok = report["load"]["ok"] and all(v.get("ok") for v in report["configs"].values())
    report["all_ok"] = bool(ok)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({"verify_checkpoints": report["mode"], "all_ok": report["all_ok"],
                      "out": args.out}), flush=True)
    return 0 if ok else 1


def learned_tiny_model(device: torch.device):
    """(the learning-proof run's UniGR with `runs/learning_proof_tiny/
    params_f16.npz`, its processor): the train entry point's tiny model
    with the release LoRA (r=128, alpha=256); f32 on the CPU, bf16 on the
    card (whose Hiera windows of 2x2 tokens run the window kernel's packed
    small windows)."""
    from ..config import SegHeadConfig
    from ..convert import load_params_npz, torch_state_dict_from_flax
    from ..data.processor import QwenVLProcessor
    from ..models.qwen25vl import tiny_config
    from ..models.sam2.config import tiny_sam2_config
    from ..models.unigr.model import UniGR, UniGRConfig

    proc = QwenVLProcessor.from_pretrained("dummy")
    q = tiny_config()
    q = q.replace(text=q.text.replace(lora_rank=128, lora_alpha=256.0))
    sam = tiny_sam2_config()
    cfg = UniGRConfig(qwen=q, sam2=sam,
                      seg=SegHeadConfig(out_dim=sam.d_model, seg_token_id=proc.seg_token_id))
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    model = UniGR(cfg, device=device, dtype=dtype)
    model.load_state_dict(torch_state_dict_from_flax(load_params_npz(LEARNED_NPZ)), strict=True)
    return model.eval(), proc


def _release(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
