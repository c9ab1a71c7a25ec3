"""Split the gap of `chip_smoke.py`'s phase 8 small reference: the tiny
UniGR's [SEG] embedding and mask logits in f32 on the CPU against the same
weights in bf16 on the card (the kernel route and the plain route), in bf16
on the CPU (the plain versions), and on the card decoding the CPU's [SEG]
embedding (the SAM side alone).

    PYTHONPATH=. python3 rga3_tpu_torch/tools/probe_small_reference.py --seed N

Needs an NVIDIA GPU. The model, weights (normal(0, 0.1) from the seed),
frames and prompt are phase 8's; like `chip_smoke.py`, it runs itself again
with PYTHONHASHSEED = N, which the word tokenizer's hash needs to give the
smoke's prompt. One line per route, then a JSON object of the numbers.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if os.environ.get("PYTHONHASHSEED") != str(args.seed):
        sys.stdout.flush()
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": str(args.seed)})
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from rga3_tpu_torch.config import SegHeadConfig
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.evaluation.segmentor import UniGRSegmentor
    from rga3_tpu_torch.models.qwen25vl import tiny_config
    from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
    from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
    from rga3_tpu_torch.ops.attention import set_plain_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = args.seed
    proc = QwenVLProcessor.from_pretrained(
        "dummy", min_pixels=4 * 28 * 28, max_pixels=64 * 28 * 28,
        video_max_pixels=64 * 28 * 28)
    sam = tiny_sam2_config(128)
    sam = sam.replace(hiera=sam.hiera.replace(window_spec=(4, 4, 4, 4), fused_block_max_dim=32))
    cfg = UniGRConfig(qwen=tiny_config(152_000), sam2=sam,
                      seg=SegHeadConfig(out_dim=sam.d_model, seg_token_id=proc.seg_token_id))
    cpu = UniGR(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(seed), std=0.1)
    models = {"cpu_bf16": UniGR(cfg, device="cpu", dtype=torch.bfloat16),
              "card_bf16": UniGR(cfg, device="cuda", dtype=torch.bfloat16)}
    for m in models.values():
        m.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (112, 168, 3), dtype=np.uint8) for _ in range(2)]

    def run(model, emb=None):
        seg = UniGRSegmentor(model, proc, num_frames_mllm=2, sam_chunk=2)
        if emb is None:
            emb, _ = seg._seg_embedding(frames, "the thing")
        logits = seg.decode_logits(seg.encode_frames(frames), emb.to(model.device, model.dtype))
        return emb.float().cpu(), logits.float().cpu()

    ec, lc = run(cpu)
    card = models["card_bf16"]
    outs = {"card_bf16 kernel route": run(card)}
    set_plain_attention(card, True)
    outs["card_bf16 plain route"] = run(card)
    set_plain_attention(card, False)
    outs["card_bf16 kernel route, the CPU's [SEG]"] = run(card, ec)
    outs["cpu_bf16 plain"] = run(models["cpu_bf16"])
    report = {"seed": seed, "card": torch.cuda.get_device_name(0)}
    for name, (e, lg) in outs.items():
        row = {"seg_rel": ((e - ec).norm() / ec.norm()).item(),
               "logit_rel": ((lg - lc).abs().max() / lc.abs().max()).item(),
               "agree": ((lg > 0) == (lc > 0)).float().mean().item()}
        report[name] = row
        print(f"seed {seed} {name} vs cpu_f32: [SEG] rel err {row['seg_rel']:.3e}, mask logit "
              f"max err / max|logit| {row['logit_rel']:.3e}, mask agreement {row['agree']:.5f}",
              flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
