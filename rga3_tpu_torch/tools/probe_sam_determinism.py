"""Run the SAM2 Hiera-L image encoder and the mask decoder of the port many
times on the same inputs and report how far each repetition lies from the
first: the kernels of that path use no atomics, so every repetition should
give the same bits, and one that does not points at a race.

    PYTHONPATH=. python3 rga3_tpu_torch/tools/probe_sam_determinism.py [--reps N]

Needs an NVIDIA GPU. The weights are random (normal(0, 0.02), zero biases,
unit norm scales, from --seed), the default `Sam2Config()` at 1024^2, a
chunk of 8 random 480x854 frames resized on the card, as
`UniGRSegmentor.encode_frames` and `decode_logits` run them. Prints a line
per repetition that differs, and a JSON object as the last line.
"""
import argparse
import json
import sys

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from rga3_tpu_torch.models.sam2.config import Sam2Config
    from rga3_tpu_torch.models.sam2.model import Sam2Model
    from rga3_tpu_torch.ops.resize import resize_u8_bicubic_aa

    cfg = Sam2Config()
    model = Sam2Model(cfg, device="cuda", dtype=torch.bfloat16).eval()
    gen = torch.Generator("cuda").manual_seed(args.seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.endswith("weight") and p.dim() == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    rng = np.random.default_rng(args.seed)
    frames = rng.integers(0, 256, (8, 480, 854, 3), dtype=np.uint8)
    x = resize_u8_bicubic_aa(torch.as_tensor(frames, device="cuda"),
                             (cfg.image_size, cfg.image_size))
    lang = torch.randn(8, 1, cfg.d_model, device="cuda", generator=gen).to(torch.bfloat16)

    def run():
        with torch.no_grad():
            feats = tuple(model.forward_image(x)["backbone_fpn"])
            logits = model.decode_features_with_language(*feats, lang)["high_res_masks"][:, 0]
        return feats + (logits,)

    first = [t.clone() for t in run()]
    names = ["s0", "s1", "s2", "mask logits"]
    differ = []
    for rep in range(1, args.reps + 1):
        out = run()
        errs = [(a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-6)
                for a, b in zip(out, first)]
        if any(not torch.equal(a, b) for a, b in zip(out, first)):
            differ.append(rep)
            print(f"repetition {rep} differs: " + ", ".join(
                f"{n} max err / max|first| {e:.3e}" for n, e in zip(names, errs)), flush=True)
    torch.cuda.synchronize()
    print(json.dumps(dict(reps=args.reps, differing=len(differ), first_differing=differ[:10])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
