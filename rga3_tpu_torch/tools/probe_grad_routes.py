"""Compare the UniGR train step's gradients between the kernel route and the
plain route on the card, tensor by tensor, for the tiny UniGR with the
in-repo learned weights and with random weights.

    PYTHONPATH=. python3 rga3_tpu_torch/tools/probe_grad_routes.py [--seed N]

Needs an NVIDIA GPU. The model is the learning-proof run's (`tiny_config()`
with the release LoRA, `tiny_sam2_config()`, whose 2x2 windows the window
kernel packs 4 to a tile), bf16 on the card. Weights: `runs/learning_proof_tiny/
params_f16.npz` (--npz), then normal(0, 0.02) from --seed. The batch: two
samples of the learning-proof task (a bright red box on a dark noisy image,
"the bright red box", the box as the mask), collated by the port. For each
weight set it prints the mask decoder's largest low-resolution logit, the
losses of both routes, the relative L2 of all trainable gradients as one
vector, the worst tensors and the median, the decoder's tensors alone, and
the same against the kernel route with only the flash backward plain. The
last line is a JSON object of the numbers.
"""
import argparse
import json
import statistics
import sys

import numpy as np
import torch


def box_image(rng, h=64, w=88):
    """A dark noisy image with one bright red rectangle, and its mask."""
    img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
    bh, bw = int(rng.integers(h // 4, h // 2)), int(rng.integers(w // 4, w // 2))
    y0, x0 = int(rng.integers(2, h - bh - 2)), int(rng.integers(2, w - bw - 2))
    img[y0:y0 + bh, x0:x0 + bw] = (230, 40, 40)
    mask = np.zeros((h, w), np.float32)
    mask[y0:y0 + bh, x0:x0 + bw] = 1.0
    return img, mask


def make_batch(cfg, proc, seed, dev):
    from rga3_tpu_torch.data.collate import TrainSample, collate
    from rga3_tpu_torch.data.processor import ChatMessage
    from rga3_tpu_torch.ops.resize import resize_u8_bicubic_aa

    rng = np.random.default_rng(seed)
    size = cfg.sam2.image_size
    samples = []
    for i in range(2):
        img, mask = box_image(rng)
        sam = resize_u8_bicubic_aa(torch.from_numpy(img[None]), (size, size)).numpy()
        samples.append(TrainSample(
            sample_id=str(i),
            messages=[ChatMessage("user", [{"type": "image"}, {"type": "text", "text":
                                           "Please segment the bright red box."}]),
                      ChatMessage("assistant", [{"type": "text", "text": "Sure, [SEG]."}])],
            images=[img], sam_frames=sam, gt_masks=mask[None]))
    # the vision budget: the images' own patches, no padding
    patches = collate(samples, proc, cfg.qwen, pad_to_multiple=64)["pixel_values"].shape[0]
    c = collate(samples, proc, cfg.qwen, pad_to_multiple=64, vision_budget_tokens=patches)
    batch = {k: torch.as_tensor(c[k], device=dev) for k in (
        "input_ids", "labels", "position_ids", "images_sam", "gt_masks", "masks_valid",
        "pixel_patches")}
    batch["segment_ids"] = torch.as_tensor(c["attention_mask"], device=dev).int()
    batch["vision_layout"] = {k: torch.as_tensor(v, device=dev)
                              for k, v in c["vision_layout"].items()}
    return batch


def rel_l2(grads, refs):
    """(sorted [(rel L2, name)] per tensor, rel L2 of all as one vector); a
    key bias, whose exact gradient is zero, is left out of the list."""
    rels, d2s, r2s = [], 0.0, 0.0
    for n, gr in refs.items():
        g = grads[n]
        if gr is None or g is None:
            continue
        d2 = (g.float() - gr.float()).square().sum().item()
        r2 = gr.float().square().sum().item()
        d2s, r2s = d2s + d2, r2s + r2
        if not n.endswith("k_proj.bias"):
            rels.append(((d2 / max(r2, 1e-60)) ** 0.5, n))
    rels.sort(reverse=True)
    return rels, (d2s / r2s) ** 0.5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--npz", default="runs/learning_proof_tiny/params_f16.npz")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from rga3_tpu_torch.config import SegHeadConfig
    from rga3_tpu_torch.convert import load_params_npz, torch_state_dict_from_flax
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.models.qwen25vl import tiny_config
    from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
    from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
    from rga3_tpu_torch.ops import attention as tatt
    from rga3_tpu_torch.train.optimizer import trainable_mask

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    proc = QwenVLProcessor.from_pretrained("dummy")
    q = tiny_config()
    q = q.replace(text=q.text.replace(lora_rank=128, lora_alpha=256.0))
    sam = tiny_sam2_config()
    sam = sam.replace(hiera=sam.hiera.replace(fused_block_max_dim=32))
    cfg = UniGRConfig(qwen=q, sam2=sam,
                      seg=SegHeadConfig(out_dim=sam.d_model, seg_token_id=proc.seg_token_id))
    batch = make_batch(cfg, proc, args.seed, torch.device("cuda"))
    bwd_kernel = tatt.flash_attention_bwd
    report = {"card": torch.cuda.get_device_name(0)}
    for weights in ("learned", "random"):
        model = UniGR(cfg, device="cuda", dtype=torch.bfloat16)
        if weights == "learned":
            model.load_state_dict(torch_state_dict_from_flax(load_params_npz(args.npz)),
                                  strict=True)
        else:
            model.init_weights(torch.Generator("cuda").manual_seed(args.seed))
        mask = trainable_mask(model)
        params = {n: p for n, p in model.named_parameters() if mask[n]}
        logit_max = []
        hook = model.grounding_encoder.sam_mask_decoder.register_forward_hook(
            lambda _m, _i, out: logit_max.append(out[0].float().abs().max().item()))

        def loss_and_grads():
            for p in params.values():
                p.grad = None
            out = model.train_forward(**batch)
            out["loss"].backward()
            grads = {n: p.grad for n, p in params.items()}
            for p in params.values():
                p.grad = None
            return {k: v.item() for k, v in out.items()}, grads

        loss_k, grads_k = loss_and_grads()
        tatt.set_plain_attention(model, True)
        loss_p, grads_p = loss_and_grads()
        tatt.set_plain_attention(model, False)
        tatt.flash_attention_bwd = tatt.flash_attention_bwd_reference
        try:
            loss_b, grads_b = loss_and_grads()
        finally:
            tatt.flash_attention_bwd = bwd_kernel
        hook.remove()
        rels_p, glob_p = rel_l2(grads_k, grads_p)
        rels_b, glob_b = rel_l2(grads_k, grads_b)
        dec = [(r, n) for r, n in rels_p if ".sam_mask_decoder." in n]
        row = {
            "mask_logit_max": logit_max[0], "loss_kernel": loss_k, "loss_plain": loss_p,
            "grad_rel_l2_all": glob_p, "grad_rel_l2_all_bwd_plain": glob_b,
            "worst": rels_p[:3], "median": statistics.median(r for r, _ in rels_p),
            "decoder_worst": dec[:3], "decoder_median": statistics.median(r for r, _ in dec),
            "worst_bwd_plain": rels_b[:3], "tensors": len(rels_p),
        }
        report[weights] = row
        print(f"{weights} weights: max |low-res mask logit| {row['mask_logit_max']:.4f}; loss "
              f"kernel {loss_k['loss']:.6f} plain {loss_p['loss']:.6f} (mask bce "
              f"{loss_k['mask_bce_loss']:.6f} / {loss_p['mask_bce_loss']:.6f}); gradients vs "
              f"the plain route: all {glob_p:.3e}, median tensor {row['median']:.3e}, worst "
              + ", ".join(f"{n} {r:.3e}" for r, n in rels_p[:3])
              + f"; decoder median {row['decoder_median']:.3e}, worst "
              + ", ".join(f"{n} {r:.3e}" for r, n in dec[:3])
              + f"; vs the plain backward only: all {glob_b:.3e}, worst "
              + ", ".join(f"{n} {r:.3e}" for r, n in rels_b[:3]), flush=True)
        del model, params, grads_k, grads_p, grads_b
        torch.cuda.empty_cache()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
