"""Train UniGR on one card, counterpart of `scripts/train.py`:

    python -m rga3_tpu_torch.train --model_dir <Qwen2.5-VL dir | dummy> \
        [--sam_pretrained sam2_hiera_large.pt] --dataset_dir ./data \
        --config configs/release_7b.json [--device cpu]

The hybrid dataset mixture (`data.datasets`), prefetched by worker threads
in index order; `--grad_accum_steps` micro-batches of `--micro_batch_size`
samples per step, padded across micro-batches to one length; masked AdamW
with warmup then cosine (`train.optimizer`), with f32 masters of the
trainable tensors under `--param_dtype float32` (the model computes in
bf16, except the SAM2 mask decoder and `text_hidden_fcs`, which are held
and computed in f32 there, as JAX's f32 parameters promote them);
the LM's activations under `--remat` ("dots" keeps the weight
products' outputs); a ReasonSeg-val gIoU / cIoU after each epoch;
checkpoints with auto-resume (`train.checkpoints`). `--config` is a JSON
file of flag values, which flags given on the command line override.

`--model_dir dummy` builds the parameters `scripts/train.py` builds from
nothing: every leaf drawn from a numpy generator seeded with the crc32 of
its flax path (`assemble_params`). The JAX script stacks the 3B / 7B
decoder layers (scan), which renames their paths; the port does not scan,
so at those sizes it draws each layer from its per-layer path
(`qwen/lm/model/layers_<i>/...`), the tiny config's layout.

Each step logs its model FLOPs (`utils.flops.unigr_train_step_flops`
over its micro-batches) and, on the card, its MFU against the card's bf16
peak (`utils.profiling`). `--profile_dir` records a torch.profiler trace of
the run there (`utils.profiling.trace`); the JAX script parses the flag and
never reads it. The mesh and multi-host flags of the JAX script are not
ported.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import SegHeadConfig, TrainConfig
from ..convert import flax_path_and_shape, torch_leaf
from ..data.collate import collate
from ..data.datasets import ImgVidHybridDataset
from ..data.prefetch import PrefetchLoader
from ..data.processor import QwenVLProcessor
from ..device import resolve_device
from ..models.qwen25vl.loader import load_qwen25vl_state_dict
from ..models.sam2.config import Sam2Config, tiny_sam2_config
from ..models.sam2.loader import load_sam2_state_dict
from ..models.unigr.build import QWEN_SIZES, qwen_config
from ..models.unigr.model import UniGR, UniGRConfig
from ..utils.flops import unigr_train_step_flops
from ..utils.meters import AverageMeter, ProgressMeter
from ..utils.profiling import annotate, mfu, trace
from .checkpoints import CheckpointManager
from .optimizer import DEFAULT_TRAINABLE_PATTERNS
from .step import build_train_step, make_train_state

PAD_ID = 151643
METERS = ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss")


def _check_u8(frames: np.ndarray) -> np.ndarray:
    """SAM frames reach the model as uint8, which it normalizes on the
    device; a float array here means raw pixels were cast on the host."""
    if frames.dtype != np.uint8:
        raise TypeError(f"images_sam dtype {frames.dtype}: the data layer emits uint8 SAM "
                        "frames; do not cast them on the host")
    return frames


@torch.no_grad()
def assemble_params(model: torch.nn.Module, loaded: Optional[Dict[str, torch.Tensor]] = None,
                    workers: int = 8, keep: Callable[[str], bool] = lambda key: False,
                    skip: Callable[[str], bool] = lambda key: False) -> Dict[str, torch.Tensor]:
    """Fill `model` in place: each state-dict entry from `loaded` (a state
    dict of pretrained tensors) where it has one of the same shape, else as
    `scripts/train.py`'s `assemble_params` draws the flax leaf: zeros for
    LoRA B and biases, ones for `scale` / `g_weight`, otherwise
    N(0, 0.02) from `np.random.default_rng(crc32(flax path))` in float64,
    cast to f32, then to the model's dtype. Leaves are drawn on `workers`
    threads (numpy's generators release the GIL). Entries that `skip`
    selects are left as they are (a resumed run restores them). Returns the
    f32 draws of the entries `keep` selects, on the host (what the model
    holds rounded, where its dtype is narrower)."""
    loaded = loaded or {}
    kept: Dict[str, torch.Tensor] = {}
    todo = []
    for key, t in model.state_dict().items():
        src = loaded.get(key)
        if src is not None and tuple(src.shape) == tuple(t.shape):
            t.copy_(src)
        elif not skip(key):
            todo.append((key, t))

    def draw(item):
        key, t = item
        path, shape = flax_path_and_shape(model, key, tuple(t.shape))
        leaf = path[-1]
        if leaf.endswith("lora_b") or "bias" in leaf:
            t.zero_()
        elif leaf in ("scale", "g_weight"):
            t.fill_(1.0)
        else:
            rng = np.random.default_rng(zlib.crc32("/".join(path).encode()))
            x = rng.normal(0, 0.02, shape).astype(np.float32)
            x = torch.from_numpy(np.ascontiguousarray(torch_leaf(path, x)))
            t.copy_(x)
            if keep(key):
                kept[key] = x

    with ThreadPoolExecutor(max(1, workers)) as ex:
        list(ex.map(draw, todo))
    return kept


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_dir", required=True,
                   help="HF Qwen2.5-VL dir (weights + tokenizer), or 'dummy'")
    p.add_argument("--sam_pretrained", default=None, help="sam2_hiera_large.pt path")
    p.add_argument("--dataset_dir", default="./data")
    p.add_argument("--ckpt_dir", default="runs/unigr")
    p.add_argument("--model_size", choices=list(QWEN_SIZES), default="7b")
    p.add_argument("--dataset", default="sem_seg,refer_seg,vqa,reason_seg")
    p.add_argument("--sample_rates", default="9,3,3,1")
    p.add_argument("--remat", choices=["full", "dots", "none"], default="dots",
                   help="LM activation strategy: dots keeps the weight products' outputs, "
                   "full recomputes whole layers (least memory)")
    p.add_argument("--epochs", type=int, default=80)
    p.add_argument("--steps_per_epoch", type=int, default=100)
    p.add_argument("--micro_batch_size", type=int, default=2)
    p.add_argument("--grad_accum_steps", type=int, default=8)
    p.add_argument("--lr", type=float, default=4e-5)
    p.add_argument("--lora_r", type=int, default=128)
    p.add_argument("--lora_alpha", type=float, default=256.0)
    p.add_argument("--num_frames_mllm", type=int, default=8)
    p.add_argument("--num_frames_sam", type=int, default=4)
    p.add_argument("--mask_res", type=int, default=256)
    p.add_argument("--ce_loss_weight", type=float, default=1.0)
    p.add_argument("--dice_loss_weight", type=float, default=0.5)
    p.add_argument("--bce_loss_weight", type=float, default=2.0)
    p.add_argument("--auto_resume", action="store_true", default=True)
    p.add_argument("--no_auto_resume", dest="auto_resume", action="store_false")
    p.add_argument("--precision", default="bfloat16")
    p.add_argument("--param_dtype", choices=["float32", "bfloat16"], default="float32",
                   help="storage of the trainable tensors: float32 keeps f32 masters beside "
                   "the bf16 model; bfloat16 updates the bf16 tensors directly")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--data_workers", type=int, default=2,
                   help="prefetch threads (0 = synchronous); batches are the same either way")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the run's steps here")
    p.add_argument("--no_eval", action="store_true",
                   help="skip the per-epoch ReasonSeg-val gIoU/cIoU loop")
    p.add_argument("--val_at_start", action="store_true",
                   help="also run the val loop before step 0")
    p.add_argument("--val_samples", type=int, default=200)
    p.add_argument("--loss_log", default=None, help="write per-step loss JSON here")
    p.add_argument("--config", default=None, help="JSON config file; CLI flags override")
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = p.parse_args(argv)
    if args.config:
        with open(args.config) as f:
            overrides = json.load(f)
        for k, v in overrides.items():
            if k.startswith("_"):
                continue
            if hasattr(args, k) and f"--{k}" not in argv:
                setattr(args, k, v)
    return args


def build(args, device: torch.device, resuming: bool = False):
    """(the UniGR of `args`, bf16, its parameters from `--model_dir` /
    `--sam_pretrained` and `assemble_params`; its processor; under
    `--param_dtype float32` the f32 draws of the trainable tensors, and the
    SAM2 mask decoder and `text_hidden_fcs` held in f32).
    `resuming`: the trainable tensors are not drawn (the checkpoint holds
    them)."""
    proc = QwenVLProcessor.from_pretrained(args.model_dir)
    qcfg = qwen_config(args.model_size)
    qcfg = qcfg.replace(text=qcfg.text.replace(lora_rank=args.lora_r,
                                               lora_alpha=args.lora_alpha))
    scfg = tiny_sam2_config() if args.model_size == "tiny" else Sam2Config()
    cfg = UniGRConfig(qwen=qcfg, sam2=scfg, seg=SegHeadConfig(
        out_dim=scfg.d_model, seg_token_id=proc.seg_token_id,
        ce_loss_weight=args.ce_loss_weight, dice_loss_weight=args.dice_loss_weight,
        bce_loss_weight=args.bce_loss_weight))
    model = UniGR(cfg, device=device, dtype=torch.bfloat16, remat=args.remat)
    if args.param_dtype == "float32":
        # JAX's f32 parameters promote these modules' bf16 inputs to f32;
        # cast before the draws, which then land in f32 unrounded
        model.grounding_encoder.sam_mask_decoder.float()
        model.text_hidden_fcs.float()
    loaded: Dict[str, torch.Tensor] = {}
    if args.model_dir != "dummy":
        print("loading pretrained weights...", flush=True)
        try:
            loaded.update(("qwen." + k, v) for k, v in
                          load_qwen25vl_state_dict(args.model_dir, torch.bfloat16).items())
        except FileNotFoundError:
            print("no checkpoint found: random-initializing the LLM", flush=True)
    if args.sam_pretrained:
        loaded.update(("grounding_encoder." + k, v) for k, v in
                      load_sam2_state_dict(args.sam_pretrained).items())
    def trainable(key):
        return any(pat in key for pat in DEFAULT_TRAINABLE_PATTERNS)

    t0 = time.perf_counter()
    # the trainable tensors' f32 draws start their masters
    masters = assemble_params(
        model, loaded, workers=min(8, os.cpu_count() or 1),
        keep=lambda key: args.param_dtype == "float32" and trainable(key),
        skip=lambda key: resuming and trainable(key))
    del loaded
    print(f"params assembled in {time.perf_counter() - t0:.1f}s", flush=True)
    return model, proc, masters


class AccumBatches:
    """`make_accum_batch(batch_idx)` of the JAX script: the global samples
    of one accumulation batch collated into micro-batches and padded to one
    text length and gt-mask size, stacked on a leading micro-batch axis.
    `seconds[batch_idx]` is the host time it took."""

    def __init__(self, dataset, proc, cfg, args, start_epoch: int):
        self.dataset, self.proc, self.cfg, self.args = dataset, proc, cfg, args
        self.offset = start_epoch * args.steps_per_epoch  # the resume offset
        self.micro = args.micro_batch_size
        # static vision budget: the per-frame patch cap (video pixel budget /
        # 14^2) x temporal groups x micro-batch, in merge units
        per_frame_patches = (320 * 28 * 28) // (14 * 14)
        budget = self.micro * max(args.num_frames_mllm // 2, 1) * per_frame_patches
        self.vision_budget = -(-budget // 4) * 4
        self.seconds: Dict[int, float] = {}

    def __call__(self, batch_idx: int) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        args, micro = self.args, self.micro
        batch_idx += self.offset
        micro_batches = []
        for a in range(args.grad_accum_steps):
            base = (batch_idx * args.grad_accum_steps + a) * micro
            samples = [self.dataset.sample_global(base + r) for r in range(micro)]
            c = collate(samples, self.proc, self.cfg.qwen, vision_budget_tokens=self.vision_budget)
            mb = {
                "input_ids": c["input_ids"],
                "labels": c["labels"],
                "position_ids": c["position_ids"],
                "segment_ids": c["attention_mask"].astype(np.int32),
                "images_sam": _check_u8(c["images_sam"]),
                "gt_masks": c["gt_masks"],
                "masks_valid": c["masks_valid"],
            }
            if "pixel_patches" in c:
                mb["pixel_patches"] = c["pixel_patches"]
                for k, v in c["vision_layout"].items():
                    mb[f"vl_{k}"] = v
            micro_batches.append(mb)
        # pad the text length and the gt masks across micro-batches
        max_l = max(m["input_ids"].shape[1] for m in micro_batches)
        max_gh = max(m["gt_masks"].shape[2] for m in micro_batches)
        max_gw = max(m["gt_masks"].shape[3] for m in micro_batches)
        for m in micro_batches:
            pad = max_l - m["input_ids"].shape[1]
            if pad > 0:
                m["input_ids"] = np.pad(m["input_ids"], ((0, 0), (0, pad)),
                                        constant_values=PAD_ID)
                m["labels"] = np.pad(m["labels"], ((0, 0), (0, pad)), constant_values=-100)
                m["segment_ids"] = np.pad(m["segment_ids"], ((0, 0), (0, pad)))
                m["position_ids"] = np.pad(m["position_ids"], ((0, 0), (0, 0), (0, pad)))
            gh, gw = m["gt_masks"].shape[2:]
            if gh < max_gh or gw < max_gw:
                m["gt_masks"] = np.pad(m["gt_masks"],
                                       ((0, 0), (0, 0), (0, max_gh - gh), (0, max_gw - gw)))
        batch = {k: np.stack([m[k] for m in micro_batches]) for k in micro_batches[0]}
        self.seconds[batch_idx] = time.perf_counter() - t0
        return batch


def stage(batch: Dict[str, np.ndarray], device: torch.device) -> List[Dict[str, Any]]:
    """An accumulation batch -> its micro-batches as `train_forward`'s
    keyword arguments on `device`."""
    out = []
    for a in range(batch["input_ids"].shape[0]):
        mb: Dict[str, Any] = {}
        layout = {}
        for k, v in batch.items():
            t = torch.as_tensor(v[a], device=device)
            if k.startswith("vl_"):
                layout[k[3:]] = t
            else:
                mb[k] = t
        if layout:
            mb["vision_layout"] = layout
        out.append(mb)
    return out


def step_flops(cfg, micro_batches: List[Dict[str, Any]]) -> float:
    """Model FLOPs of one step over `micro_batches` (`stage`'s output)."""
    total = 0.0
    for mb in micro_batches:
        b, seq = mb["input_ids"].shape
        patches = mb["pixel_patches"].shape[0] if "pixel_patches" in mb else 0
        total += unigr_train_step_flops(cfg, b, seq, mb["images_sam"].shape[1], patches)
    return total


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None,
         on_restore: Optional[Callable[[Any], None]] = None) -> Dict[str, Any]:
    """Run the training of `argv` (the flags above). `on_restore(state)` is
    called right after an auto-resume has restored the state. Returns a
    summary: the `state`, per step the aux scalars and the accumulation
    batch index, seconds (step, forward / backward / optimizer, the wait on
    the loader, host seconds per accumulation batch), val scores and
    seconds, checkpoint seconds and bytes, and the last step's micro-batches
    (on the device)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ckpt = CheckpointManager(args.ckpt_dir)
    start_epoch = ckpt.resume_epoch() if args.auto_resume else 0
    model, proc, masters = build(args, device, resuming=start_epoch > 0)
    cfg = model.cfg

    train_ds = ImgVidHybridDataset(
        args.dataset_dir,
        datasets=args.dataset.split(","),
        sample_rates=[float(x) for x in str(args.sample_rates).split(",")],
        samples_per_epoch=args.steps_per_epoch * args.grad_accum_steps * args.micro_batch_size,
        num_frames_mllm=args.num_frames_mllm,
        num_frames_sam=args.num_frames_sam,
        mask_res=args.mask_res,
        sam_size=cfg.sam2.image_size,
    )
    tcfg = TrainConfig(
        lr=args.lr, epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        micro_batch_size=args.micro_batch_size, grad_accum_steps=args.grad_accum_steps,
        lora_r=args.lora_r, lora_alpha=args.lora_alpha, ckpt_dir=args.ckpt_dir,
        remat=args.remat,
    )
    master = torch.float32 if args.param_dtype == "float32" else None
    state, opt = make_train_state(tcfg, model, master_dtype=master, master_init=masters)
    del masters
    step_fn = build_train_step(lambda m, mb: m.train_forward(**mb), opt,
                               grad_accum_steps=args.grad_accum_steps, timed=True)
    summary: Dict[str, Any] = {
        "state": state, "steps": [], "val": [], "save": [], "restore": None,
        "trainable": sum(p.numel() for p in opt.params.values()),
    }

    summary["start_epoch"] = start_epoch
    if start_epoch > 0:
        print(f"resuming from epoch {start_epoch}", flush=True)
        t0 = time.perf_counter()
        ckpt.restore("latest", state)
        _sync(device)
        summary["restore"] = (time.perf_counter() - t0, os.path.getsize(ckpt._file("latest")))
        if on_restore is not None:
            on_restore(state)

    writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(os.path.join(args.ckpt_dir, "tb"))
    except ImportError:
        pass

    make_accum_batch = AccumBatches(train_ds, proc, cfg, args, start_epoch)
    # buffer_size 2: an accumulation batch of 1024^2 SAM frames is hundreds
    # of MB of host memory
    loader = PrefetchLoader(make_accum_batch, num_workers=args.data_workers, buffer_size=2)

    def run_val(label) -> Optional[float]:
        """ReasonSeg-val gIoU / cIoU; None when the split is not on disk. A
        failure inside val (a missing label file, the model) raises."""
        from ..evaluation.image_seg_eval import reason_seg_images, run_reason_seg_val
        from ..evaluation.segmentor import UniGRSegmentor

        if not reason_seg_images(args.dataset_dir):
            print("val skipped: no ReasonSeg val split", flush=True)
            return None
        t0 = time.perf_counter()
        seg = UniGRSegmentor(model, proc, num_frames_mllm=args.num_frames_mllm)
        scores = run_reason_seg_val(seg, args.dataset_dir, max_samples=args.val_samples)
        _sync(device)
        summary["val"].append((label, scores, time.perf_counter() - t0))
        print(f"val {label}: {scores}", flush=True)
        if writer and isinstance(label, int):
            writer.add_scalar("val/gIoU", scores["gIoU"], label)
            writer.add_scalar("val/cIoU", scores["cIoU"], label)
        return scores["gIoU"]

    global_step = start_epoch * args.steps_per_epoch
    loss_trace = []
    try:
        if args.val_at_start and not args.no_eval:
            run_val("step0")
        with trace(args.profile_dir, "train"):
            for epoch in range(start_epoch, args.epochs):
                meters = {k: AverageMeter(k) for k in METERS}
                t_epoch = time.perf_counter()
                for it in range(args.steps_per_epoch):
                    t0 = time.perf_counter()
                    batch = next(loader)
                    wait = time.perf_counter() - t0
                    micro_batches = stage(batch, device)
                    t1 = time.perf_counter()
                    with annotate(f"step {global_step}"):
                        state, aux = step_fn(state, micro_batches)
                    aux = {k: float(v) for k, v in aux.items()}
                    _sync(device)
                    seconds = time.perf_counter() - t1
                    flops = step_flops(cfg, micro_batches)
                    summary["steps"].append({
                        "batch_idx": global_step, "aux": aux, "seconds": seconds,
                        "phases": dict(step_fn.seconds), "loader_wait": wait,
                        "host": make_accum_batch.seconds.get(global_step), "flops": flops,
                        "mfu": mfu(flops, seconds) if device.type == "cuda" else None,
                    })
                    summary["last_micro_batches"] = micro_batches
                    for k, m in meters.items():
                        m.update(aux[k])
                    global_step += 1
                    if args.loss_log:
                        loss_trace.append(aux["loss"])
                    if it % args.log_every == 0:
                        ProgressMeter(args.steps_per_epoch, list(meters.values()),
                                      prefix=f"epoch {epoch} ").display(it)
                        st = summary["steps"][-1]
                        util = "n/a (CPU)" if st["mfu"] is None else f"{st['mfu']:.4f}"
                        print(f"step {st['batch_idx']}: {st['flops'] / 1e12:.3f} TFLOP in "
                              f"{st['seconds']:.3f} s, MFU {util}", flush=True)
                        if writer:
                            for k, m in meters.items():
                                writer.add_scalar(f"train/{k}", m.val, global_step)
                print(f"epoch {epoch} done in {time.perf_counter() - t_epoch:.0f}s", flush=True)
                metric = None if args.no_eval else run_val(epoch)
                t0 = time.perf_counter()
                is_best = ckpt.save_epoch(state, epoch, metric=metric)
                summary["save"].append((time.perf_counter() - t0,
                                        os.path.getsize(ckpt._file("latest"))))
                if is_best:
                    print(f"epoch {epoch}: new best", flush=True)
    finally:
        loader.close()
    if args.loss_log:
        with open(args.loss_log, "w") as f:
            json.dump({"loss": loss_trace}, f)
    summary["peak_bytes"] = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                             else None)
    print("training complete", flush=True)
    return summary


if __name__ == "__main__":
    main()
