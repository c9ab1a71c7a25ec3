"""Train UniGR on one card or across ranks, counterpart of `scripts/train.py`:

    python -m rga3_tpu_torch.train --model_dir <Qwen2.5-VL dir | dummy> \
        [--sam_pretrained sam2_hiera_large.pt] --dataset_dir ./data \
        --config configs/release_7b.json [--device cpu]
    torchrun --nproc_per_node 8 -m rga3_tpu_torch.train ... [--mesh_data 1 --mesh_fsdp 0]
    python -m rga3_tpu_torch.train ... --coordinator_address host:port \
        --num_processes N --process_id i

The hybrid dataset mixture (`data.datasets`), prefetched by worker threads
in index order; `--grad_accum_steps` micro-batches of `--micro_batch_size`
samples per step, padded across micro-batches to one length; masked AdamW
with warmup then cosine (`train.optimizer`), with f32 masters of the
trainable tensors under `--param_dtype float32` (the model computes in
bf16, except SAM2, `text_hidden_fcs` and the LM's embedding and head,
which are held and computed in f32 there, as JAX's f32 parameters promote
them: `hold_f32`);
the LM's activations under `--remat` ("dots" keeps the weight
products' outputs); a ReasonSeg-val gIoU / cIoU after each epoch;
checkpoints with auto-resume (`train.checkpoints`). `--config` is a JSON
file of flag values, which flags given on the command line override.

`--model_dir dummy` builds the parameters `scripts/train.py` builds from
nothing: every leaf drawn from a numpy generator seeded with the crc32 of
its flax path (`assemble_params`). At 3B / 7B the LM's config scans its
layers, as the JAX script's does, so each decoder leaf is the stacked
`qwen/lm/model/layers_scan/layer/...` draw (layer by layer from its one
generator); the port's modules stay per layer.

Each step logs its model FLOPs (`utils.flops.unigr_train_step_flops`
over its micro-batches) and, on the card, its MFU against the card's bf16
peak (`utils.profiling`). `--profile_dir` records a torch.profiler trace of
the run there (`utils.profiling.trace`); the JAX script parses the flag and
never reads it.

Across ranks (the JAX script's mesh and multi-host flags, or torchrun's
environment; `parallel.init_distributed`: NCCL on `cuda:<local rank>`, gloo
under `--device cpu`) the ranks form a (data, fsdp, tensor) mesh
(`--mesh_fsdp 0`: the ranks left). As in the JAX script, an epoch holds
`data` times the samples and a global micro-batch `data` x
`--micro_batch_size` rows; each rank collates only its rows of it
(`parallel.put_global` of the global indices, `batch_axes`' split over
data and fsdp; every tensor rank of a row holder takes its rows, and every
rank every row when the ranks do not divide them), with the vision budget
of its rows. The model is built on the meta device and cut to the rank's
blocks (`parallel.fsdp.shard_model`: the LM tensor-parallel over
`--mesh_tensor`, every frozen leaf of a gathered block over fsdp), then
each leaf is drawn, or read from `--model_dir` (tensor by tensor from
safetensors shards, a torch .bin file at a time), whole on the host and
only the rank's block kept (`load_pretrained`), so no rank holds the whole
base; `--sam_pretrained` is read whole (0.9 GB in f32 at Hiera-L). The losses are normalised over the
global micro-batch (`train_forward(reduce=...)`), the gradients summed over
the ranks once a step, and the trainable state sharded over fsdp (ZeRO-2,
`MaskedAdamW`). Rank 0 logs, writes `--loss_log`, TensorBoard and the
checkpoints (whole tensors, gathered over fsdp and tensor), and reports
the val loop, whose metric it broadcasts so that every rank agrees on
"best"; with a sharded model every rank runs the val loop with it (the
sharded layers compute together), otherwise rank 0 alone. MFU is each
rank's FLOPs (its rows; over `--mesh_tensor`, its share of the LM) against
one card's peak.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..config import MeshConfig, SegHeadConfig, TrainConfig
from ..convert import flax_path_and_shape, scan_position, torch_leaf
from ..data.collate import collate
from ..data.datasets import ImgVidHybridDataset
from ..data.prefetch import PrefetchLoader
from ..data.processor import QwenVLProcessor
from ..device import resolve_device
from ..models.qwen25vl.loader import iter_qwen25vl_state
from ..models.sam2.config import Sam2Config, tiny_sam2_config
from ..models.sam2.loader import load_sam2_state_dict
from ..models.unigr.build import QWEN_SIZES, qwen_config
from ..models.unigr.model import UniGR, UniGRConfig
from ..parallel.distributed import (
    all_reduce, broadcast_scalar, init_distributed, is_main, put_global, rank0_print,
    rank_device, world_size,
)
from ..parallel.fsdp import shard_model
from ..parallel.mesh import make_mesh
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
def load_pretrained(model: torch.nn.Module,
                    entries: Iterable[Tuple[str, torch.Tensor]]) -> Set[str]:
    """Copy each (state-dict key, whole tensor) of `entries` that `model`
    has at that whole shape into it, one entry at a time (a model cut by
    `shard_model` keeps the rank's block), so that a generator of entries
    is never held whole. Returns the keys copied."""
    plan = getattr(model, "shard_plan", None)
    state = model.state_dict()
    done = set()
    for key, src in entries:
        t = state.get(key)
        if t is None:
            continue
        if plan is None and tuple(src.shape) == tuple(t.shape):
            t.copy_(src)
        elif plan is not None and tuple(src.shape) == plan.blocks[key].full_shape:
            plan.load_(model, key, src)
        else:
            continue
        done.add(key)
    return done


@torch.no_grad()
def assemble_params(model: torch.nn.Module, loaded: Optional[Dict[str, torch.Tensor]] = None,
                    workers: int = 8, keep: Callable[[str], bool] = lambda key: False,
                    skip: Callable[[str], bool] = lambda key: False) -> Dict[str, torch.Tensor]:
    """Fill `model` in place: each state-dict entry from `loaded` (a state
    dict of pretrained tensors) where it has one of the same shape, else as
    `scripts/train.py`'s `assemble_params` draws the flax leaf: zeros for
    LoRA B and biases, ones for `scale` / `g_weight`, otherwise
    N(0, 0.02) from `np.random.default_rng(crc32(flax path))` in float64,
    cast to f32, then to the model's dtype. A layer the JAX package stacks
    (`convert.scan_position`: the LM at 3B / 7B, whose layers the JAX
    script scans) has the stacked leaf's path and generator, drawn one
    layer after another: a generator's normal stream does not depend on how
    the draw is chunked, so layer i gets the stacked draw's values at index
    i, and the host holds a layer at a time. Leaves are drawn on `workers`
    threads (numpy's generators release the GIL), each layer's conversion
    and copy to the model on `workers` more. Entries that `skip` selects
    are left as they are (a resumed run restores them). A model cut by
    `shard_model` keeps the rank's block of each whole leaf. Returns the f32
    draws of the entries `keep` selects (the rank's tensor block), on the
    host (what the model holds rounded, where its dtype is narrower)."""
    plan = getattr(model, "shard_plan", None)
    kept: Dict[str, torch.Tensor] = {}
    done = load_pretrained(model, (loaded or {}).items())

    def local(key, x):
        return x if plan is None else plan.local(key, x)

    # flax path -> (one layer's flax shape, layers, {layer index: (key, tensor)})
    groups: Dict[tuple, Tuple[tuple, int, Dict[int, Tuple[str, torch.Tensor]]]] = {}
    for key, t in model.state_dict().items():
        if key in done or skip(key):
            continue
        whole = tuple(t.shape) if plan is None else plan.blocks[key].full_shape
        path, shape = flax_path_and_shape(model, key, whole)
        pos = scan_position(model, key)
        index, count = (pos[1], pos[2]) if pos is not None else (0, 1)
        groups.setdefault(path, (shape, count, {}))[2][index] = (key, t)

    def write(path, key, t, x32):
        x = torch.from_numpy(np.ascontiguousarray(torch_leaf(path, x32)))
        t.copy_(local(key, x))
        if keep(key):
            kept[key] = x if plan is None else plan.tensor_block(key, x).clone()

    def draw(item, convert):
        path, (shape, count, entries) = item
        leaf = path[-1]
        if leaf.endswith("lora_b") or "bias" in leaf or leaf in ("scale", "g_weight"):
            for _, t in entries.values():
                t.fill_(0.0 if leaf not in ("scale", "g_weight") else 1.0)
            return
        rng = np.random.default_rng(zlib.crc32("/".join(path).encode()))
        buf = np.empty(shape)
        pending = []
        for i in range(max(entries) + 1):
            # = rng.normal(0, 0.02, shape): loc + scale * the standard draw
            rng.standard_normal(out=buf)
            np.multiply(buf, 0.02, out=buf)
            buf += 0.0
            if i in entries:
                pending.append(convert.submit(write, path, *entries[i], buf.astype(np.float32)))
                while len(pending) > 2:  # a few layers in flight
                    pending.pop(0).result()
        for f in pending:
            f.result()

    n = max(1, workers)
    with ThreadPoolExecutor(n) as convert, ThreadPoolExecutor(n) as ex:
        # the longest draws first
        items = sorted(groups.items(), key=lambda kv: -math.prod(kv[1][0]) * kv[1][1])
        list(ex.map(lambda item: draw(item, convert), items))
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
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_fsdp", type=int, default=0, help="0 = all remaining ranks")
    p.add_argument("--mesh_tensor", type=int, default=1,
                   help="the LM's tensor-parallel ranks (heads, MLP columns, vocabulary)")
    # the launch of several processes (torchrun's environment works too);
    # also read from COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of process 0 (joins the ranks' process group)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
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
    p.add_argument("--loss_log", default=None, help="write per-step loss JSON here (rank 0)")
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


def hold_f32(model) -> None:
    """Hold in f32 the modules whose outputs JAX's f32 parameters make f32
    (`tests/probe_f32_modules.py dtypes`): the whole of SAM2 (the frozen
    image encoder, its Hiera trunk and neck on the f32 kernels, and the
    trained mask decoder), `text_hidden_fcs`, and the LM's embedding and
    `lm_head`, whose f32 parameters promote their bf16 inputs (the
    embedding's rows are cast to the decoder's bf16, as JAX casts them).
    Called before the draws, which then land in f32 unrounded; a trainable
    tensor already in f32 is its own master in `MaskedAdamW`: at 7B the
    embedding and the head are 152064 x 3584 x 4 B = 2.18 GB each, where a
    bf16 copy and its f32 master held 3.27 GB each."""
    model.grounding_encoder.float()
    model.text_hidden_fcs.float()
    lm = model.qwen.lm
    lm.embed_tokens.float()
    if not lm.cfg.tie_word_embeddings:
        lm.lm_head.float()


def build(args, device: torch.device, resuming: bool = False, mesh=None):
    """(the UniGR of `args`, bf16, its parameters from `--model_dir` /
    `--sam_pretrained` and `assemble_params`; its processor; under
    `--param_dtype float32` the f32 draws of the trainable tensors, and
    SAM2, `text_hidden_fcs` and the LM's embedding and head held in f32,
    `hold_f32`).
    `resuming`: the trainable tensors are not drawn (the checkpoint holds
    them). Over a `mesh` of more than one rank the model is built on the
    meta device and cut to this rank's blocks on `device` first."""
    proc = QwenVLProcessor.from_pretrained(args.model_dir)
    qcfg = qwen_config(args.model_size)
    # the JAX script scans the big models' layers: their draws follow the
    # stacked paths
    qcfg = qcfg.replace(text=qcfg.text.replace(lora_rank=args.lora_r,
                                               lora_alpha=args.lora_alpha,
                                               scan_layers=args.model_size != "tiny"))
    scfg = tiny_sam2_config() if args.model_size == "tiny" else Sam2Config()
    cfg = UniGRConfig(qwen=qcfg, sam2=scfg, seg=SegHeadConfig(
        out_dim=scfg.d_model, seg_token_id=proc.seg_token_id,
        ce_loss_weight=args.ce_loss_weight, dice_loss_weight=args.dice_loss_weight,
        bce_loss_weight=args.bce_loss_weight))
    sharded = mesh is not None and mesh.size > 1
    model = UniGR(cfg, device="meta" if sharded else device, dtype=torch.bfloat16,
                  remat=args.remat)
    if args.param_dtype == "float32":
        hold_f32(model)
    def trainable(key):
        return any(pat in key for pat in DEFAULT_TRAINABLE_PATTERNS)

    if sharded:
        shard_model(model, mesh, trainable=trainable, device=device)

    def pretrained():
        n = 0
        if args.model_dir != "dummy":
            rank0_print("loading pretrained weights...")
            try:
                for k, v in iter_qwen25vl_state(args.model_dir, torch.bfloat16):
                    n += 1
                    yield "qwen." + k, v
            except FileNotFoundError:
                if n:  # a shard of a checkpoint that was found is missing
                    raise
                rank0_print("no checkpoint found: random-initializing the LLM")
        if args.sam_pretrained:
            yield from (("grounding_encoder." + k, v) for k, v in
                        load_sam2_state_dict(args.sam_pretrained).items())

    t0 = time.perf_counter()
    done = load_pretrained(model, pretrained())
    # the trainable tensors' f32 draws start their masters
    masters = assemble_params(
        model, workers=min(8, os.cpu_count() or 1),
        keep=lambda key: args.param_dtype == "float32" and trainable(key),
        skip=lambda key: key in done or (resuming and trainable(key)))
    rank0_print(f"params assembled in {time.perf_counter() - t0:.1f}s")
    return model, proc, masters


class AccumBatches:
    """`make_accum_batch(batch_idx)` of the JAX script: this rank's samples
    of one accumulation batch (its `rows` of each global micro-batch of
    `micro` rows) collated into micro-batches and padded to one text length
    and gt-mask size, stacked on a leading micro-batch axis.
    `seconds[batch_idx]` is the host time it took."""

    def __init__(self, dataset, proc, cfg, args, start_epoch: int, micro: int = None,
                 rows: Sequence[int] = None):
        self.dataset, self.proc, self.cfg, self.args = dataset, proc, cfg, args
        self.offset = start_epoch * args.steps_per_epoch  # the resume offset
        self.micro = micro or args.micro_batch_size
        self.rows = list(range(self.micro)) if rows is None else list(rows)
        # static vision budget: the per-frame patch cap (video pixel budget /
        # 14^2) x temporal groups x this rank's rows, in merge units
        per_frame_patches = (320 * 28 * 28) // (14 * 14)
        budget = len(self.rows) * max(args.num_frames_mllm // 2, 1) * per_frame_patches
        self.vision_budget = -(-budget // 4) * 4
        self.seconds: Dict[int, float] = {}

    def __call__(self, batch_idx: int) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        args, micro = self.args, self.micro
        batch_idx += self.offset
        micro_batches = []
        for a in range(args.grad_accum_steps):
            base = (batch_idx * args.grad_accum_steps + a) * micro
            samples = [self.dataset.sample_global(base + r) for r in self.rows]
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


def step_flops(cfg, micro_batches: List[Dict[str, Any]], tensor: int = 1) -> float:
    """Model FLOPs of one step over `micro_batches` (`stage`'s output, this
    rank's rows): over a tensor axis of `tensor` ranks, this rank's share
    (`unigr_train_step_flops`)."""
    total = 0.0
    for mb in micro_batches:
        b, seq = mb["input_ids"].shape
        patches = mb["pixel_patches"].shape[0] if "pixel_patches" in mb else 0
        total += unigr_train_step_flops(cfg, b, seq, mb["images_sam"].shape[1], patches,
                                        tensor=tensor)
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
    seconds (rank 0's), the val metric every rank saw (`val_metric`),
    checkpoint seconds and bytes, the last step's micro-batches (on the
    device), the `mesh`, this rank's `rows` of a global micro-batch and the
    `step` function."""
    args = parse_args(argv)
    # join the ranks before anything else touches the card
    init_distributed(args.coordinator_address, args.num_processes, args.process_id,
                     device=args.device)
    device = rank_device() if torch.distributed.is_initialized() else resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    n_ranks = world_size()
    fsdp = args.mesh_fsdp or n_ranks // (args.mesh_data * args.mesh_tensor)
    mesh = make_mesh(MeshConfig(data=args.mesh_data, fsdp=fsdp, tensor=args.mesh_tensor))
    rank0_print(f"mesh: {mesh.shape} over {n_ranks} process(es)")
    # the JAX script's global micro-batch; this rank's rows of it, and the
    # sum over the ranks that hold its other rows (none where every rank
    # holds every row)
    micro = args.micro_batch_size * mesh.shape["data"]
    rows = put_global(mesh, np.arange(micro))
    _, axes = mesh.rows(micro)
    row_group = mesh.row_group(axes)
    reduce = None if row_group is None else (lambda t: all_reduce(t, row_group))

    ckpt = CheckpointManager(args.ckpt_dir)
    start_epoch = ckpt.resume_epoch() if args.auto_resume else 0
    model, proc, masters = build(args, device, resuming=start_epoch > 0, mesh=mesh)
    cfg = model.cfg

    train_ds = ImgVidHybridDataset(
        args.dataset_dir,
        datasets=args.dataset.split(","),
        sample_rates=[float(x) for x in str(args.sample_rates).split(",")],
        samples_per_epoch=args.steps_per_epoch * args.grad_accum_steps * micro,
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
    state, opt = make_train_state(tcfg, model, master_dtype=master, master_init=masters,
                                  mesh=mesh)
    del masters
    step_fn = build_train_step(lambda m, mb: m.train_forward(**mb, reduce=reduce), opt,
                               grad_accum_steps=args.grad_accum_steps, timed=True,
                               replicas=mesh.replicas(axes), aux_reduce=reduce)
    summary: Dict[str, Any] = {
        "state": state, "steps": [], "val": [], "val_metric": [], "save": [], "restore": None,
        "trainable": sum(p.numel() for p in opt.params.values()),
        "mesh": mesh, "rows": rows.tolist(), "step": step_fn,
    }

    summary["start_epoch"] = start_epoch
    if start_epoch > 0:
        rank0_print(f"resuming from epoch {start_epoch}")
        t0 = time.perf_counter()
        ckpt.restore("latest", state)
        _sync(device)
        summary["restore"] = (time.perf_counter() - t0, os.path.getsize(ckpt._file("latest")))
        if on_restore is not None:
            on_restore(state)

    writer = None
    if is_main():
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(os.path.join(args.ckpt_dir, "tb"))
        except ImportError:
            pass

    make_accum_batch = AccumBatches(train_ds, proc, cfg, args, start_epoch, micro, rows)
    # buffer_size 2: an accumulation batch of 1024^2 SAM frames is hundreds
    # of MB of host memory
    loader = PrefetchLoader(make_accum_batch, num_workers=args.data_workers, buffer_size=2)

    def rank0_val(label, report: bool = True) -> Optional[float]:
        """ReasonSeg-val gIoU / cIoU; None when the split is not on disk. A
        failure inside val (a missing label file, the model) raises.
        `report=False`: only the computation (another rank of a sharded
        model)."""
        from ..evaluation.image_seg_eval import reason_seg_images, run_reason_seg_val
        from ..evaluation.segmentor import UniGRSegmentor

        if not reason_seg_images(args.dataset_dir):
            if report:
                print("val skipped: no ReasonSeg val split", flush=True)
            return None
        t0 = time.perf_counter()
        seg = UniGRSegmentor(model, proc, num_frames_mllm=args.num_frames_mllm)
        scores = run_reason_seg_val(seg, args.dataset_dir, max_samples=args.val_samples)
        if not report:
            return None
        _sync(device)
        summary["val"].append((label, scores, time.perf_counter() - t0))
        print(f"val {label}: {scores}", flush=True)
        if writer and isinstance(label, int):
            writer.add_scalar("val/gIoU", scores["gIoU"], label)
            writer.add_scalar("val/cIoU", scores["cIoU"], label)
        return scores["gIoU"]

    plan = getattr(model, "shard_plan", None)
    # a model cut to blocks runs the val loop on every rank, together
    together = plan is not None and any(b.tensor is not None or b.fsdp_stored
                                        for b in plan.blocks.values())

    def run_val(label) -> Optional[float]:
        """Rank 0's val metric on every rank (the others wait for it, or run
        it with rank 0 where the model is sharded). A failure on rank 0
        raises there and, through an infinite metric, on every other rank."""
        metric = None
        if together and not is_main():
            rank0_val(label, report=False)
        if is_main():
            try:
                metric = rank0_val(label)
            except BaseException:
                broadcast_scalar(math.inf)
                raise
        metric = broadcast_scalar(metric)
        if metric == math.inf:
            raise RuntimeError(f"val {label} failed on rank 0")
        summary["val_metric"].append((label, metric))
        return metric

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
                    flops = step_flops(cfg, micro_batches, tensor=mesh.shape["tensor"])
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
                    if it % args.log_every == 0 and is_main():
                        ProgressMeter(args.steps_per_epoch, list(meters.values()),
                                      prefix=f"epoch {epoch} ").display(it)
                        st = summary["steps"][-1]
                        util = "n/a (CPU)" if st["mfu"] is None else f"{st['mfu']:.4f}"
                        print(f"step {st['batch_idx']}: {st['flops'] / 1e12:.3f} TFLOP in "
                              f"{st['seconds']:.3f} s, MFU {util}", flush=True)
                        if writer:
                            for k, m in meters.items():
                                writer.add_scalar(f"train/{k}", m.val, global_step)
                rank0_print(f"epoch {epoch} done in {time.perf_counter() - t_epoch:.0f}s")
                metric = None if args.no_eval else run_val(epoch)
                t0 = time.perf_counter()
                is_best = ckpt.save_epoch(state, epoch, metric=metric)
                summary["save"].append((time.perf_counter() - t0,
                                        os.path.getsize(ckpt._file("latest"))))
                if is_best:
                    rank0_print(f"epoch {epoch}: new best")
    finally:
        loader.close()
    if args.loss_log and is_main():
        with open(args.loss_log, "w") as f:
            json.dump({"loss": loss_trace}, f)
    summary["peak_bytes"] = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                             else None)
    rank0_print("training complete")
    return summary


if __name__ == "__main__":
    main()
