"""Sharded greedy generation over N ranks against one process, on the same
ids and the same seeded weights:

    python -m rga3_tpu_torch.tools.generate_ranks --nproc 4 --mesh_fsdp 2 \\
        --mesh_tensor 2 [--model_size 7b] [--layers 0] [--modes bf16 int4] \\
        [--batch 2] [--prompt 64] [--new 16] [--seed 0] [--out runs/generate_ranks] \\
        [--device cpu]

Every run builds the Qwen2.5-VL of `--model_size` (`--layers` > 0 cuts the
LM's depth; in bf16, in int4, or in f32 with the plain attention) on the
meta device, cuts it to the rank's blocks
(`parallel.fsdp.shard_model`; one process: whole) and fills it one leaf at
a time (`seeded_leaf`: each whole leaf drawn on the device from a generator
seeded by the seed and the crc32 of its name, the rank's block kept; in
int4 each LM projection drawn in float and quantized whole first, then
cut). It then runs `greedy_generate` on seeded ids and, under teacher
forcing, one forward without a cache over the prompt and the one-process
tokens (the logits at the generated positions, gathered whole). One
process runs first (`--nproc 1` of itself), then `--nproc` ranks
(`torch.distributed.run --standalone`: NCCL on one card a rank, gloo under
`--device cpu`) over (data 1, fsdp, tensor), PYTHONHASHSEED=0. Each rank
writes its tokens, logits, seconds, peak memory and resident bytes under
`--out`; the tool prints one JSON object with, per mode, the teacher-forced
logits' largest difference over max|logit| (`TOL` is the gate), the share
of steps whose one-process top-2 gap exceeds TOL, and the tokens' agreement
on those steps.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# bf16 over 28 layers: the teacher-forced logits of two meshes round their
# row-parallel sums in other orders (~one bf16 ulp of the largest logit a
# layer); a wrong block or head would be off by the order of the logits
TOL = 2e-2


def seeded_leaf(name: str, shape: Sequence[int], seed: int, device, dtype=torch.bfloat16,
                std: float = 0.02) -> torch.Tensor:
    """A whole leaf of the seeded weights: zeros for biases and LoRA B, ones
    for 1-d weights (the norms), otherwise N(0, std) from a generator on
    `device` seeded by `seed` and the crc32 of `name`."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias" or leaf.endswith("_lora_b"):
        return torch.zeros(shape, dtype=dtype, device=device)
    if leaf == "weight" and len(shape) == 1:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device).manual_seed((seed * 1_000_003 + zlib.crc32(name.encode()))
                                              % (1 << 62))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    out.normal_(0.0, std, generator=gen)
    return out.to(dtype)


@torch.no_grad()
def fill_seeded(model: torch.nn.Module, seed: int, device) -> None:
    """Fill a model cut by `shard_model` from the seeded weights, one whole
    leaf at a time; a `QuantLinear`'s buffers from its float weight's draw,
    quantized whole."""
    from ..models.qwen25vl.language import QuantLinear
    from ..ops.quant import quantize_int4, quantize_int8
    from ..parallel.fsdp import state_entries_one

    plan = model.shard_plan
    done = set()
    for path, mod in model.named_modules():
        if not isinstance(mod, QuantLinear):
            continue
        w = seeded_leaf(f"{path}.weight", (mod.out_features, mod.in_features), seed, device)
        q, s = quantize_int4(w.t()) if mod.bits == 4 else quantize_int8(w.t())
        names = ("kernel_q4", "scale_g") if mod.bits == 4 else ("kernel_q", "scale")
        for leaf, t in zip(names, (q, s)):
            plan.load_(model, f"{path}.{leaf}", t)
            done.add(f"{path}.{leaf}")
        del w, q, s
    for name, b in plan.blocks.items():
        if name in done:
            continue
        dtype = state_entries_one(model, name).dtype
        plan.load_(model, name, seeded_leaf(name, b.full_shape, seed, device, dtype))


def build_seeded(cfg, mesh, seed: int, device, bits: Optional[int] = None,
                 dtype=torch.bfloat16):
    """The seeded Qwen2.5-VL of `cfg` over `mesh` (the rank's blocks), its
    LM in int4 / int8 with `bits`."""
    from ..models.qwen25vl.model import Qwen25VL
    from ..parallel.fsdp import shard_model

    if bits:
        flag = {4: "quant_int4", 8: "quant_int8"}[bits]
        cfg = cfg.replace(text=cfg.text.replace(**{flag: True}))
    model = Qwen25VL(cfg, device="meta", dtype=dtype)
    shard_model(model, mesh, device=device)
    fill_seeded(model, seed, device)
    return model.eval()


def prompt_inputs(batch: int, length: int, seed: int, vocab: int) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(1, vocab - 1000, (batch, length)))
    pos = torch.arange(length)[None, None].expand(3, batch, length).contiguous()
    return {"input_ids": ids, "attention_mask": torch.ones(batch, length, dtype=torch.long),
            "position_ids": pos, "rope_deltas": torch.zeros(batch, dtype=torch.long)}


@torch.no_grad()
def teacher_forced(model, ids: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """f32 logits (B, new, V), whole, at the generated positions of one
    forward without a cache over the prompt and `tokens`."""
    from ..parallel.tensor import full_logits

    dev = model.device
    seq = torch.cat([ids.to(dev), tokens[:, :-1].to(dev)], 1)
    b, n = seq.shape
    pos = torch.arange(n, device=dev)[None, None].expand(3, b, n)
    out = model(seq, position_ids=pos)
    lg = out["logits"][:, ids.shape[1] - 1:].float()
    return full_logits(lg.contiguous(), model.lm)


def lm_config(model_size: str, layers: int):
    from ..models.unigr.build import qwen_config

    cfg = qwen_config(model_size)
    if layers:
        cfg = cfg.replace(text=cfg.text.replace(num_hidden_layers=layers))
    return cfg


def run_mode(cfg, mesh, mode: str, args, ref_tokens: Optional[torch.Tensor], device) -> Dict:
    """One mode's generation and teacher-forced logits on this rank."""
    from ..models.qwen25vl.generate import greedy_generate

    from ..ops.attention import set_plain_attention

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = build_seeded(cfg, mesh, args.seed, device, bits=4 if mode == "int4" else None,
                         dtype=torch.float32 if mode == "f32" else torch.bfloat16)
    if mode == "f32":  # the attention kernels take bf16: the plain versions
        set_plain_attention(model, True)
    built = time.perf_counter() - t0
    kw = prompt_inputs(args.batch, args.prompt, args.seed, cfg.text.vocab_size)
    stats: Dict[str, float] = {}
    tokens = greedy_generate(model, **kw, max_new_tokens=args.new, eos_token_id=-1,
                             pad_token_id=0, stats=stats)
    forced = teacher_forced(model, kw["input_ids"], tokens if ref_tokens is None else ref_tokens)
    held = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    out = {"tokens": tokens.cpu().numpy(), "logits": forced.cpu().numpy(),
           "build_s": built, "held_bytes": held, **stats,
           "peak_bytes": (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                          else None)}
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _worker(args) -> None:
    import torch.distributed as dist

    from ..config import MeshConfig
    from ..device import resolve_device
    from ..parallel import init_distributed, make_mesh
    from ..parallel.distributed import rank_device

    init_distributed(device=args.device)
    device = rank_device() if dist.is_initialized() else resolve_device(args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh(MeshConfig(data=1, fsdp=args.mesh_fsdp if world > 1 else 1,
                                tensor=args.mesh_tensor if world > 1 else 1))
    rank = dist.get_rank() if dist.is_initialized() else 0
    cfg = lm_config(args.model_size, args.layers)
    for mode in args.modes:
        ref = None
        if world > 1:
            ref = torch.as_tensor(np.load(os.path.join(args.out, "one", f"{mode}.rank0.npz"))
                                  ["tokens"])
        rec = run_mode(cfg, mesh, mode, args, ref, device)
        sub = os.path.join(args.out, "one" if world == 1 else "many")
        os.makedirs(sub, exist_ok=True)
        np.savez(os.path.join(sub, f"{mode}.rank{rank}.npz"), tokens=rec.pop("tokens"),
                 logits=rec.pop("logits"))
        with open(os.path.join(sub, f"{mode}.rank{rank}.json"), "w") as f:
            json.dump({**rec, "mesh": mesh.shape, "device": str(device)}, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def compare(one: Dict[str, np.ndarray], many: Dict[str, np.ndarray], tol: float = TOL) -> Dict:
    """The teacher-forced logits' largest difference over max|logit| of the
    step, and their picks' agreement where the one-process top-2 gap
    exceeds `tol` x max|logit| (both read the one-process tokens; the
    ranks' own greedy tokens part from them after a close step)."""
    ref, got = one["logits"], many["logits"]
    scale = np.abs(ref).max(-1, keepdims=True)
    err = float((np.abs(got - ref) / scale).max())
    top2 = np.sort(ref, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > tol * scale[..., 0]
    same = got.argmax(-1) == ref.argmax(-1)
    return {"max_err": err, "within_tol": err <= tol, "clear_steps": float(clear.mean()),
            "picks_equal_where_clear": bool(same[clear].all()),
            "greedy_tokens_equal": bool((one["tokens"] == many["tokens"]).all())}


def _run(args, argv: List[str], nproc: int) -> None:
    env = dict(os.environ, PYTHONHASHSEED="0")
    own = [sys.executable, "-m", "rga3_tpu_torch.tools.generate_ranks", "--worker", *argv]
    if nproc > 1:
        own = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={nproc}", "-m", "rga3_tpu_torch.tools.generate_ranks",
               "--worker", *argv]
    subprocess.run(own, env=env, check=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--mesh_fsdp", type=int, default=1)
    p.add_argument("--mesh_tensor", type=int, default=2)
    p.add_argument("--model_size", default="7b")
    p.add_argument("--layers", type=int, default=0, help="cut the LM to this depth (0: whole)")
    p.add_argument("--modes", nargs="+", default=["bf16", "int4"], choices=["bf16", "int4", "f32"],
                   help="f32: the float model in f32 with the plain attention (no kernel), "
                   "to separate the meshes' arithmetic from bf16's rounding")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--prompt", type=int, default=64)
    p.add_argument("--new", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/generate_ranks")
    p.add_argument("--device", default=None)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.worker:
        _worker(args)
        return {}
    # the workers take the run's flags but `--nproc`, which torchrun's own
    # parser would read as an abbreviation of `--nproc-per-node`
    rest = [a for i, a in enumerate(argv) if a != "--worker" and a != "--nproc"
            and not (i and argv[i - 1] == "--nproc") and not a.startswith("--nproc=")]
    _run(args, rest, 1)
    _run(args, rest, args.nproc)
    report = {"nproc": args.nproc, "mesh": {"fsdp": args.mesh_fsdp, "tensor": args.mesh_tensor},
              "model_size": args.model_size, "layers": args.layers, "modes": {}}
    def load(sub, mode, rank):
        with np.load(os.path.join(args.out, sub, f"{mode}.rank{rank}.npz")) as z:
            return dict(z)

    def info(sub, mode, rank):
        with open(os.path.join(args.out, sub, f"{mode}.rank{rank}.json")) as f:
            return json.load(f)

    for mode in args.modes:
        one = load("one", mode, 0)
        ranks = [compare(one, load("many", mode, r)) for r in range(args.nproc)]
        report["modes"][mode] = {"ranks": ranks, "one": info("one", mode, 0),
                                 "many": [info("many", mode, r) for r in range(args.nproc)]}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
