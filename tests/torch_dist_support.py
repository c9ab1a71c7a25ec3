"""Gloo ranks for the port's multi-rank tests, spawned as processes of their
own. This module imports no JAX: a spawned process runs without the tests'
conftest, and the workers need torch and the port only.

`run_ranks(fn, world, *args)` (or `Ranks(...)`, then `.results()`, to work
meanwhile) starts `world` processes on a free localhost port; each joins
the process group through `rga3_tpu_torch.parallel.init_distributed(...,
device="cpu")`, returns `fn(rank, *args)` (a function of this module), and
tears its group down. A rank that fails raises here with its traceback; the
other ranks are killed, so that nothing waits on a collective that will
never come.

Run as a script, `python tests/torch_dist_support.py OUT -- ARGV...` runs
the train CLI's `main(ARGV)` (`python -m rga3_tpu_torch.train`) and writes
`OUT.<rank>.json`: each step's aux, the val metric the rank saw, rank 0's
val scores, its rows, the epoch it started at, how many checkpoint files it
wrote, and a checksum of its trainable state.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import socket
import traceback
from typing import Any, Callable, Dict, List

import numpy as np

TIMEOUT = 300.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, fn: Callable, args: tuple, out) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    try:
        from rga3_tpu_torch.parallel import init_distributed

        init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
        out.put((rank, "ok", fn(rank, *args)))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """`world` gloo ranks running `fn(rank, *args)` in the background;
    `results()` waits for them."""

    def __init__(self, fn: Callable, world: int, *args, timeout: float = TIMEOUT):
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.out = ctx.Queue()
        port = free_port()
        self.procs = [ctx.Process(target=_entry, args=(r, world, port, fn, args, self.out),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self) -> List[Any]:
        results: Dict[int, Any] = {}
        try:
            while len(results) < self.world:
                try:
                    rank, status, value = self.out.get(timeout=self.timeout)
                except queue_mod.Empty:
                    missing = sorted(set(range(self.world)) - set(results))
                    raise TimeoutError(f"ranks {missing} gave no result in {self.timeout} s") \
                        from None
                if status != "ok":
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                results[rank] = value
        finally:
            self.close()
        return [results[r] for r in range(self.world)]

    def close(self) -> None:
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def run_ranks(fn: Callable, world: int, *args, timeout: float = TIMEOUT) -> List[Any]:
    """[fn(rank, *args) for each rank], each run in a gloo rank of its own."""
    return Ranks(fn, world, *args, timeout=timeout).results()


# ---------------------------------------------------------------------------
# the train step over a mesh (tests/test_torch_parallel.py)
# ---------------------------------------------------------------------------

def train_run(cfg, sd, train_kw, mesh_cfg, micro_batches, global_rows, steps=3,
              optax_state=None):
    """`steps` train steps of the port's UniGR (`cfg`, f32, state dict `sd`)
    on `micro_batches` (this rank's rows of each global micro-batch of
    `global_rows` rows) over the mesh of `mesh_cfg` (None: no mesh). Returns
    the per-step aux, the final trainable tensors (whole), whether every
    frozen tensor kept its bits (gathered whole where the mesh shards it),
    and the train state."""
    import torch

    from rga3_tpu_torch.config import TrainConfig
    from rga3_tpu_torch.models.unigr import UniGR
    from rga3_tpu_torch.parallel import make_mesh
    from rga3_tpu_torch.parallel.distributed import all_reduce
    from rga3_tpu_torch.train.step import build_train_step, make_train_state

    model = UniGR(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    mesh = make_mesh(mesh_cfg) if mesh_cfg is not None else None
    accum = len(micro_batches)
    state, opt = make_train_state(TrainConfig(**train_kw, grad_accum_steps=accum), model,
                                  mesh=mesh)
    if optax_state is not None:
        from rga3_tpu_torch.convert import load_optax_state

        load_optax_state(opt, optax_state)
    replicas, group = 1, None
    if mesh is not None:
        _, axes = mesh.rows(global_rows)
        replicas, group = mesh.replicas(axes), mesh.row_group(axes)
    reduce = None if group is None else (lambda t: all_reduce(t, group))

    def loss_fn(m, mb):
        return m.train_forward(*(torch.as_tensor(mb[k]) for k in BATCH_KEYS),
                               pixel_patches=torch.as_tensor(mb["pixel_patches"]),
                               vision_layout={k: torch.as_tensor(v)
                                              for k, v in mb["vision_layout"].items()},
                               reduce=reduce)

    step = build_train_step(loss_fn, opt, grad_accum_steps=accum, replicas=replicas,
                            aux_reduce=reduce)
    trace = []
    for _ in range(steps):
        state, aux = step(state, micro_batches)
        trace.append({k: float(v) for k, v in aux.items()})
    plan = getattr(model, "shard_plan", None)

    def whole(n, p):
        return p.detach().clone() if plan is None else plan.whole(n, p.detach())

    trainable = {n: whole(n, p) for n, p in model.named_parameters() if p.requires_grad}
    frozen_kept = all([torch.equal(whole(n, p), sd[n]) for n, p in model.named_parameters()
                       if not p.requires_grad])
    return trace, trainable, frozen_kept, state


BATCH_KEYS = ("input_ids", "labels", "position_ids", "segment_ids", "images_sam", "gt_masks",
              "masks_valid")


def digest(tensors) -> int:
    """A checksum of the tensors' bits (equal tensors, equal checksums)."""
    import torch

    total = 0
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().reshape(-1)
        bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32).to(torch.int64)
        weights = torch.arange(bits.numel(), dtype=torch.int64) % 65521 + 1
        total = (total * 1000003 + int((bits * weights).sum())) % (1 << 61)
    return total


def checkpoint_round_trip(job, sd, state, out_dir: str) -> Dict[str, Any]:
    """The sharded state saved (rank 0 writes the whole tensors) and restored
    into a fresh model and optimizer over the same mesh: the checksums of
    the whole state before and after, and of the restored model's
    trainable parameters."""
    import torch

    from rga3_tpu_torch.config import TrainConfig
    from rga3_tpu_torch.models.unigr import UniGR
    from rga3_tpu_torch.train import checkpoints
    from rga3_tpu_torch.train.step import make_train_state

    ck = checkpoints.CheckpointManager(os.path.join(out_dir, "ckpt"))
    ck.save_epoch(state, 0)
    saved = digest(checkpoints.state_tensors(state))
    model = UniGR(job["cfg"], device="cpu")
    model.load_state_dict(sd, strict=True)
    fresh, _ = make_train_state(TrainConfig(**job["train"]), model, mesh=state.opt.mesh)
    ck.restore("latest", fresh)
    return {"saved": saved, "restored": digest(checkpoints.state_tensors(fresh)),
            "params": digest({n: p for n, p in model.named_parameters() if p.requires_grad}),
            "count": fresh.opt.count, "step": fresh.step}


def train_ranks(rank: int, path: str, out_dir: str) -> Dict[str, Any]:
    """Every configuration of the pickled job at `path` on this rank: each
    run's aux trace, its frozen check and its trainable tensors' checksum;
    rank 0 also saves the trainable tensors under `out_dir`; the run named
    `job["checkpoint"]` goes through a checkpoint round trip. Then, over 2
    ranks, the meter, the broadcast and the row split of the parallel
    helpers."""
    import torch
    import torch.distributed as dist

    from rga3_tpu_torch.config import MeshConfig
    from rga3_tpu_torch.parallel import (
        broadcast_scalar, host_local_slice, make_mesh, put_global, replicate_to_host,
    )
    from rga3_tpu_torch.utils.meters import AverageMeter

    with open(path, "rb") as f:
        job = pickle.load(f)
    sd = torch.load(job["sd"])
    out: Dict[str, Any] = {}
    for run in job["runs"]:
        trace, trainable, frozen_kept, state = train_run(
            job["cfg"], sd, job["train"], MeshConfig(**run["mesh"]), run["batches"][rank],
            run["rows"])
        opt = state.opt
        # this rank's blocks gathered whole on the host are the parameters
        gathered = replicate_to_host({n: opt.value(n) for n in opt.params}, opt.dims,
                                     opt.mesh.group("fsdp"))
        out[run["name"]] = {"trace": trace, "frozen_kept": frozen_kept,
                            "digest": digest(trainable),
                            "gathered": all(torch.equal(gathered[n],
                                                        opt.tensor_block(n, trainable[n]))
                                            for n in trainable),
                            "sharded": sorted(n for n, d in opt.dims.items() if d is not None)}
        if rank == 0:
            torch.save(trainable, os.path.join(out_dir, f"{run['name']}.pt"))
        if run["name"] == job.get("checkpoint"):
            out["checkpoint"] = checkpoint_round_trip(job, sd, state, out_dir)
    out["world"] = dist.get_world_size()
    if out["world"] != 2:
        return out
    meter = AverageMeter("loss")
    for v in ([1.0, 2.0, 3.0] if rank == 0 else [10.0]):
        meter.update(v)
    meter.all_reduce()
    mesh = make_mesh(MeshConfig(data=2))
    out["meter"] = (meter.sum, meter.count, meter.avg)
    out["broadcast"] = (broadcast_scalar(3.5 + rank), broadcast_scalar(None if rank == 0 else 1.0))
    out["rows"] = (put_global(mesh, np.arange(6)).tolist(), host_local_slice(mesh, 6),
                   mesh.rows(3))
    return out


# ---------------------------------------------------------------------------
# sharded greedy generation (tests/test_torch_sharded_generate.py)
# ---------------------------------------------------------------------------

def sharded_qwen(cfg, sd, mesh, tree=None):
    """The port's Qwen2.5-VL of `cfg` (f32) cut to this rank's blocks over
    `mesh` on the meta device, each block then loaded from the whole
    state dict `sd` one leaf at a time (or from the flax tree `tree`,
    through `convert.load_flax_tree`)."""
    from rga3_tpu_torch.convert import load_flax_tree
    from rga3_tpu_torch.models.qwen25vl.model import Qwen25VL
    from rga3_tpu_torch.parallel import shard_model

    model = Qwen25VL(cfg, device="meta")
    plan = shard_model(model, mesh, device="cpu")
    if tree is not None:
        load_flax_tree(model, tree)
        return model.eval()
    for name in plan.blocks:
        plan.load_(model, name, sd[name])
    return model.eval()


def generate_ranks(rank: int, path: str) -> Dict[str, Any]:
    """Each job of the pickled list at `path` ({name, mesh, cfg, sd (a
    path), kw, spec}) on this rank: greedy tokens and per-step logits (the
    whole vocabulary) of the sharded model, and with `spec` the speculative
    greedy tokens with the model as its own draft; a job whose mesh the port
    cannot compute gives its ValueError's text."""
    import torch

    from rga3_tpu_torch.config import MeshConfig
    from rga3_tpu_torch.models.qwen25vl.generate import (
        greedy_generate, speculative_greedy_generate,
    )
    from rga3_tpu_torch.parallel import make_mesh

    with open(path, "rb") as f:
        jobs = pickle.load(f)
    out: Dict[str, Any] = {}
    for job in jobs:
        cfg = MeshConfig(**job["mesh"])
        if cfg.data * cfg.fsdp * cfg.tensor != torch.distributed.get_world_size():
            continue
        mesh = make_mesh(cfg)
        tree = None
        if "tree" in job:
            with open(job["tree"], "rb") as f:
                tree = pickle.load(f)
        try:
            model = sharded_qwen(job["cfg"], torch.load(job["sd"]), mesh, tree)
        except ValueError as e:
            out[job["name"]] = {"error": str(e)}
            continue
        kw = {k: torch.as_tensor(v) for k, v in job["kw"].items() if k != "gen"}
        kw.update(job["kw"]["gen"])
        tokens, logits = greedy_generate(model, **kw, return_logits=True,
                                         suppress_ids=job.get("suppress", ()))
        rec = {"tokens": tokens.numpy(), "logits": logits.numpy(), "mesh": mesh.shape,
               "kv_heads": model.lm.kv_heads,
               "held": sum(t.numel() for t in model.state_dict().values())}
        if tree is not None:  # the reverse gathers the whole tree
            from rga3_tpu_torch.convert import _flatten, flax_tree_from_torch

            back, want = _flatten(flax_tree_from_torch(model)), _flatten(tree)
            rec["tree_back"] = set(back) == set(want) and all(
                np.array_equal(back[k], want[k]) for k in want)
        if "rows" in job:  # the first down_proj on this rank's block of the input
            from rga3_tpu_torch.models.qwen25vl.language import row_linear
            from rga3_tpu_torch.parallel.fsdp import gathered

            layer = model.lm.model.layers_0
            lin = layer.mlp.down_proj
            x = torch.from_numpy(job["rows"])
            cols = slice(lin.tp.index * x.shape[-1] // lin.tp.size,
                         (lin.tp.index + 1) * x.shape[-1] // lin.tp.size)
            with torch.no_grad(), gathered(layer):
                rec["rows"] = row_linear(lin, x[..., cols].contiguous()).numpy()
        if job.get("spec"):
            one = {k: (v[:1] if k not in ("position_ids",) else v[:, :1])
                   for k, v in kw.items() if isinstance(v, torch.Tensor)}
            rest = {k: v for k, v in kw.items() if not isinstance(v, torch.Tensor)}
            rec["spec"] = speculative_greedy_generate(model, model, **one, **rest,
                                                      k=3)[0].numpy()
            rec["greedy_row0"] = greedy_generate(model, **one, **rest).numpy()
        out[job["name"]] = rec
    return out


# ---------------------------------------------------------------------------
# the train step over the tensor axis (tests/test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------

def tensor_train_ranks(rank: int, path: str, out_dir: str) -> Dict[str, Any]:
    """The pickled job's runs at this world size ({name, mesh, batches (a
    list a rank), rows}): each run's aux trace, frozen check, trainable
    tensors' checksum and what it shards (rank 0 saves the trainable tensors
    under `out_dir`), and what `sync_grads` makes of gradients that differ
    on every rank; the run named `job["checkpoint"]` saved by rank 0
    under `out_dir/ckpt` with the checksum of its whole state. With
    `job["restore"]` (a checkpoint directory), the state restored over this
    world's mesh instead, and its checksums. Then the mesh's groups."""
    import torch
    import torch.distributed as dist

    from rga3_tpu_torch.config import MeshConfig, TrainConfig
    from rga3_tpu_torch.models.unigr import UniGR
    from rga3_tpu_torch.parallel import make_mesh
    from rga3_tpu_torch.train import checkpoints
    from rga3_tpu_torch.train.step import make_train_state

    with open(path, "rb") as f:
        job = pickle.load(f)
    sd = torch.load(job["sd"])
    world = dist.get_world_size()
    out: Dict[str, Any] = {}
    for run in job["runs"]:
        cfg = MeshConfig(**run["mesh"])
        if cfg.data * cfg.fsdp * cfg.tensor != world:
            continue
        if "restore" in run:
            model = UniGR(job["cfg"], device="cpu")
            model.load_state_dict(sd, strict=True)
            state, _ = make_train_state(TrainConfig(**job["train"]), model,
                                        mesh=make_mesh(cfg))
            checkpoints.CheckpointManager(run["restore"]).restore("latest", state)
            plan = model.shard_plan
            out[run["name"]] = {
                "restored": digest(checkpoints.state_tensors(state)),
                "params": digest({n: plan.whole(n, p) for n, p in model.named_parameters()
                                  if p.requires_grad}),
                "count": state.opt.count, "step": state.step}
            continue
        trace, trainable, frozen_kept, state = train_run(
            job["cfg"], sd, job["train"], cfg, run["batches"][rank], run["rows"])
        opt = state.opt
        out[run["name"]] = {
            "trace": trace, "frozen_kept": frozen_kept, "digest": digest(trainable),
            "tensor_sharded": sorted(opt.tensor_sharded), "partial": sorted(opt.partial),
            "fsdp_sharded": sorted(n for n, d in opt.dims.items() if d is not None),
            "frozen_fsdp": sum(b.fsdp_stored for b in state.model.shard_plan.blocks.values())}
        if rank == 0:
            torch.save(trainable, os.path.join(out_dir, f"{run['name']}.pt"))
        if run["name"] == job.get("checkpoint"):
            checkpoints.CheckpointManager(os.path.join(out_dir, "ckpt")).save_epoch(state, 0)
            out["saved"] = digest(checkpoints.state_tensors(state))
        # gradients that differ on every rank (rank + 1 everywhere) through
        # sync_grads: the values each tensor then holds
        opt.zero_grad()
        for p in opt.params.values():
            p.grad = torch.full_like(p, rank + 1.0)
        opt.sync_grads(cfg.tensor)
        out[run["name"]]["synced"] = {n: sorted(set(g.flatten().tolist()))
                                      for n, g in opt.synced.items()}
        opt.zero_grad()
    mesh = make_mesh(MeshConfig(tensor=world))
    groups = {}
    for axis in ("data", "fsdp", "tensor", "replica"):
        g = mesh.groups.get(axis)
        groups[axis] = None if g is None else dist.get_process_group_ranks(g)
    out["groups"] = {"coords": mesh.coords, **groups}
    return out


def cli_main(out: str, argv: List[str]) -> None:
    import json

    import torch
    import torch.distributed as dist

    from rga3_tpu_torch.train import __main__ as cli
    from rga3_tpu_torch.train import checkpoints

    torch.set_num_threads(2)
    writes = []
    real_save = checkpoints.safetensors_io.save_file

    def counted_save(*args, **kwargs):
        writes.append(args[1])
        return real_save(*args, **kwargs)

    checkpoints.safetensors_io.save_file = counted_save
    summary = cli.main(argv)
    tensors = checkpoints.state_tensors(summary["state"])
    rank = dist.get_rank() if dist.is_initialized() else 0
    record = {
        "steps": [st["aux"] for st in summary["steps"]],
        "flops": [st["flops"] for st in summary["steps"]],
        "val_metric": summary["val_metric"], "val": [v[1] for v in summary["val"]],
        "rows": summary["rows"], "start_epoch": summary["start_epoch"], "writes": len(writes),
        "digest": str(digest(tensors)), "mesh": summary["mesh"].shape,
    }
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(record, f)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    import sys

    cli_main(sys.argv[1], sys.argv[3:])
