"""Checkpoints of a training run, counterpart of
`rga3_tpu/train/checkpoints.py` with the JAX package's semantics and the
port's own file format:

  * `<ckpt_dir>/ckpt_latest/` and `ckpt_best/` each hold `state.safetensors`:
    every trainable tensor (its f32 master where `MaskedAdamW` keeps one,
    as `master.<name>`, else the parameter, as `param.<name>`), Adam's
    `mu.<name>` and `nu.<name>`, and in the metadata the optimizer's
    `count` and the state's `step`. Frozen weights are not saved: the
    entry point rebuilds them from its flags;
  * `meta_log_info.json`: `best_metric`, `best_epoch`, `history` (epoch,
    metric) and `last_epoch`;
  * `save_epoch` writes latest, and best when the metric improves
    (`higher_is_better`), returning whether it did; `resume_epoch` is the
    epoch after the last saved one (0 when latest or its epoch is missing);
  * a file is written under a temporary name and renamed into place, so an
    interrupted save leaves the previous checkpoint readable; best is a
    hard link to the latest file it copies;
  * `restore` raises ValueError when the file's names, shapes or dtypes
    differ from the state's.

Over a mesh of ranks (`MaskedAdamW` sharded over fsdp, `embed_tokens` and
`lm_head` over tensor) the file is the same: whole tensors. Every rank
gathers the blocks together (over fsdp, then tensor), rank 0 writes the
file, the meta and the best link, and a `barrier` holds the others until it
has. Every rank restores by reading the file and taking its own blocks, so a
checkpoint written at one (data, fsdp, tensor) resumes at any other.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

from ..parallel.distributed import barrier, is_main
from ..utils import safetensors_io

STATE_FILE = "state.safetensors"


def _names(opt):
    """(checkpoint name, parameter name, kind) of every saved tensor."""
    for name in opt.params:
        yield ("master." if name in opt.master else "param.") + name, name, "value"
        yield "mu." + name, name, "mu"
        yield "nu." + name, name, "nu"


def _local(opt, name: str, kind: str) -> torch.Tensor:
    """This rank's block (or the whole) of a saved tensor."""
    return {"value": opt.value, "mu": opt.mu.get, "nu": opt.nu.get}[kind](name)


def state_tensors(state) -> Dict[str, torch.Tensor]:
    """{checkpoint name: whole tensor} of a `TrainState`'s trainable state
    (gathered over fsdp and tensor where the optimizer shards it: every
    rank calls it together)."""
    opt = state.opt
    return {key: opt.whole(name, _local(opt, name, kind)) for key, name, kind in _names(opt)}


class CheckpointManager:
    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        if is_main():
            os.makedirs(self.ckpt_dir, exist_ok=True)
        self.meta_path = os.path.join(self.ckpt_dir, "meta_log_info.json")

    # -- meta -----------------------------------------------------------
    def read_meta(self) -> Dict[str, Any]:
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                return json.load(f)
        return {"best_metric": None, "best_epoch": None, "history": []}

    def write_meta(self, meta: Dict[str, Any]) -> None:
        tmp = self.meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(tmp, self.meta_path)

    # -- save / restore -------------------------------------------------
    def _file(self, tag: str) -> str:
        return os.path.join(self.ckpt_dir, f"ckpt_{tag}", STATE_FILE)

    def save(self, tag: str, state) -> int:
        """Write the state's trainable tensors under `tag` (rank 0, after
        every rank has gathered its blocks; the others wait for the file);
        returns the bytes written, on every rank."""
        path = self._file(tag)
        tensors = state_tensors(state)
        nbytes = 0
        if is_main():
            os.makedirs(os.path.dirname(path), exist_ok=True)
            meta = {"count": state.opt.count, "step": state.step}
            nbytes = safetensors_io.save_file(tensors, path, metadata=meta)
        barrier()
        return nbytes or os.path.getsize(path)

    def _link(self, src_tag: str, dst_tag: str) -> None:
        """`dst_tag` becomes the file of `src_tag` (a hard link, or a copy
        where the file system has none)."""
        src, dst = self._file(src_tag), self._file(dst_tag)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = dst + ".tmp"
        if os.path.exists(tmp):
            os.remove(tmp)
        try:
            os.link(src, tmp)
        except OSError:
            shutil.copyfile(src, tmp)
        os.replace(tmp, dst)

    @torch.no_grad()
    def restore(self, tag: str, state):
        """Load `tag` into `state` in place (this rank's blocks onto their
        own devices, the parameters of master tensors rounded from them) and
        return it."""
        path = self._file(tag)
        header, _ = safetensors_io.read_header(path)
        opt = state.opt
        want = {key: (name, kind) for key, name, kind in _names(opt)}
        problems = sorted(set(header) ^ set(want))[:5]
        for key in sorted(set(header) & set(want)):
            name, kind = want[key]
            e, t = header[key], _local(opt, name, kind)
            dtype = safetensors_io.DTYPES[e["dtype"]][1]
            shape = list(t.shape)  # the whole tensor's, of this rank's block
            if opt.dims[name] is not None:
                shape[opt.dims[name]] *= opt.mesh.shape["fsdp"]
            if name in opt.tensor_sharded:
                shape = list(opt.plan.blocks[name].full_shape)
            if list(e["shape"]) != shape or dtype != t.dtype:
                problems.append(f"{key}: {e['dtype']} {e['shape']} in the file, "
                                f"{t.dtype} {shape} in the state")
        if problems:
            raise ValueError(f"{path} does not match the train state: {problems[:5]}")
        for key, t in safetensors_io.iter_file(path):
            name, kind = want[key]
            t = opt.tensor_block(name, t)
            if kind != "value":
                _local(opt, name, kind).copy_(opt.shard(name, t))
                continue
            if name in opt.master:
                opt.master[name].copy_(opt.shard(name, t))
            opt.params[name].copy_(t)  # whole over fsdp, rounded from its master
        meta = safetensors_io.read_metadata(path)
        opt.count, state.step = int(meta["count"]), int(meta["step"])
        return state

    def has(self, tag: str) -> bool:
        return os.path.isfile(self._file(tag))

    # -- epoch bookkeeping ----------------------------------------------
    def save_epoch(self, state, epoch: int, metric: Optional[float] = None,
                   higher_is_better: bool = True) -> bool:
        """Save latest; save best when `metric` improves (every rank calls it
        with the same metric; rank 0 writes). Returns is_best."""
        self.save("latest", state)
        meta = self.read_meta()
        barrier()  # every rank has read the meta before rank 0 rewrites it
        meta["last_epoch"] = epoch
        is_best = False
        if metric is not None:
            best = meta.get("best_metric")
            is_best = best is None or (metric > best if higher_is_better else metric < best)
            if is_best:
                meta["best_metric"] = metric
                meta["best_epoch"] = epoch
                if is_main():
                    self._link("latest", "best")
            meta.setdefault("history", []).append({"epoch": epoch, "metric": metric})
        if is_main():
            self.write_meta(meta)
        barrier()
        return is_best

    def resume_epoch(self) -> int:
        """The epoch to resume from (0 if nothing was saved)."""
        meta = self.read_meta()
        if self.has("latest") and meta.get("last_epoch") is not None:
            return int(meta["last_epoch"]) + 1
        return 0
