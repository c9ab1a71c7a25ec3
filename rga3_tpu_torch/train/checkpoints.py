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
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

from ..utils import safetensors_io

STATE_FILE = "state.safetensors"


def state_tensors(state) -> Dict[str, torch.Tensor]:
    """{checkpoint name: tensor} of a `TrainState`'s trainable state."""
    opt = state.opt
    out = {}
    for name in opt.params:
        out[("master." if name in opt.master else "param.") + name] = opt.value(name)
        out["mu." + name] = opt.mu[name]
        out["nu." + name] = opt.nu[name]
    return out


class CheckpointManager:
    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
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
        """Write the state's trainable tensors under `tag`; returns the
        bytes written."""
        path = self._file(tag)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        meta = {"count": state.opt.count, "step": state.step}
        return safetensors_io.save_file(state_tensors(state), path, metadata=meta)

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
        """Load `tag` into `state` in place (the tensors onto their own
        devices, the parameters of master tensors rounded from them) and
        return it."""
        path = self._file(tag)
        header, _ = safetensors_io.read_header(path)
        want = state_tensors(state)
        problems = sorted(set(header) ^ set(want))[:5]
        for name in sorted(set(header) & set(want)):
            e, t = header[name], want[name]
            dtype = safetensors_io.DTYPES[e["dtype"]][1]
            if list(e["shape"]) != list(t.shape) or dtype != t.dtype:
                problems.append(f"{name}: {e['dtype']} {e['shape']} in the file, "
                                f"{t.dtype} {list(t.shape)} in the state")
        if problems:
            raise ValueError(f"{path} does not match the train state: {problems[:5]}")
        for name, t in safetensors_io.iter_file(path):
            want[name].copy_(t)
        opt = state.opt
        for name, master in opt.master.items():
            opt.params[name].copy_(master)
        meta = safetensors_io.read_metadata(path)
        opt.count, state.step = int(meta["count"]), int(meta["step"])
        return state

    def has(self, tag: str) -> bool:
        return os.path.isfile(self._file(tag))

    # -- epoch bookkeeping ----------------------------------------------
    def save_epoch(self, state, epoch: int, metric: Optional[float] = None,
                   higher_is_better: bool = True) -> bool:
        """Save latest; save best when `metric` improves. Returns is_best."""
        self.save("latest", state)
        meta = self.read_meta()
        meta["last_epoch"] = epoch
        is_best = False
        if metric is not None:
            best = meta.get("best_metric")
            is_best = best is None or (metric > best if higher_is_better else metric < best)
            if is_best:
                meta["best_metric"] = metric
                meta["best_epoch"] = epoch
                self._link("latest", "best")
            meta.setdefault("history", []).append({"epoch": epoch, "metric": metric})
        self.write_meta(meta)
        return is_best

    def resume_epoch(self) -> int:
        """The epoch to resume from (0 if nothing was saved)."""
        meta = self.read_meta()
        if self.has("latest") and meta.get("last_epoch") is not None:
            return int(meta["last_epoch"]) + 1
        return 0
