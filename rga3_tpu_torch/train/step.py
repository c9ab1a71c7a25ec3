"""The train step: gradient accumulation over micro-batches, then one masked
AdamW update. Counterpart of `rga3_tpu/train/step.py`, on one card or over a
mesh of ranks (`parallel.make_mesh`):

    state, opt = make_train_state(cfg, model, mesh=mesh)
    step = build_train_step(loss_fn, opt, grad_accum_steps, replicas=r, aux_reduce=f)
    state, aux = step(state, micro_batches)

`loss_fn(model, micro_batch)` returns a dict with "loss" (and any other
scalars); `micro_batches` is a sequence of `grad_accum_steps` micro-batches.
The gradients of the micro-batches are summed (in each parameter's `.grad`,
or in f32 beside it for a tensor with an f32 master) and divided by their
count; the aux dict of the last micro-batch is
returned, detached. Over a mesh each rank runs its rows of every
micro-batch (`loss_fn` returning its rows' share of the global losses);
the gradients are summed over the ranks once a step
(`MaskedAdamW.sync_grads`, divided by `replicas`, the ranks that hold each
row), and `aux_reduce` sums the last micro-batch's aux over the ranks that
hold its other rows, so that every rank returns the global losses.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..config import TrainConfig
from .optimizer import MaskedAdamW, build_optimizer


@dataclass
class TrainState:
    model: nn.Module
    opt: MaskedAdamW
    step: int = 0


def make_train_state(cfg: TrainConfig, model: nn.Module, master_dtype: torch.dtype = None,
                     master_init: Dict[str, torch.Tensor] = None, mesh=None
                     ) -> Tuple[TrainState, MaskedAdamW]:
    """Mark the trainable parameters and build the optimizer over them
    (`MaskedAdamW`'s masters in `master_dtype`, from `master_init`; its
    state sharded over `mesh`'s fsdp axis). Over a mesh the model is cut to
    the rank's blocks first (`parallel.fsdp.shard_model`: the frozen
    weights over fsdp, the LM over tensor), unless it was cut already."""
    opt = build_optimizer(cfg, model, master_dtype, master_init, mesh=mesh)
    return TrainState(model, opt), opt


def build_train_step(loss_fn: Callable[[nn.Module, Any], Dict[str, torch.Tensor]],
                     opt: MaskedAdamW, grad_accum_steps: int = 1, timed: bool = False,
                     replicas: int = 1,
                     aux_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """The step function `(state, micro_batches) -> (state, aux)`.

    With `timed`, the device is synchronized around each phase and
    `step.seconds` holds the last step's forward, backward and optimizer
    seconds (forward and backward summed over the micro-batches; the
    optimizer's include its "collectives": the aux and gradient
    reductions)."""
    params = list(opt.params.values())

    def sync():
        if timed and params and params[0].is_cuda:
            torch.cuda.synchronize(params[0].device)

    def step(state: TrainState, micro_batches: Sequence[Any]):
        if len(micro_batches) != grad_accum_steps:
            raise ValueError(f"{len(micro_batches)} micro-batches for "
                             f"grad_accum_steps={grad_accum_steps}")
        seconds = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0, "collectives": 0.0}
        opt.zero_grad()
        aux = None
        for mb in micro_batches:
            sync()
            t0 = time.perf_counter()
            out = loss_fn(state.model, mb)
            sync()
            t1 = time.perf_counter()
            out["loss"].backward()
            opt.accumulate()
            sync()
            seconds["forward"] += t1 - t0
            seconds["backward"] += time.perf_counter() - t1
            aux = {k: v.detach() for k, v in out.items()}
        t0 = time.perf_counter()
        if aux_reduce is not None:
            keys = list(aux)
            summed = aux_reduce(torch.stack([aux[k].float() for k in keys]))
            aux = {k: summed[i] for i, k in enumerate(keys)}
        opt.sync_grads(replicas)
        sync()
        seconds["collectives"] = time.perf_counter() - t0
        if grad_accum_steps > 1:
            with torch.no_grad():
                for g in opt.grads().values():
                    if g is not None:
                        g.div_(grad_accum_steps)
        aux.update(opt.step())
        opt.zero_grad()
        sync()
        seconds["optimizer"] = time.perf_counter() - t0
        step.seconds = seconds
        state.step += 1
        return state, aux

    step.seconds = {}
    return step
