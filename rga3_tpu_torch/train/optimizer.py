"""Optimizer: masked AdamW with warmup then cosine to a floor, and the
trainability mask. Counterpart of `rga3_tpu/train/optimizer.py`, with optax's
arithmetic:

  * `trainable_mask` marks a parameter trainable when any pattern appears in
    its name (LoRA, lm_head, embed_tokens, the SAM2 mask decoder,
    text_hidden_fcs), and sets `requires_grad` to match;
  * `lr_schedule(cfg)(count)` is optax's `join_schedules` of a linear warmup
    from 0 and a cosine decay to `min_lr_ratio * lr`; the n-th update uses
    count n - 1, so the first update's learning rate is 0;
  * `MaskedAdamW` is `multi_transform({train: chain(clip_by_global_norm,
    adamw(mu_dtype)), freeze: set_to_zero})`: the gradients of the trainable
    parameters only are clipped by their global norm; the first moment is
    kept in `adam_mu_dtype`, the second in the parameter's dtype; frozen
    parameters are never touched. (`torch.optim.AdamW` keeps both moments in
    the parameter's dtype, which differs at bf16 parameters.)
  * with `master_dtype` float32 on a bf16 model (the JAX package's f32
    parameters with bf16 compute), each trainable tensor has an f32 master:
    the gradients are summed over the micro-batches in f32, the moments
    and the update are the f32 parameter's, and the master is written back
    to the model rounded to bf16. A trainable tensor the model already
    holds in f32 is its own master. A frozen tensor needs no master: an f32
    weight cast to bf16 at each use is the bf16 weight.

The global norm is summed in f32 (optax sums each leaf in its own dtype).
Over a mesh of ranks `MaskedAdamW` is ZeRO-2: each rank keeps its fsdp
block of the state (see the class); `build_optimizer` first cuts the model
to the rank's blocks (`parallel.fsdp.shard_model`: the frozen weights over
fsdp, the LM's named leaves over tensor), as the JAX package's
`make_train_state(..., mesh)` shards every leaf.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..config import TrainConfig
from ..parallel.distributed import all_gather_along, all_reduce, reduce_scatter_along
from ..parallel.fsdp import shard_model

DEFAULT_TRAINABLE_PATTERNS: Tuple[str, ...] = (
    "lora_a",
    "lora_b",
    "lm_head",
    "embed_tokens",
    "sam_mask_decoder",
    "text_hidden_fcs",
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def trainable_mask(model: nn.Module,
                   patterns: Sequence[str] = DEFAULT_TRAINABLE_PATTERNS) -> Dict[str, bool]:
    """{parameter name: trainable}, True where any pattern appears in the
    name; sets each parameter's `requires_grad` to match."""
    mask = {}
    for name, p in model.named_parameters():
        mask[name] = any(pat in name for pat in patterns)
        p.requires_grad_(mask[name])
    return mask


def warmup_cosine_schedule(lr: float, warmup: int, decay: int,
                           floor_ratio: float = 0.0) -> Callable[[int], float]:
    """optax's `warmup_cosine_decay_schedule(0, lr, warmup, warmup + decay,
    floor_ratio * lr)` (f32, as optax computes it): a linear warmup from 0
    over `warmup` counts, then a cosine decay over `decay` counts to
    `floor_ratio * lr`."""
    if decay <= 0:
        raise ValueError(f"the cosine decay needs a positive length, got {decay}")
    f32 = torch.float32

    def schedule(count: int) -> float:
        if count < warmup:
            frac = 1.0 - torch.tensor(min(max(count, 0), warmup), dtype=f32) / warmup
            return float((0.0 - lr) * frac + lr)
        c = torch.tensor(min(count - warmup, decay), dtype=f32)
        cosine = 0.5 * (1 + torch.cos(torch.tensor(math.pi, dtype=f32) * c / decay))
        return float(lr * ((1 - floor_ratio) * cosine + floor_ratio))

    return schedule


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Linear warmup from 0 over `warmup_ratio` of the steps, then cosine
    decay to a floor of `min_lr_ratio * lr` (f32, as optax computes it)."""
    total = cfg.epochs * cfg.steps_per_epoch
    warmup = max(1, int(total * cfg.warmup_ratio))
    return warmup_cosine_schedule(cfg.lr, warmup, max(1, total - warmup), cfg.min_lr_ratio)


class MaskedAdamW:
    """AdamW over the trainable parameters of `model` (those that require
    grad): clip by global norm, Adam moments, decoupled weight decay,
    `-lr(count)` (`lr_schedule(cfg)` unless a `schedule` is given), added to
    the parameter (or its master) in f32 and rounded to its dtype. `state`
    holds `count`, `mu`, `nu` and `master`.

    Over a `mesh` of ranks (`parallel.make_mesh`; the model cut by
    `parallel.fsdp.shard_model`) it is ZeRO-2: each rank holds and updates
    only its fsdp block of every tensor that the sharding rule gives an
    fsdp dimension (its master, `mu` and `nu`; `dims[name]`), and whole
    copies of the rest, within the rank's tensor block of a tensor-sharded
    one (`embed_tokens`, `lm_head`). `sync_grads` sums the gradients over
    the ranks once a step (over tensor first for the LoRA factors, whose
    gradient each tensor rank holds in part; then reduce-scatter over fsdp
    along the fsdp dimension, else all-reduce, over the ranks of this
    tensor index; all-reduce over data) and divides by the ranks that hold
    each row; the global norm counts every element once; after the update
    each sharded parameter is all-gathered whole over fsdp. Elementwise, a
    block's update is the whole tensor's."""

    def __init__(self, cfg: TrainConfig, model: nn.Module, master_dtype: torch.dtype = None,
                 master_init: Dict[str, torch.Tensor] = None,
                 schedule: Callable[[int], float] = None, mesh=None):
        self.cfg = cfg
        self.schedule = schedule or lr_schedule(cfg)
        self.mu_dtype = DTYPES[cfg.adam_mu_dtype]
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        # parameters that take gradients but no update (`build_optimizer`:
        # the unfrozen SAM2 backbone)
        self.grad_only: Dict[str, nn.Parameter] = {}
        self.count = 0
        self.mesh = mesh if mesh is not None and mesh.groups else None
        self.plan = getattr(model, "shard_plan", None)
        self.dims: Dict[str, Optional[int]] = {n: None for n in self.params}
        # tensor-sharded tensors (the rank's block) and partial gradients
        self.tensor_sharded, self.partial = set(), set()
        if self.mesh is not None:
            if self.plan is None:
                raise ValueError("a mesh's optimizer needs the model cut by shard_model")
            blocks = self.plan.blocks
            self.dims = {n: blocks[n].fsdp_dim for n in self.params}
            self.tensor_sharded = {n for n in self.params if blocks[n].tensor is not None}
            self.partial = self.plan.partial & set(self.params)
            self.fsdp_index = self.mesh.coords[1]
        # a master starts from `master_init` where given (the values before
        # rounding to the model's dtype), else from the parameter; a
        # parameter already in `master_dtype` is its own master
        init = master_init or {}
        self.master = {} if master_dtype is None else {
            n: (self.shard(n, p.detach()) if p.dtype == master_dtype
                else self.shard(n, init.get(n, p.detach())).to(p.device, master_dtype,
                                                                copy=True))
            for n, p in self.params.items()}
        # f32 sums of the micro-batches' gradients of the tensors with a master
        self.grad_sum: Dict[str, torch.Tensor] = {}
        # the gradients summed over the ranks (this rank's blocks), after sync_grads
        self.synced: Dict[str, torch.Tensor] = {}
        self.mu = {n: torch.zeros_like(self.value(n), dtype=self.mu_dtype) for n in self.params}
        self.nu = {n: torch.zeros_like(self.value(n)) for n in self.params}

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole tensor of `name` (a view), or `t`."""
        dim = self.dims[name]
        if dim is None:
            return t
        n = t.shape[dim] // self.mesh.shape["fsdp"]
        return t.narrow(dim, self.fsdp_index * n, n)

    def value(self, name: str) -> torch.Tensor:
        """The tensor the update applies to: the master, else the parameter
        (this rank's block of it, where it is sharded)."""
        return self.master.get(name, self.shard(name, self.params[name]))

    def full(self, name: str, t: torch.Tensor = None) -> torch.Tensor:
        """The rank's tensor block of `name` (the whole tensor without the
        tensor axis) from its fsdp block `t` (default: `value(name)`),
        gathered over fsdp where it is sharded (every rank calls it
        together)."""
        t = self.value(name) if t is None else t
        if self.dims[name] is None:
            return t
        return all_gather_along(t, self.dims[name], self.mesh.group("fsdp"))

    def whole(self, name: str, t: torch.Tensor = None) -> torch.Tensor:
        """The whole tensor of `name` from this rank's block `t`, gathered
        over fsdp and tensor (every rank calls it together)."""
        t = self.full(name, t)
        return t if name not in self.tensor_sharded else self.plan.tensor_whole(name, t)

    def tensor_block(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's tensor block of a whole tensor of `name` (a view)."""
        return whole if name not in self.tensor_sharded else self.plan.tensor_block(name, whole)

    @torch.no_grad()
    def accumulate(self) -> None:
        """Move the parameters' `.grad` into the f32 sums of the tensors
        with a master (after each micro-batch's backward)."""
        for name in self.master:
            p = self.params[name]
            if p.grad is None:
                continue
            if name in self.grad_sum:
                self.grad_sum[name].add_(p.grad)
            else:
                self.grad_sum[name] = p.grad.to(self.master[name].dtype)
            p.grad = None

    def grads(self) -> Dict[str, torch.Tensor]:
        """{name: the gradient the next update takes, or None}: after
        `sync_grads`, this rank's block of the sum over the ranks."""
        if self.synced:
            return dict(self.synced)
        return {n: self.grad_sum.get(n) if n in self.master else p.grad
                for n, p in self.params.items()}

    @torch.no_grad()
    def sync_grads(self, replicas: int = 1) -> None:
        """Sum the gradients over the mesh's ranks and divide by `replicas`,
        the ranks that held each row (one call a step; a no-op without a
        mesh): the gradients the tensor ranks hold in part summed over
        tensor, those every tensor rank holds whole averaged over it, the
        tensor blocks left alone. A tensor without a gradient counts as
        zeros, so that every rank makes the same collectives."""
        if self.mesh is None:
            return
        fsdp, data = self.mesh.group("fsdp"), self.mesh.group("data")
        replica, tensor = self.mesh.group(("data", "fsdp")), self.mesh.group("tensor")
        # every tensor rank holds each row: the rows' other holders are in
        # this rank's data x fsdp ranks
        t = self.mesh.shape["tensor"]
        div = replicas // t
        for name, g in self.grads().items():
            if g is None:
                w = self.params[name]
                g = torch.zeros(w.shape, dtype=self.value(name).dtype, device=w.device)
            if name in self.partial:
                g = all_reduce(g, tensor)
            elif t > 1 and name not in self.tensor_sharded:
                # every tensor rank computed this whole gradient, and a kernel
                # that adds with atomics rounds it differently on each: their
                # mean keeps the copies equal (exact at tensor 2 where they agree)
                g = all_reduce(g, tensor).div_(t)
            dim = self.dims[name]
            if dim is None:
                g = all_reduce(g, replica)
            else:
                g = all_reduce(reduce_scatter_along(g, dim, fsdp), data)
            if div > 1:
                g.div_(div)
            self.synced[name] = g

    def zero_grad(self) -> None:
        """Drop the gradients: the trainable parameters' and those of the
        parameters that take gradients without updates (`grad_only`)."""
        self.grad_sum = {}
        self.synced = {}
        for p in (*self.params.values(), *self.grad_only.values()):
            p.grad = None

    @torch.no_grad()
    def global_norm(self) -> torch.Tensor:
        """The gradients' L2 norm, each element counted once: the fsdp
        blocks summed over fsdp, the tensor blocks over tensor, the whole
        ones once."""
        grads = self.grads()
        dev = next(iter(self.params.values())).device

        def sq(fsdp: bool, tensor: bool):
            parts = [grads[n].float().square().sum() for n in grads
                     if grads[n] is not None and (self.dims[n] is not None) == fsdp
                     and (n in self.tensor_sharded) == tensor]
            return torch.stack(parts).sum() if parts else torch.zeros((), device=dev)

        whole = sq(False, False)
        if self.mesh is None:
            return whole.sqrt()
        blocks = all_reduce(torch.stack([sq(True, False), sq(True, True)]),
                            self.mesh.group("fsdp"))
        total = blocks[0] + whole
        if self.tensor_sharded:
            total = total + all_reduce((sq(False, True) + blocks[1]).contiguous(),
                                       self.mesh.group("tensor"))
        return total.sqrt()

    @torch.no_grad()
    def step(self) -> Dict[str, float]:
        """One update from `grads()` (a tensor without one counts as a zero
        gradient). Returns the learning rate used and the gradient's global
        norm before clipping."""
        cfg = self.cfg
        b1, b2, eps = cfg.beta1, cfg.beta2, 1e-8
        lr = self.schedule(self.count)
        gnorm = self.global_norm()
        clip = not bool(gnorm < cfg.grad_clip)
        self.count += 1
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** self.count
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** self.count
        for name, g in self.grads().items():
            w = self.value(name)
            g = torch.zeros_like(w) if g is None else g.to(w.dtype)
            if clip:
                g = (g / gnorm.to(g.dtype)) * cfg.grad_clip
            mu = (1 - b1) * g + b1 * self.mu[name]
            nu = (1 - b2) * g.square() + b2 * self.nu[name]
            upd = (mu / bc1.to(mu.dtype)) / ((nu / bc2.to(nu.dtype)).sqrt() + eps)
            if cfg.weight_decay:
                upd = upd + cfg.weight_decay * w
            upd = torch.tensor(-lr, dtype=upd.dtype) * upd
            w.copy_((w + upd).to(w.dtype))
            p = self.params[name]
            if self.dims[name] is not None:
                p.copy_(self.full(name, w.to(p.dtype)))
            elif name in self.master:
                p.copy_(w)
            self.mu[name] = mu.to(self.mu_dtype)
            self.nu[name] = nu
        return {"lr": lr, "grad_norm": float(gnorm)}


def build_optimizer(cfg: TrainConfig, model: nn.Module, master_dtype: torch.dtype = None,
                    master_init: Dict[str, torch.Tensor] = None, mesh=None) -> MaskedAdamW:
    """Mark the trainable parameters (`trainable_mask`), cut the model to the
    rank's blocks over `mesh` (`shard_model`, unless it was cut already)
    and build the masked AdamW over them (with `master_dtype` masters, from
    `master_init` where it has the tensor (the rank's tensor block); a
    parameter already in that dtype is its own; the state sharded over
    `mesh`'s fsdp axis)."""
    mask = trainable_mask(model)
    if mesh is not None and mesh.groups and getattr(model, "shard_plan", None) is None:
        shard_model(model, mesh, trainable=mask.get)
    opt = MaskedAdamW(cfg, model, master_dtype, master_init, mesh=mesh)
    backbone = unfrozen_backbone(model)
    if backbone:
        if getattr(model, "shard_plan", None) is not None:
            raise ValueError("the unfrozen SAM2 backbone's gradients are computed on a model "
                             "that is not cut over ranks")
        for p in backbone.values():
            p.requires_grad_(True)
        opt.grad_only = backbone
    return opt


def unfrozen_backbone(model: nn.Module) -> Dict[str, nn.Parameter]:
    """{name: parameter} of the SAM2 image encoder (trunk and neck) of a
    UniGR whose `seg.freeze_sam_backbone` is off, else {}. As `jax.grad`
    over the whole tree gives the JAX package's, these take gradients;
    the trainability mask is unchanged, so the optimizer never updates
    them."""
    seg = getattr(getattr(model, "cfg", None), "seg", None)
    if seg is None or seg.freeze_sam_backbone or not hasattr(model, "grounding_encoder"):
        return {}
    prefix = "grounding_encoder.image_encoder."
    return {n: p for n, p in model.named_parameters() if n.startswith(prefix)}
