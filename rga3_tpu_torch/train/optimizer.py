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
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn as nn

from ..config import TrainConfig

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
    holds `count`, `mu`, `nu` and `master`."""

    def __init__(self, cfg: TrainConfig, model: nn.Module, master_dtype: torch.dtype = None,
                 master_init: Dict[str, torch.Tensor] = None,
                 schedule: Callable[[int], float] = None):
        self.cfg = cfg
        self.schedule = schedule or lr_schedule(cfg)
        self.mu_dtype = DTYPES[cfg.adam_mu_dtype]
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        self.count = 0
        # a master starts from `master_init` where given (the values before
        # rounding to the model's dtype), else from the parameter; a
        # parameter already in `master_dtype` is its own master
        init = master_init or {}
        self.master = {} if master_dtype is None else {
            n: (p.detach() if p.dtype == master_dtype
                else init.get(n, p.detach()).to(p.device, master_dtype, copy=True))
            for n, p in self.params.items()}
        # f32 sums of the micro-batches' gradients of the tensors with a master
        self.grad_sum: Dict[str, torch.Tensor] = {}
        self.mu = {n: torch.zeros_like(self.value(n), dtype=self.mu_dtype) for n in self.params}
        self.nu = {n: torch.zeros_like(self.value(n)) for n in self.params}

    def value(self, name: str) -> torch.Tensor:
        """The tensor the update applies to: the master, else the parameter."""
        return self.master.get(name, self.params[name])

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
        """{name: the gradient the next update takes, or None}."""
        return {n: self.grad_sum.get(n) if n in self.master else p.grad
                for n, p in self.params.items()}

    def zero_grad(self) -> None:
        self.grad_sum = {}
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def global_norm(self) -> torch.Tensor:
        sq = [g.float().square().sum() for g in self.grads().values() if g is not None]
        dev = next(iter(self.params.values())).device
        return torch.stack(sq).sum().sqrt() if sq else torch.zeros((), device=dev)

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
            if name in self.master:
                self.params[name].copy_(w)
            self.mu[name] = mu.to(self.mu_dtype)
            self.nu[name] = nu
        return {"lr": lr, "grad_norm": float(gnorm)}


def build_optimizer(cfg: TrainConfig, model: nn.Module, master_dtype: torch.dtype = None,
                    master_init: Dict[str, torch.Tensor] = None) -> MaskedAdamW:
    """Mark the trainable parameters (`trainable_mask`) and build the masked
    AdamW over them (with `master_dtype` masters, from `master_init` where
    it has the tensor; a parameter already in that dtype is its own)."""
    trainable_mask(model)
    return MaskedAdamW(cfg, model, master_dtype, master_init)
