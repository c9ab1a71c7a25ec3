"""Segmentation and language losses, counterpart of `rga3_tpu/ops/losses.py`.

Pure functions over static-shape batches, with validity weights in place
of loops over ragged per-sample lists: dice (scale 1000) and sigmoid
cross-entropy over mask logits, each also with an (N,) validity weight, and
the next-token cross-entropy of a causal LM (label shift, `ignore_index`
-100, an f32 log-sum-exp). Every loss computes in f32 whatever its inputs'
dtype.
"""
from __future__ import annotations

import torch


def _dice_per_mask(inputs, targets, scale, eps):
    probs = torch.sigmoid(inputs.float()).reshape(inputs.shape[0], -1)
    t = targets.float().reshape(targets.shape[0], -1)
    numerator = 2.0 * (probs / scale * t).sum(-1)
    denominator = (probs / scale).sum(-1) + (t / scale).sum(-1)
    return 1.0 - (numerator + eps) / (denominator + eps)


def _bce_per_mask(inputs, targets):
    x, t = inputs.float(), targets.float()
    # log(1 + exp(-|x|)) + max(x, 0) - x * t, the stable BCE with logits
    per_pixel = x.clamp_min(0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return per_pixel.reshape(per_pixel.shape[0], -1).mean(-1)


def dice_loss(inputs, targets, num_masks, scale: float = 1000.0, eps: float = 1e-6):
    """DICE loss over (N, H, W) logits against binary targets, summed over
    masks and normalized by `num_masks`."""
    return _dice_per_mask(inputs, targets, scale, eps).sum() / (num_masks + 1e-8)


def sigmoid_ce_loss(inputs, targets, num_masks):
    """Per-pixel binary cross-entropy with logits, mean over pixels, sum
    over masks, normalized by `num_masks`."""
    return _bce_per_mask(inputs, targets).sum() / (num_masks + 1e-8)


def masked_dice_loss(inputs, targets, valid, scale: float = 1000.0, eps: float = 1e-6):
    """Dice with an (N,) validity weight; invalid rows contribute 0."""
    valid = valid.float()
    loss = _dice_per_mask(inputs, targets, scale, eps) * valid
    return loss.sum() / (valid.sum() + 1e-8)


def masked_sigmoid_ce_loss(inputs, targets, valid):
    """Sigmoid cross-entropy with an (N,) validity weight."""
    valid = valid.float()
    return (_bce_per_mask(inputs, targets) * valid).sum() / (valid.sum() + 1e-8)


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Next-token cross-entropy with label shift: logits (B, L, V), labels
    (B, L) with `ignore_index` masking; the mean over the valid targets."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = (shift_labels != ignore_index).float()
    safe = torch.where(shift_labels == ignore_index, torch.zeros_like(shift_labels),
                       shift_labels).long()
    logz = torch.logsumexp(shift_logits, dim=-1)
    gold = torch.gather(shift_logits, -1, safe[..., None])[..., 0]
    return ((logz - gold) * valid).sum() / valid.sum().clamp_min(1.0)
