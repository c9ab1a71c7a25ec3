"""Segmentation and language losses, counterpart of `rga3_tpu/ops/losses.py`.

Pure functions over static-shape batches, with validity weights in place
of loops over ragged per-sample lists: dice (scale 1000) and sigmoid
cross-entropy over mask logits, each also with an (N,) validity weight, and
the next-token cross-entropy of a causal LM (label shift, `ignore_index`
-100, an f32 log-sum-exp). Every loss computes in f32 whatever its inputs'
dtype.

The masked losses and the cross-entropy take an optional `total`: the
normaliser's sum over every row of the global batch when the rows are split
over ranks (`masked_count` / `label_count` of each rank's rows, all-reduced),
in place of the sum over the rows given. Each rank's loss is then its rows'
share of the global loss, and the shares sum to it.
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


def masked_count(valid):
    """The masked losses' normaliser over these rows: the sum of `valid`."""
    return valid.float().sum()


def label_count(labels, ignore_index: int = -100):
    """The cross-entropy's normaliser over these rows: the shifted labels
    that are not `ignore_index`."""
    return (labels[:, 1:] != ignore_index).float().sum()


def masked_dice_loss(inputs, targets, valid, scale: float = 1000.0, eps: float = 1e-6,
                     total=None):
    """Dice with an (N,) validity weight; invalid rows contribute 0. Divided
    by `total` when given, else by the sum of `valid`."""
    valid = valid.float()
    loss = _dice_per_mask(inputs, targets, scale, eps) * valid
    return loss.sum() / ((masked_count(valid) if total is None else total) + 1e-8)


def masked_sigmoid_ce_loss(inputs, targets, valid, total=None):
    """Sigmoid cross-entropy with an (N,) validity weight (divided by `total`
    when given, else by the sum of `valid`)."""
    valid = valid.float()
    denominator = masked_count(valid) if total is None else total
    return (_bce_per_mask(inputs, targets) * valid).sum() / (denominator + 1e-8)


def cross_entropy_loss(logits, labels, ignore_index: int = -100, total=None):
    """Next-token cross-entropy with label shift: logits (B, L, V), labels
    (B, L) with `ignore_index` masking; the sum over the valid targets
    divided by their count (`total` when given), at least 1."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = (shift_labels != ignore_index).float()
    safe = torch.where(shift_labels == ignore_index, torch.zeros_like(shift_labels),
                       shift_labels).long()
    logz = torch.logsumexp(shift_logits, dim=-1)
    gold = torch.gather(shift_logits, -1, safe[..., None])[..., 0]
    count = label_count(labels, ignore_index) if total is None else total
    return ((logz - gold) * valid).sum() / count.clamp_min(1.0)
