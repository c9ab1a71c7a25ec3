"""Training meters and segmentation IoU counts, counterpart of
`rga3_tpu/utils/meters.py`: `AverageMeter` / `ProgressMeter` (the train
loop's running losses; `AverageMeter.all_reduce` sums a meter over the ranks
of the process group), `intersection_and_union` and `giou_ciou` (gIoU: the
mean per-sample IoU of the foreground class; cIoU: cumulative intersection
over cumulative union)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.distributed import all_reduce, rank_device


class AverageMeter:
    """The last value and the running mean of a scalar."""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0.0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1e-8)

    def all_reduce(self):
        """Sum `sum` and `count` over every rank (f64, on the rank's device
        under NCCL), so that `avg` is the mean over all ranks' updates; a
        no-op without a process group."""
        if dist.is_initialized() and dist.get_world_size() > 1:
            t = torch.tensor([self.sum, self.count], dtype=torch.float64, device=rank_device())
            self.sum, self.count = (float(x) for x in all_reduce(t).tolist())
            self.avg = self.sum / max(self.count, 1e-8)

    def __str__(self):
        return f"{self.name} {self.val:.4f} ({self.avg:.4f})"


class ProgressMeter:
    """One printed line: `<prefix>[batch/num_batches]` and each meter."""

    def __init__(self, num_batches: int, meters: List[AverageMeter], prefix: str = ""):
        self.num_batches = num_batches
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int) -> str:
        entries = [f"{self.prefix}[{batch}/{self.num_batches}]"]
        entries += [str(m) for m in self.meters]
        line = "  ".join(entries)
        print(line, flush=True)
        return line


def intersection_and_union(pred: np.ndarray, target: np.ndarray, num_classes: int = 2,
                           ignore_index: int = 255) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class intersection, union and target pixel counts; target pixels
    equal to `ignore_index` count nowhere."""
    pred = pred.reshape(-1).copy()
    target = target.reshape(-1)
    pred[target == ignore_index] = ignore_index
    inter = pred[pred == target]
    area_i = np.histogram(inter, bins=num_classes, range=(0, num_classes - 1))[0]
    area_p = np.histogram(pred, bins=num_classes, range=(0, num_classes - 1))[0]
    area_t = np.histogram(target, bins=num_classes, range=(0, num_classes - 1))[0]
    return (area_i.astype(np.float64), (area_p + area_t - area_i).astype(np.float64),
            area_t.astype(np.float64))


def giou_ciou(intersections: np.ndarray, unions: np.ndarray) -> Tuple[float, float]:
    """(gIoU, cIoU) of stacked per-sample (N, classes) counts, class 1 the
    foreground; of 1-D per-sample counts, the means over samples."""
    per = intersections / np.maximum(unions, 1e-10)
    giou = float(per.mean(axis=0)[1]) if per.ndim > 1 else float(per.mean())
    ciou_arr = intersections.sum(axis=0) / np.maximum(unions.sum(axis=0), 1e-10)
    ciou = (float(ciou_arr[1]) if ciou_arr.ndim > 0 and ciou_arr.size > 1
            else float(ciou_arr))
    return giou, ciou
