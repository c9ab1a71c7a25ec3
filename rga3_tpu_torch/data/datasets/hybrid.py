"""The hybrid training mixture, counterpart of
`rga3_tpu/data/datasets/hybrid.py`: `DATASET_REGISTRY` names every task
dataset, and `ImgVidHybridDataset` picks one per sample with probability
proportional to its rate (datasets with no data on disk are left out).
`sample_global(i)` is a pure function of (seed, i): it seeds the dataset
choice and Python's and numpy's global RNGs, which the samplers draw from,
under a lock, so threaded prefetch gives the same samples.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Sequence

import numpy as np

from ..collate import TrainSample
from .base import TaskDataset
from .image_seg import ReasonSegDataset, ReferSegDataset, SemSegDataset
from .qa import ReferVideoQADataset, ReferVQADataset, VideoQADataset, VQADataset
from .video_seg import VideoExpressionDataset, YTVOSDataset


def _mevis(base_dir, **kw):
    import os

    return VideoExpressionDataset(
        os.path.join(base_dir, "mevis"), splits=("train", "valid_u"), **kw
    )


def _refer_vos(base_dir, **kw):
    import os

    return VideoExpressionDataset(
        os.path.join(base_dir, "refer_youtube_vos"), splits=("train",), **kw
    )


def _revos(base_dir, **kw):
    import os

    return VideoExpressionDataset(
        os.path.join(base_dir, "revos"), splits=("train",), **kw
    )


def _ref_davis(base_dir, **kw):
    import os

    return VideoExpressionDataset(
        os.path.join(base_dir, "ref_davis"), splits=("train",), **kw
    )


DATASET_REGISTRY: Dict[str, Callable[..., TaskDataset]] = {
    "sem_seg": SemSegDataset,
    "refer_seg": ReferSegDataset,
    "reason_seg": ReasonSegDataset,
    "vqa": VQADataset,
    "videoqa": VideoQADataset,
    "refer_vqa": ReferVQADataset,
    "refer_videoqa": ReferVideoQADataset,
    "mevis": _mevis,
    "refer_vos": _refer_vos,
    "revos": _revos,
    "ref_davis": _ref_davis,
    "vos": YTVOSDataset,
}


class ImgVidHybridDataset:
    def __init__(
        self,
        base_dir: str,
        datasets: Sequence[str],
        sample_rates: Sequence[float],
        samples_per_epoch: int,
        seed: int = 0,
        **dataset_kwargs,
    ):
        assert len(datasets) == len(sample_rates)
        self.samples_per_epoch = samples_per_epoch
        self.all_datasets: List[TaskDataset] = []
        rates: List[float] = []
        for name, rate in zip(datasets, sample_rates):
            if name not in DATASET_REGISTRY:
                raise KeyError(f"unknown dataset {name!r}")
            ds = DATASET_REGISTRY[name](base_dir, **dataset_kwargs)
            if len(ds) == 0:
                continue  # dataset not present on disk
            self.all_datasets.append(ds)
            rates.append(rate)
        if not self.all_datasets:
            raise FileNotFoundError(
                f"no datasets found under {base_dir} for {datasets}"
            )
        r = np.asarray(rates, np.float64)
        self.rates = r / r.sum()
        self.seed = seed
        self._global_lock = threading.Lock()

    def __len__(self):
        return self.samples_per_epoch

    def sample_global(self, global_idx: int) -> TrainSample:
        """The sample of global index `global_idx`, a pure function of
        (seed, global_idx): the index seeds the dataset choice and the
        Python / numpy global RNGs that the task samplers draw from, so
        batch composition is reproducible under threaded prefetch."""
        import random as _random

        # seeding and sampling are one atomic step: under threaded
        # prefetch another worker's draws would interleave with this one's
        with self._global_lock:
            ss = np.random.SeedSequence([self.seed, int(global_idx)])
            s_choice, s_py, s_np = ss.generate_state(3)
            rng = np.random.default_rng(s_choice)
            _random.seed(int(s_py))
            np.random.seed(int(s_np) % 2**32)
            ds = self.all_datasets[
                int(rng.choice(len(self.all_datasets), p=self.rates))
            ]
            return ds.sample()
