"""The port's training datasets against the JAX package's, on the CPU, on one
synthetic tree in every published layout (`tools/synth_trees.write_train_tree`):

* for each of the twelve `DATASET_REGISTRY` names, `ImgVidHybridDataset(...)
  .sample_global(i)` for i in 0..7 gives the same sample in both packages:
  the sample id, every message's text, `has_masks`, and the bytes of the video
  frames or images, the uint8 SAM frames and the gt masks (exact: both run
  the same PIL, OpenCV and numpy calls with the same global RNG draws);
* the same for the release mixture of ten datasets at their rates, and for
  the sources outside the registry's defaults (gRefCOCO, Osprey);
* `PrefetchLoader` with 2 worker threads delivers batch k as the k-th
  batch, as a synchronous loop would, and raises a worker's error.
"""
import os
import random
import sys

import numpy as np
import pytest

from rga3_tpu.data.datasets import DATASET_REGISTRY as JAX_REGISTRY
from rga3_tpu.data.datasets import ImgVidHybridDataset as JaxHybrid
from rga3_tpu.data.datasets.image_seg import ReferSegDataset as JaxReferSeg
from rga3_tpu.data.datasets.qa import ReferVQADataset as JaxReferVQA
from rga3_tpu_torch.data.datasets import DATASET_REGISTRY, ImgVidHybridDataset
from rga3_tpu_torch.data.datasets.image_seg import ReferSegDataset
from rga3_tpu_torch.data.datasets.qa import ReferVQADataset
from rga3_tpu_torch.data.prefetch import PrefetchLoader
from rga3_tpu_torch.tools.synth_trees import TRAIN_DATASETS, write_train_tree

KW = dict(num_frames_mllm=4, num_frames_sam=2, mask_res=32, sam_size=64)
RELEASE = ("sem_seg,refer_seg,vqa,reason_seg,refer_vos,vos,mevis,videoqa,refer_vqa,"
           "refer_videoqa").split(",")
RATES = [15, 30, 15, 1, 15, 15, 15, 15, 15, 15]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_train_tree(str(tmp_path_factory.mktemp("train_tree")), seed=3)


def sample_key(s):
    """Everything a sample carries, as comparable bytes and strings."""
    return (
        s.sample_id,
        [(m.role, [dict(c) for c in m.content]) for m in s.messages],
        s.has_masks,
        None if s.video_frames is None else [(f.shape, f.tobytes()) for f in s.video_frames],
        [(im.shape, im.tobytes()) for im in s.images],
        (s.sam_frames.dtype.str, s.sam_frames.shape, s.sam_frames.tobytes()),
        (s.gt_masks.dtype.str, s.gt_masks.shape, s.gt_masks.tobytes()),
    )


def test_registry_names_match():
    assert sorted(DATASET_REGISTRY) == sorted(JAX_REGISTRY) == sorted(TRAIN_DATASETS)


@pytest.mark.parametrize("name", sorted(TRAIN_DATASETS))
def test_each_dataset_matches_jax(tree, name):
    jax_ds = JaxHybrid(tree, [name], [1.0], 8, **KW)
    port_ds = ImgVidHybridDataset(tree, [name], [1.0], 8, **KW)
    for i in range(8):
        want, got = jax_ds.sample_global(i), port_ds.sample_global(i)
        assert sample_key(got) == sample_key(want), (name, i)
        assert got.sam_frames.dtype == np.uint8 and got.sam_frames.shape == (2, 64, 64, 3)
        assert got.gt_masks.shape == (2, 32, 32)
        assert got.has_masks == (name not in ("vqa", "videoqa", "refer_vqa", "refer_videoqa"))


def test_release_mixture_matches_jax(tree):
    jax_ds = JaxHybrid(tree, RELEASE, RATES, 16, seed=5, **KW)
    port_ds = ImgVidHybridDataset(tree, RELEASE, RATES, 16, seed=5, **KW)
    assert np.array_equal(port_ds.rates, jax_ds.rates)
    for i in range(12):
        assert sample_key(port_ds.sample_global(i)) == sample_key(jax_ds.sample_global(i)), i


@pytest.mark.parametrize("which", ["grefcoco", "osprey"])
def test_non_default_sources_match_jax(tree, which):
    if which == "grefcoco":
        jax_ds = JaxReferSeg(tree, datasets="refcoco||grefcoco", **KW)
        port_ds = ReferSegDataset(tree, datasets="refcoco||grefcoco", **KW)
    else:
        kw = {k: v for k, v in KW.items() if k != "num_frames_mllm"}
        jax_ds = JaxReferVQA(tree, ref_vqa_dataset="osprey", **kw)
        port_ds = ReferVQADataset(tree, ref_vqa_dataset="osprey", **kw)
    assert len(port_ds) == len(jax_ds) > 0
    for seed in range(6):
        random.seed(seed)
        np.random.seed(seed)
        want = jax_ds.sample()
        random.seed(seed)
        np.random.seed(seed)
        assert sample_key(port_ds.sample()) == sample_key(want), seed


@pytest.mark.parametrize("oversubscribed", [False, True])
def test_indexed_prefetch_keeps_order(tree, oversubscribed):
    """Batch k is `make_batch(k)` whatever the threads' timing: with more
    workers than cores and a short switch interval, a sample drawn while
    another thread reseeded the global RNGs would differ from the
    sequential one."""
    ds = ImgVidHybridDataset(tree, RELEASE, RATES, 16, **KW)

    def make_batch(idx):
        return [sample_key(ds.sample_global(2 * idx + r)) for r in range(2)]

    n = 12
    workers = 2 * (os.cpu_count() or 1) if oversubscribed else 2
    want = [make_batch(i) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    loader = PrefetchLoader(make_batch, num_workers=workers, buffer_size=2)
    try:
        got = [next(loader) for _ in range(n)]
    finally:
        loader.close()
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in loader._threads)
    assert got == want


def test_prefetch_raises_a_worker_error():
    def make_batch(idx):
        if idx == 3:
            raise ValueError("bad sample")
        return idx

    loader = PrefetchLoader(make_batch, num_workers=2, buffer_size=2)
    try:
        assert [next(loader) for _ in range(3)] == [0, 1, 2]
        with pytest.raises(ValueError, match="bad sample"):
            next(loader)
    finally:
        loader.close()
    assert not any(t.is_alive() for t in loader._threads)
    assert [next(PrefetchLoader(make_batch, num_workers=0)) for _ in range(2)] == [0, 0]
