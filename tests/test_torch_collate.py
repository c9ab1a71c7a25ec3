"""The port's `collate` (`rga3_tpu_torch.data.collate`) against the JAX
package's, array for array, on seeded synthetic samples: video samples with
[SEG] answers and gt masks of two sizes, an image sample, a text-only VQA
sample, with and without a vision token budget."""
import numpy as np
import pytest

from rga3_tpu.data import collate as jc
from rga3_tpu.data.processor import ChatMessage as JaxMessage, QwenVLProcessor as JaxProcessor
from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
from rga3_tpu_torch.data import collate as tc
from rga3_tpu_torch.data.processor import ChatMessage, QwenVLProcessor
from rga3_tpu_torch.models.qwen25vl import tiny_config

KW = dict(min_pixels=4 * 28 * 28, max_pixels=16 * 28 * 28, video_max_pixels=16 * 28 * 28)


def _samples(mod, message, seed, kinds):
    rng = np.random.default_rng(seed)
    out = []
    for i, kind in enumerate(kinds):
        frames = [rng.integers(0, 256, (56 + 28 * i, 84, 3), dtype=np.uint8) for _ in range(4)]
        user = [{"type": "text", "text": f"please segment the thing number {i}"}]
        if kind == "video":
            user = [{"type": "video"}] + user
        elif kind == "image":
            user = [{"type": "image"}] + user
        answer = "sure it is [SEG] ." if kind != "text" else "no mask here"
        t = 2
        out.append(mod.TrainSample(
            sample_id=str(i),
            messages=[message("user", user), message("assistant",
                                                     [{"type": "text", "text": answer}])],
            video_frames=frames if kind == "video" else None,
            images=[frames[0]] if kind == "image" else [],
            sam_frames=rng.integers(0, 256, (t, 64, 64, 3), dtype=np.uint8),
            gt_masks=(rng.random((t, 40 + 8 * i, 48)) > 0.5).astype(np.float32),
            has_masks=kind != "text",
        ))
    return out


def _assert_same(a, b, path="batch"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape,
                                                           b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("kinds,budget", [
    (("video", "video"), None),
    (("video", "video"), 256),
    (("video", "image", "text"), 320),
    (("text", "text"), None),
], ids=["videos", "videos_budget", "mixed_budget", "text_only"])
def test_collate_matches_jax(kinds, budget):
    jb = jc.collate(_samples(jc, JaxMessage, 7, kinds),
                    JaxProcessor.from_pretrained("dummy", **KW), jax_tiny_config(152_000),
                    vision_budget_tokens=budget)
    tb = tc.collate(_samples(tc, ChatMessage, 7, kinds),
                    QwenVLProcessor.from_pretrained("dummy", **KW), tiny_config(152_000),
                    vision_budget_tokens=budget)
    _assert_same(tb, jb)
    assert (tb["labels"] == tc.IGNORE_INDEX).any() and (tb["labels"] != tc.IGNORE_INDEX).any()
    if budget is not None:
        assert tb["pixel_patches"].shape[0] == budget


def test_mask_labels_match_jax():
    rng = np.random.default_rng(11)
    tok = QwenVLProcessor.from_pretrained("dummy").tokenizer
    ids = rng.integers(1000, 2000, (3, 40)).astype(np.int32)
    for row, starts in zip(ids, ((0, 10, 25), (0, 12), (5, 20, 30))):
        for j, s in enumerate(starts):
            row[s], row[s + 1] = 151644, (872 if j % 2 else 77091)
            row[s + 6] = 151645
    ids[2, 35:] = 151643
    np.testing.assert_array_equal(tc.mask_labels(ids, tok, 151643),
                                  jc.mask_labels(ids, JaxProcessor.from_pretrained(
                                      "dummy").tokenizer, 151643))
