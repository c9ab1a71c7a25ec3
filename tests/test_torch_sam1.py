"""The port's SAM-v1 (`rga3_tpu_torch.models.sam1`) against the JAX
package's on one seeded parameter tree, f32 on the CPU, at
`tiny_sam1_config(64)` (a 4 x 4 grid with windows of 3: the pad-to-6 and
crop path) and at a 512^2 input (a 32 x 32 grid: the global block attends
one frame at a time, the JAX package's `lax.map`):

* the image encoder, the text-prompted decode (one mask and three) and the
  point-, box- and mask-prompted decodes within 1e-4 (a module stack in
  f32 whose sums run in another order);
* the official checkpoint's names (`loader.SAM1_KEY_TABLE`) give the
  tensors the JAX package's loader gives, bit for bit.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rga3_tpu.models.sam1 import Sam1Model as JaxSam1, tiny_sam1_config as jax_tiny_sam1
from rga3_tpu.models.sam1.loader import convert_sam1_checkpoint as jax_convert
from rga3_tpu_torch.convert import torch_state_dict_from_flax
from rga3_tpu_torch.models.sam1 import Sam1Model, tiny_sam1_config
from rga3_tpu_torch.models.sam1.loader import SAM1_KEY_TABLE, convert_sam1_checkpoint

from torch_port_support import jax_param_tree

ATOL = 1e-4


def _pair(size, seed):
    jm = JaxSam1(jax_tiny_sam1(size))
    params = jax_param_tree(jm, jnp.zeros((2, size, size, 3)), jnp.zeros((2, 1, 32)),
                            seed=seed)
    tm = Sam1Model(tiny_sam1_config(size), device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair(64, 3)


def _apply(jm, params, method, *args):
    return jax.jit(lambda p, *a: jm.apply(p, *a, method=method))(
        params, *(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("size", [64, 512])
def test_image_encoder_matches_jax(pair, size):
    jm, params, tm = pair if size == 64 else _pair(size, 4)
    x = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    want = _apply(jm, params, lambda m, a: m.encode_image(a), x)
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(x))
    assert got.shape == (2, size // 16, size // 16, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("multimask", [False, True], ids=["single", "multimask"])
def test_text_prompted_decode_matches_jax(pair, multimask):
    jm, params, tm = pair
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    lang = rng.standard_normal((3, 1, 32)).astype(np.float32)
    want = _apply(jm, params, lambda m, a, b: m.decode_frames_with_language(
        a, b, multimask_output=multimask), frames, lang)
    with torch.no_grad():
        got = tm.decode_frames_with_language(torch.from_numpy(frames), torch.from_numpy(lang),
                                             multimask_output=multimask)
    assert got["low_res_masks"].shape == (3, 3 if multimask else 1, 16, 16)
    for key in ("low_res_masks", "iou_predictions"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("prompt", ["points", "box", "mask"])
def test_prompted_decode_matches_jax(pair, prompt):
    jm, params, tm = pair
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    kw = {}
    if prompt == "points":
        kw = dict(point_coords=rng.uniform(0, 64, (2, 3, 2)).astype(np.float32),
                  point_labels=np.array([[1, 0, 1], [1, 1, 0]], np.int32))
    elif prompt == "box":
        kw = dict(point_coords=np.array([[[4, 6], [40, 50]], [[10, 2], [60, 30]]], np.float32),
                  point_labels=np.array([[2, 3], [2, 3]], np.int32))
    else:
        kw = dict(masks=(3 * rng.standard_normal((2, 16, 16, 1))).astype(np.float32))
    names = sorted(kw)
    want = _apply(jm, params, lambda m, e, *a: m.decode_with_prompts(
        e, **dict(zip(names, a))), emb, *(kw[k] for k in names))
    with torch.no_grad():
        got = tm.decode_with_prompts(torch.from_numpy(emb),
                                     **{k: torch.from_numpy(v) for k, v in kw.items()})
    for key in ("low_res_masks", "iou_predictions"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0,
                                   err_msg=key)


def test_preprocess_matches_jax(pair):
    jm, params, tm = pair
    x = np.random.default_rng(6).integers(0, 256, (2, 40, 56, 3)).astype(np.float32)
    want = _apply(jm, params, lambda m, a: m.preprocess(a), x)
    got = tm.preprocess(torch.from_numpy(x))
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def _reference_names(port_sd):
    """The official checkpoint's names for a port state dict (the table read
    backwards), with the position embedding stored NHWC as there."""
    out = {}
    for key, t in port_sd.items():
        for ref, port, fn in SAM1_KEY_TABLE:
            rx = re.escape(port).replace(r"\{i\}", r"(?P<i>\d+)").replace(
                r"\{j\}", r"(?P<j>\d+)").replace(r"\{p\}", r"(?P<p>weight|bias)")
            m = re.fullmatch(rx, key)
            if m:
                out[ref.format(**m.groupdict())] = (
                    t.permute(0, 2, 3, 1) if fn is not None else t).numpy()
                break
        else:
            raise AssertionError(f"no row maps {key}")
    return out


def test_official_names_load_as_the_jax_loader_reads_them(pair):
    _, _, tm = pair
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    ref = _reference_names(sd)
    ref["image_encoder.unused_buffer"] = np.zeros(3, np.float32)  # skipped by both
    got = convert_sam1_checkpoint({k: torch.from_numpy(v) for k, v in ref.items()})
    want = torch_state_dict_from_flax(jax_convert(ref, jax_tiny_sam1(64)))
    assert set(got) == set(want) == set(sd)
    for k in sd:
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], sd[k]), k
