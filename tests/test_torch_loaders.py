"""The port's checkpoint formats against the JAX package's, on the CPU. Each
case writes its own checkpoint from seeded random tensors at the tiny
configs.

* `utils.safetensors_io` against the `safetensors` package, both ways, at
  every supported dtype (BF16 through `safetensors.torch`).
* The Qwen2.5-VL loader against `load_qwen25vl_params` on a directory
  written by `export_hf_safetensors` (untied and tied, as the 3B is) and on
  a `pytorch_model.bin`: the port's state dict bit-equal to
  `torch_state_dict_from_flax` of the JAX tree, and loading strictly.
* The SAM2 loader against `load_sam2_params` on a `.pt` of reference names
  made by `models.sam2.loader.reference_state_dict`, the inverted
  `SAM2_KEY_TABLE` (the JAX converter raises on any reference name the
  inverted table lacks).
* `load_unigr_state_dict` against `load_unigr_params` on a merged UniGR
  directory (Qwen, the [SEG] head, SAM2 under its reference names).
* `save_quantized` / `load_quantized` both ways (the port writes and JAX
  reads, and the other way round) at int4 and int8: trees and state dicts
  bit-equal, and the quantized tiny forward bit-equal after the round trip.
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rga3_tpu.config import SegHeadConfig as JaxSegHead
from rga3_tpu.models.qwen25vl import loader as jloader
from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
from rga3_tpu.models.sam2 import tiny_sam2_config as jax_tiny_sam2
from rga3_tpu.models.sam2.loader import load_sam2_params
from rga3_tpu.models.unigr import UniGR as JaxUniGR, UniGRConfig as JaxUniGRConfig
from rga3_tpu.ops import quant as jq
from rga3_tpu.train.export import export_hf_safetensors
from rga3_tpu_torch.config import SegHeadConfig
from rga3_tpu_torch.convert import _flatten, torch_state_dict_from_flax
from rga3_tpu_torch.models.qwen25vl import tiny_config
from rga3_tpu_torch.models.qwen25vl import loader as tloader
from rga3_tpu_torch.models.qwen25vl.model import Qwen25VL
from rga3_tpu_torch.models.sam2 import loader as sam_loader
from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
from rga3_tpu_torch.models.sam2.model import Sam2Model
from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
from rga3_tpu_torch.ops import quant as tq
from rga3_tpu_torch.utils import safetensors_io

from torch_port_support import jax_param_tree

SEG_ID = 151665
VOCAB = 152_000


def _jax_cfg(tied=False):
    q = jax_tiny_config(VOCAB)
    q = q.replace(text=q.text.replace(tie_word_embeddings=tied))
    return JaxUniGRConfig(qwen=q, sam2=jax_tiny_sam2(64),
                          seg=JaxSegHead(out_dim=32, seg_token_id=SEG_ID))


def _port_cfg(tied=False, text=None, vision=None):
    q = tiny_config(VOCAB)
    q = q.replace(text=q.text.replace(tie_word_embeddings=tied, **(text or {})),
                  vision=q.vision.replace(**(vision or {})))
    return UniGRConfig(qwen=q, sam2=tiny_sam2_config(64),
                       seg=SegHeadConfig(out_dim=32, seg_token_id=SEG_ID))


def _tree(tied=False, seed=5):
    return jax_param_tree(JaxUniGR(_jax_cfg(tied)), jnp.zeros((2, 64, 64, 3)),
                          jnp.zeros((2, 1, 32)), jnp.zeros((1, 8), jnp.int32), seed=seed)


@pytest.fixture(scope="module")
def tree():
    return _tree()


def _assert_bit_equal(ours, ref):
    assert set(ours) == set(ref), sorted(set(ours) ^ set(ref))[:5]
    for key, val in ref.items():
        assert ours[key].dtype == val.dtype and torch.equal(ours[key], val), key


# ---- the safetensors format

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8, torch.uint8, torch.int32,
          torch.int64]


def _tensors(dtype, seed):
    g = torch.Generator().manual_seed(seed)
    shapes = [(3, 5), (7,), (2, 1, 4), ()]
    if dtype.is_floating_point:
        return {f"t{i}": torch.randn(s, generator=g).to(dtype) for i, s in enumerate(shapes)}
    info = torch.iinfo(dtype)
    return {f"t{i}": torch.randint(max(info.min, -1000), min(info.max, 1000), s, generator=g,
                                   dtype=torch.int64).to(dtype) for i, s in enumerate(shapes)}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_safetensors_io_against_the_package(tmp_path, dtype):
    import safetensors.numpy
    import safetensors.torch

    ours = _tensors(dtype, 1)
    safetensors_io.save_file(ours, str(tmp_path / "a.safetensors"))
    _assert_bit_equal(safetensors.torch.load_file(str(tmp_path / "a.safetensors")), ours)
    theirs = _tensors(dtype, 2)
    safetensors.torch.save_file(theirs, str(tmp_path / "b.safetensors"))
    _assert_bit_equal(safetensors_io.load_file(str(tmp_path / "b.safetensors")), theirs)
    if dtype != torch.bfloat16:  # numpy has no bfloat16: BF16 reads as uint16 there
        arrays = {k: v.numpy() for k, v in _tensors(dtype, 3).items()}
        safetensors_io.save_file(arrays, str(tmp_path / "c.safetensors"))
        back = safetensors.numpy.load_file(str(tmp_path / "c.safetensors"))
        safetensors.numpy.save_file(arrays, str(tmp_path / "d.safetensors"))
        mine = safetensors_io.load_file(str(tmp_path / "d.safetensors"), framework="np")
        for k, v in arrays.items():
            for got in (back[k], mine[k]):
                assert got.dtype == v.dtype and got.shape == v.shape
                np.testing.assert_array_equal(got, v)
    else:
        raw = safetensors_io.load_file(str(tmp_path / "b.safetensors"), framework="np")
        for k, v in theirs.items():
            np.testing.assert_array_equal(raw[k], v.view(torch.uint16).numpy())


# ---- Qwen2.5-VL and UniGR Hugging Face directories


def _export(jtree, out_dir):
    """export_hf_safetensors of the tree without SAM2 (it writes SAM2 under
    flax names, which `load_unigr_params` cannot read back)."""
    params = {k: v for k, v in jtree["params"].items() if k != "grounding_encoder"}
    export_hf_safetensors({"params": params}, str(out_dir))
    return str(out_dir)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_qwen_loader_matches_jax_on_an_exported_dir(tmp_path, tied):
    jtree = _tree(tied)
    d = _export(jtree, tmp_path)
    ref = torch_state_dict_from_flax(jloader.load_qwen25vl_params(d))
    ours = tloader.load_qwen25vl_state_dict(d)
    _assert_bit_equal(ours, ref)
    assert ("lm.lm_head.weight" in ours) != tied
    Qwen25VL(_port_cfg(tied).qwen, device="cpu").load_state_dict(ours, strict=True)


def test_qwen_loader_matches_jax_on_a_torch_bin(tmp_path, tree, monkeypatch):
    """A pytorch_model.bin of the exported tensors. The JAX loader's
    safetensors reader is a generator, so its FileNotFoundError comes after
    the fallback's try and a .bin-only directory raises there; the JAX side
    runs with a reader that raises at the call, which reaches its .bin
    route."""
    import safetensors.torch

    d = _export(tree, tmp_path / "st")
    tensors = safetensors.torch.load_file(os.path.join(d, "model.safetensors"))
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    torch.save(tensors, str(bin_dir / "pytorch_model.bin"))

    def no_safetensors(model_dir):
        raise FileNotFoundError(model_dir)

    monkeypatch.setattr(jloader, "iter_safetensors", no_safetensors)
    ref = torch_state_dict_from_flax(jloader.load_qwen25vl_params(str(bin_dir)))
    ours = tloader.load_qwen25vl_state_dict(str(bin_dir))
    _assert_bit_equal(ours, ref)
    _assert_bit_equal(ours, tloader.load_qwen25vl_state_dict(d))


def test_safetensors_index_shards(tmp_path, tree):
    """Shards listed by model.safetensors.index.json load as one file."""
    import json

    d = _export(tree, tmp_path / "one")
    tensors = safetensors_io.load_file(os.path.join(d, "model.safetensors"))
    names = sorted(tensors)
    shard_dir = tmp_path / "sharded"
    shard_dir.mkdir()
    weight_map = {}
    for i, part in enumerate((names[::2], names[1::2])):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        safetensors_io.save_file({k: tensors[k] for k in part}, str(shard_dir / fname))
        weight_map.update((k, fname) for k in part)
    with open(shard_dir / "model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    _assert_bit_equal(tloader.load_qwen25vl_state_dict(str(shard_dir)),
                      tloader.load_qwen25vl_state_dict(d))


def _reference_sam2(port_sd):
    return {k: v.clone() for k, v in sam_loader.reference_state_dict(port_sd).items()}


def test_sam2_loader_matches_jax(tmp_path, tree):
    sam_sd = torch_state_dict_from_flax(tree["params"]["grounding_encoder"])
    path = str(tmp_path / "sam2.pt")
    ref_sd = _reference_sam2(sam_sd)
    ref_sd["mask_downsample.weight"] = torch.zeros(1, 1, 4, 4)  # a name neither loader uses
    torch.save({"model": ref_sd}, path)
    jax_sd = torch_state_dict_from_flax(load_sam2_params(path))
    ours = sam_loader.load_sam2_state_dict(path)
    _assert_bit_equal(ours, jax_sd)
    _assert_bit_equal(ours, sam_sd)
    Sam2Model(tiny_sam2_config(64), device="cpu").load_state_dict(ours, strict=True)


def test_unigr_loader_on_a_merged_dir(tmp_path, tree):
    import safetensors.torch

    d = _export(tree, tmp_path)
    path = os.path.join(d, "model.safetensors")
    tensors = safetensors.torch.load_file(path)
    sam_sd = torch_state_dict_from_flax(tree["params"]["grounding_encoder"])
    tensors.update(("grounding_encoder.sam2_model." + k, v)
                   for k, v in _reference_sam2(sam_sd).items())
    safetensors.torch.save_file(tensors, path)
    ref = torch_state_dict_from_flax(jloader.load_unigr_params(d))
    ours = tloader.load_unigr_state_dict(d)
    _assert_bit_equal(ours, ref)
    _assert_bit_equal(ours, torch_state_dict_from_flax(tree))
    UniGR(_port_cfg(), device="cpu").load_state_dict(ours, strict=True)


# ---- pre-quantized directories


def _served(mode, sd):
    text = {"quant_int4": True} if mode == "int4" else {"quant_int8": True}
    m = UniGR(_port_cfg(text=text, vision={"quant_int8": True}), device="cpu")
    m.load_state_dict(sd, strict=True)
    return m.eval()


def _logits(model):
    ids = torch.as_tensor(np.random.default_rng(4).integers(0, 2000, (1, 9)))
    with torch.no_grad():
        return model.qwen(ids)["logits"]


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_quantized_dirs_round_trip_both_ways(tmp_path, tree, mode):
    jtree = {"params": dict(tree["params"])}
    jtree["params"]["qwen"] = jq.quantize_for_serving(tree["params"]["qwen"], mode)
    meta = {"bits": 4 if mode == "int4" else 8, "mode": mode, "arch": "unigr"}
    ref_sd = torch_state_dict_from_flax(jtree)

    # JAX writes, the port reads
    jq.save_quantized(jtree, str(tmp_path / "jax"), meta)
    assert tq.is_quantized_dir(str(tmp_path / "jax"))
    sd, got_meta = tq.load_quantized(str(tmp_path / "jax"))
    assert got_meta == meta
    _assert_bit_equal(sd, ref_sd)
    model = _served(mode, sd)

    # the port writes, JAX reads
    tq.save_quantized(model, str(tmp_path / "port"), meta)
    back, back_meta = jq.load_quantized(str(tmp_path / "port"))
    assert back_meta == meta
    a, b = _flatten(back["params"]), _flatten(jtree["params"])
    assert set(a) == set(b)
    for key in b:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
    # and reads its own: the quantized forward keeps every bit
    again, _ = tq.load_quantized(str(tmp_path / "port"))
    assert torch.equal(_logits(_served(mode, again)), _logits(model))
