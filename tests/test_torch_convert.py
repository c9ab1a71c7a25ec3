"""The weight bridge (rga3_tpu_torch.convert): flax trees of the JAX package
into the port's modules with strict loading."""
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rga3_tpu.config import SegHeadConfig as JaxSegHead
from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
from rga3_tpu.models.sam2 import tiny_sam2_config as jax_tiny_sam2
from rga3_tpu.models.unigr import UniGR as JaxUniGR, UniGRConfig as JaxUniGRConfig
from rga3_tpu_torch.config import SegHeadConfig
from rga3_tpu_torch.convert import load_params_npz, torch_state_dict_from_flax
from rga3_tpu_torch.models.qwen25vl import tiny_config
from rga3_tpu_torch.models.sam2.config import tiny_sam2_config, unfused
from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig

from torch_port_support import jax_param_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fused_tree():
    """Params of the JAX UniGR with the DEFAULT (fused) Hiera config."""
    jcfg = JaxUniGRConfig(qwen=jax_tiny_config(152_000), sam2=jax_tiny_sam2(64),
                          seg=JaxSegHead(out_dim=32, seg_token_id=151665))
    assert jcfg.sam2.hiera.use_fused_block and jcfg.sam2.hiera.use_fused_transition
    return jax_param_tree(JaxUniGR(jcfg), jnp.zeros((2, 64, 64, 3)),
                          jnp.zeros((2, 1, 32)), jnp.zeros((1, 8), jnp.int32))


def _port_model():
    cfg = UniGRConfig(qwen=tiny_config(152_000), sam2=unfused(tiny_sam2_config(64)),
                      seg=SegHeadConfig(out_dim=32, seg_token_id=151665))
    return UniGR(cfg, device="cpu")


def test_fused_config_params_load_strict(fused_tree):
    sd = torch_state_dict_from_flax(fused_tree)
    model = _port_model()
    model.load_state_dict(sd, strict=True)
    p = fused_tree["params"]
    # Dense (in, out) -> (out, in); LayerNorm scale -> weight; NHWC -> NCHW
    blk = p["grounding_encoder"]["image_encoder"]["trunk"]["blocks_0"]
    np.testing.assert_array_equal(
        model.grounding_encoder.image_encoder.trunk.blocks_0.attn_qkv.weight.detach().numpy(),
        blk["attn_qkv"]["kernel"].T)
    np.testing.assert_array_equal(
        model.grounding_encoder.image_encoder.trunk.blocks_0.norm1.weight.detach().numpy(),
        blk["norm1"]["scale"])
    np.testing.assert_array_equal(
        model.grounding_encoder.image_encoder.trunk.pos_embed.detach().numpy(),
        p["grounding_encoder"]["image_encoder"]["trunk"]["pos_embed"].transpose(0, 3, 1, 2))
    conv = p["grounding_encoder"]["image_encoder"]["trunk"]["patch_embed_proj"]["kernel"]
    np.testing.assert_array_equal(
        model.grounding_encoder.image_encoder.trunk.patch_embed_proj.weight.detach().numpy(),
        conv.transpose(3, 2, 0, 1))


def test_unknown_keys_fail_strict_and_memory_subtrees_are_dropped(fused_tree):
    """The tracker's memory subtrees are no longer dropped: they load
    strictly into the port's memory modules (layouts as every other leaf);
    an unknown key still fails."""
    sd = torch_state_dict_from_flax(fused_tree)
    g = fused_tree["params"]["grounding_encoder"]
    for name in ("memory_attention", "memory_encoder"):
        assert name in g and any(k.startswith(f"grounding_encoder.{name}.") for k in sd)
    model = _port_model()
    model.load_state_dict(sd, strict=True)
    sam = model.grounding_encoder
    np.testing.assert_array_equal(
        sam.memory_attention.layers_0.cross_attn_image.k_proj.weight.detach().numpy(),
        g["memory_attention"]["layers_0"]["cross_attn_image"]["k_proj"]["kernel"].T)
    np.testing.assert_array_equal(
        sam.memory_encoder.fuser_layers_0.dwconv.weight.detach().numpy(),
        g["memory_encoder"]["fuser_layers_0"]["dwconv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sam.memory_encoder.fuser_layers_1.g_weight.detach().numpy(),
                                  g["memory_encoder"]["fuser_layers_1"]["g_weight"])
    np.testing.assert_array_equal(sam.maskmem_tpos_enc.detach().numpy(), g["maskmem_tpos_enc"])
    np.testing.assert_array_equal(sam.no_mem_pos_enc.detach().numpy(), g["no_mem_pos_enc"])
    sd["grounding_encoder.unexpected.weight"] = torch.zeros(1)
    with pytest.raises(RuntimeError):
        _port_model().load_state_dict(sd, strict=True)


def test_init_weights_covers_the_memory_parameters():
    """UniGR.init_weights draws every new parameter: the layer scales and
    the temporal encodings by the raw-parameter rule, normal(0, std)."""
    model = _port_model()
    model.init_weights(torch.Generator().manual_seed(0), std=0.02)
    sam = model.grounding_encoder
    for p in (sam.memory_encoder.fuser_layers_0.g_weight, sam.maskmem_tpos_enc,
              sam.no_mem_pos_enc, sam.memory_attention.layers_1.self_attn.q_proj.weight):
        assert 0.005 < p.detach().std().item() < 0.05
    assert torch.equal(sam.memory_attention.norm.weight.detach(),
                       torch.ones_like(sam.memory_attention.norm.weight))


def test_lora_and_npz_loader_match_the_jax_exporter():
    import importlib.util

    path = os.path.join(ROOT, "runs", "learning_proof_tiny", "params_f16.npz")
    spec = importlib.util.spec_from_file_location(
        "export_learned_tiny", os.path.join(ROOT, "scripts", "export_learned_tiny.py"))
    elt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(elt)
    ours = load_params_npz(path)
    theirs = elt.load_params_npz(path)["params"]
    a = theirs["qwen"]["lm"]["model"]["layers_0"]["self_attn"]
    b = ours["qwen"]["lm"]["model"]["layers_0"]["self_attn"]
    for name in ("q_proj_lora_a", "q_proj_lora_b", "v_proj_lora_a", "v_proj_lora_b"):
        np.testing.assert_array_equal(b[name], np.asarray(a[name]))
    sd = torch_state_dict_from_flax(ours)
    key = "qwen.lm.model.layers_0.self_attn.q_proj_lora_a"
    np.testing.assert_array_equal(sd[key].numpy(), np.asarray(a["q_proj_lora_a"]))


def test_scanned_trees_are_refused():
    """A stacked (scanned) leaf is refused where it would be taken as one
    layer's; `torch_state_dict_from_flax` unstacks a scanned tree first."""
    from rga3_tpu_torch.convert import _leaf

    stacked = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    with pytest.raises(ValueError, match="stacked"):
        _leaf(("lm", "layers_scan", "layer", "kernel"), stacked)
    sd = torch_state_dict_from_flax({"lm": {"layers_scan": {"layer": {"kernel": stacked}}}})
    assert set(sd) == {"lm.layers_0.weight", "lm.layers_1.weight"}
    for i in range(2):
        np.testing.assert_array_equal(sd[f"lm.layers_{i}.weight"].numpy(), stacked[i].T)
