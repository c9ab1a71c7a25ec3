"""Qwen2.5-VL / UniGR Hugging Face checkpoints -> the port's state dicts,
counterpart of `rga3_tpu/models/qwen25vl/loader.py`.

The released `Qwen2.5-VL-{3B,7B}-Instruct` and UniGR directories hold
`*.safetensors` shards (listed by `model.safetensors.index.json` when there
is one) or `pytorch_model*.bin` files. HF names map straight onto the
port's module names; every tensor keeps its HF layout (Linear `(out, in)`),
except the vision tower's Conv3d patch embedding, whose `(O, I, T, H, W)`
kernel is the `(O, I*T*H*W)` weight of the port's Linear. UniGR
directories also carry `text_hidden_fcs.0.{0,2}` (the [SEG] projection)
and `grounding_encoder.sam2_model.*` (SAM2 under its reference names,
mapped by `models.sam2.loader`). A tied checkpoint (the 3B) has no
`lm_head.weight`, and the port's tied model has no `lm_head`.

Reads files with `utils.safetensors_io` and `torch.load(weights_only=True)`:
no `safetensors` or `transformers` package.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterator, Optional, Tuple

import torch

from ...utils import safetensors_io

# HF names inside a vision block / decoder layer -> the port's
VISION_BLOCK_KEYS = {
    "norm1.weight": "norm1.weight",
    "norm2.weight": "norm2.weight",
    "attn.qkv.weight": "attn_qkv.weight",
    "attn.qkv.bias": "attn_qkv.bias",
    "attn.proj.weight": "attn_proj.weight",
    "attn.proj.bias": "attn_proj.bias",
    "mlp.gate_proj.weight": "mlp_gate.weight",
    "mlp.gate_proj.bias": "mlp_gate.bias",
    "mlp.up_proj.weight": "mlp_up.weight",
    "mlp.up_proj.bias": "mlp_up.bias",
    "mlp.down_proj.weight": "mlp_down.weight",
    "mlp.down_proj.bias": "mlp_down.bias",
}
DECODER_LAYER_KEYS = (
    "input_layernorm.weight", "post_attention_layernorm.weight",
    "self_attn.q_proj.weight", "self_attn.q_proj.bias",
    "self_attn.k_proj.weight", "self_attn.k_proj.bias",
    "self_attn.v_proj.weight", "self_attn.v_proj.bias",
    "self_attn.o_proj.weight",
    "mlp.gate_proj.weight", "mlp.up_proj.weight", "mlp.down_proj.weight",
)
SAM2_PREFIX = "grounding_encoder.sam2_model."


def iter_safetensors(model_dir: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(HF name, tensor) over the shards of `model.safetensors.index.json`,
    or over every `*.safetensors` file when there is no index."""
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors in {model_dir}")
    for fname in files:
        yield from safetensors_io.iter_file(os.path.join(model_dir, fname))


def iter_torch_bin(model_dir: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(HF name, tensor) over `pytorch_model*.bin` (through its index when
    there is one)."""
    index = os.path.join(model_dir, "pytorch_model.bin.index.json")
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
    else:
        shards = sorted(f for f in os.listdir(model_dir)
                        if f.startswith("pytorch_model") and f.endswith(".bin"))
    if not shards:
        raise FileNotFoundError(f"no pytorch_model*.bin in {model_dir}")
    for shard in shards:
        yield from torch.load(os.path.join(model_dir, shard), map_location="cpu",
                              weights_only=True).items()


def iter_checkpoint(model_dir: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """safetensors shards if the directory has any, else torch .bin files."""
    has_st = any(f.endswith(".safetensors") for f in os.listdir(model_dir))
    return iter_safetensors(model_dir) if has_st else iter_torch_bin(model_dir)


def map_hf_key(key: str) -> Optional[str]:
    """HF weight name -> the port's `Qwen25VL` state-dict key, or None for
    names mapped elsewhere (SAM2, the [SEG] head) or not used."""
    k = re.sub(r"^model\.language_model\.", "model.", key)
    k = re.sub(r"^model\.visual\.", "visual.", k)
    if k == "visual.patch_embed.proj.weight":
        return "visual.patch_embed.weight"
    m = re.match(r"visual\.blocks\.(\d+)\.(.+)$", k)
    if m:
        rest = VISION_BLOCK_KEYS.get(m.group(2))
        return None if rest is None else f"visual.blocks_{m.group(1)}.{rest}"
    if k == "visual.merger.ln_q.weight":
        return "visual.merger_ln_q.weight"
    m = re.match(r"visual\.merger\.mlp\.([02])\.(weight|bias)$", k)
    if m:
        return f"visual.merger_fc{1 if m.group(1) == '0' else 2}.{m.group(2)}"
    if k == "model.embed_tokens.weight":
        return "lm.embed_tokens.weight"
    if k == "lm_head.weight":
        return "lm.lm_head.weight"
    if k == "model.norm.weight":
        return "lm.model.norm.weight"
    m = re.match(r"model\.layers\.(\d+)\.(.+)$", k)
    if m and m.group(2) in DECODER_LAYER_KEYS:
        return f"lm.model.layers_{m.group(1)}.{m.group(2)}"
    return None


_VISION_BLOCK_HF = {port: hf for hf, port in VISION_BLOCK_KEYS.items()}


def hf_key(port_key: str) -> Optional[str]:
    """The port's `Qwen25VL` state-dict key -> its HF weight name (the
    inverse of `map_hf_key`, in the names `export_hf_safetensors` writes), or
    None for a key HF has no name for."""
    if port_key == "visual.patch_embed.weight":
        return "visual.patch_embed.proj.weight"
    m = re.match(r"visual\.blocks_(\d+)\.(.+)$", port_key)
    if m:
        rest = _VISION_BLOCK_HF.get(m.group(2))
        return None if rest is None else f"visual.blocks.{m.group(1)}.{rest}"
    if port_key == "visual.merger_ln_q.weight":
        return "visual.merger.ln_q.weight"
    m = re.match(r"visual\.merger_fc([12])\.(weight|bias)$", port_key)
    if m:
        return f"visual.merger.mlp.{0 if m.group(1) == '1' else 2}.{m.group(2)}"
    fixed = {"lm.embed_tokens.weight": "model.embed_tokens.weight",
             "lm.lm_head.weight": "lm_head.weight", "lm.model.norm.weight": "model.norm.weight"}
    if port_key in fixed:
        return fixed[port_key]
    m = re.match(r"lm\.model\.layers_(\d+)\.(.+)$", port_key)
    if m and m.group(2) in DECODER_LAYER_KEYS:
        return f"model.layers.{m.group(1)}.{m.group(2)}"
    return None


def _qwen_tensor(port_key: str, val: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if port_key == "visual.patch_embed.weight":
        val = val.reshape(val.shape[0], -1)  # Conv3d (O, I, T, H, W) -> Linear (O, I*T*H*W)
    return val.to(dtype).contiguous()


def iter_qwen25vl_state(model_dir: str, dtype: torch.dtype = torch.float32
                        ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(state-dict key of the port's `Qwen25VL`, tensor) of a Qwen2.5-VL HF
    directory, one tensor at a time (a safetensors shard is read tensor by
    tensor, a torch .bin file whole)."""
    for key, val in iter_checkpoint(model_dir):
        port_key = map_hf_key(key)
        if port_key is not None:
            yield port_key, _qwen_tensor(port_key, val, dtype)


def load_qwen25vl_state_dict(model_dir: str, dtype: torch.dtype = torch.float32
                             ) -> Dict[str, torch.Tensor]:
    """A Qwen2.5-VL HF directory -> state dict of the port's `Qwen25VL`."""
    return dict(iter_qwen25vl_state(model_dir, dtype))


def load_unigr_state_dict(model_dir: str, dtype: torch.dtype = torch.float32
                          ) -> Dict[str, torch.Tensor]:
    """A merged UniGR HF directory -> state dict of the port's `UniGR`:
    `qwen.*`, `text_hidden_fcs.fc{1,2}.*` and, when the directory has SAM2,
    `grounding_encoder.*` (`.gamma` read as `.g_weight`)."""
    from ..sam2.loader import convert_sam2_checkpoint

    out: Dict[str, torch.Tensor] = {}
    sam_sd: Dict[str, torch.Tensor] = {}
    for key, val in iter_checkpoint(model_dir):
        if key.startswith(SAM2_PREFIX):
            sam_sd[key[len(SAM2_PREFIX):].replace(".gamma", ".g_weight")] = val
            continue
        m = re.match(r"text_hidden_fcs\.0\.([02])\.(weight|bias)$", key)
        if m:
            fc = "fc1" if m.group(1) == "0" else "fc2"
            out[f"text_hidden_fcs.{fc}.{m.group(2)}"] = val.to(dtype).contiguous()
            continue
        port_key = map_hf_key(key)
        if port_key is not None:
            out["qwen." + port_key] = _qwen_tensor(port_key, val, dtype)
    if sam_sd:
        for k, v in convert_sam2_checkpoint(sam_sd, dtype).items():
            out["grounding_encoder." + k] = v
    return out
