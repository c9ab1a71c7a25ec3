"""Hugging Face transformers' Qwen2.5-VL as an oracle for the port's.

The checkpoint-compatibility guarantee ("UniGR-7B HF checkpoints load
unchanged") is checked against `transformers.Qwen2_5_VLForConditionalGeneration`:
an HF model is saved as an HF directory and read back through the port's
loader (`models/qwen25vl/loader.py`: `iter_checkpoint`, `map_hf_key`), so
the names, layouts and the Conv3d patch embedding go through the code
that reads a released checkpoint. `tests/test_torch_hf_parity.py` and
`tools/activation_diff.py` build on these helpers.

`transformers` is imported inside the functions only: the card's
environment has none, and every port module is imported by the CPU tests.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ..models.qwen25vl.config import Qwen25VLConfig, QwenTextConfig, QwenVisionConfig
from ..models.qwen25vl.loader import load_qwen25vl_state_dict
from ..models.qwen25vl.model import Qwen25VL


def require_transformers():
    """The `transformers` module, or ImportError naming what is missing."""
    try:
        import transformers
    except ImportError as e:
        raise ImportError(
            "the HF oracle needs the `transformers` package "
            "(transformers.Qwen2_5_VLForConditionalGeneration), which is not installed "
            "here; the card's environment has none: run it on the CPU (--device cpu)") from e
    return transformers


def tiny_hf_config(vocab_size: int, num_hidden_layers: int = 2,
                   rms_norm_eps: float = 1e-6):
    """A small `Qwen2_5_VLConfig`: 64-wide text (4 heads, 2 KV heads,
    M-RoPE sections (2, 3, 3)) and a 2-block, 32-wide vision tower (full
    attention in block 1)."""
    transformers = require_transformers()
    return transformers.Qwen2_5_VLConfig(
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=num_hidden_layers,
        num_attention_heads=4,
        num_key_value_heads=2,
        rope_theta=1_000_000.0,
        rms_norm_eps=rms_norm_eps,
        tie_word_embeddings=False,
        rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
        vision_config=dict(
            depth=2, hidden_size=32, intermediate_size=64, num_heads=4, patch_size=14,
            spatial_merge_size=2, temporal_patch_size=2, window_size=28,
            fullatt_block_indexes=[1], out_hidden_size=64, tokens_per_second=2,
        ),
    )


def random_hf_model(hf_cfg, seed: int = 0):
    """`Qwen2_5_VLForConditionalGeneration(hf_cfg)` with weights from
    `torch.manual_seed(seed)`, in eval mode."""
    transformers = require_transformers()
    torch.manual_seed(seed)
    return transformers.Qwen2_5_VLForConditionalGeneration(hf_cfg).eval()


def load_hf_model(hf_dir: str, dtype: torch.dtype = torch.float32):
    """A released HF directory as transformers' model, in eval mode."""
    transformers = require_transformers()
    return transformers.Qwen2_5_VLForConditionalGeneration.from_pretrained(
        hf_dir, torch_dtype=dtype).eval()


def port_config(hf_cfg) -> Qwen25VLConfig:
    """The port's config of an HF `Qwen2_5_VLConfig` (its text fields at
    the top level, as transformers keeps them, or under `text_config`)."""
    tc = getattr(hf_cfg, "text_config", None) or hf_cfg
    vc = hf_cfg.vision_config
    rope = getattr(tc, "rope_scaling", None) or hf_cfg.rope_scaling
    return Qwen25VLConfig(
        vision=QwenVisionConfig(
            depth=vc.depth, hidden_size=vc.hidden_size,
            intermediate_size=vc.intermediate_size, num_heads=vc.num_heads,
            patch_size=vc.patch_size, spatial_merge_size=vc.spatial_merge_size,
            temporal_patch_size=vc.temporal_patch_size, window_size=vc.window_size,
            fullatt_block_indexes=tuple(vc.fullatt_block_indexes),
            out_hidden_size=vc.out_hidden_size, tokens_per_second=vc.tokens_per_second,
        ),
        text=QwenTextConfig(
            vocab_size=tc.vocab_size, hidden_size=tc.hidden_size,
            intermediate_size=tc.intermediate_size, num_hidden_layers=tc.num_hidden_layers,
            num_attention_heads=tc.num_attention_heads,
            num_key_value_heads=tc.num_key_value_heads,
            head_dim=tc.hidden_size // tc.num_attention_heads, rms_norm_eps=tc.rms_norm_eps,
            rope_theta=tc.rope_theta, mrope_section=tuple(rope["mrope_section"]),
            tie_word_embeddings=bool(hf_cfg.tie_word_embeddings),
        ),
        image_token_id=hf_cfg.image_token_id,
        video_token_id=hf_cfg.video_token_id,
        vision_start_token_id=hf_cfg.vision_start_token_id,
    )


def port_model_from_dir(hf_dir: str, cfg: Qwen25VLConfig, device=None,
                        dtype: torch.dtype = torch.float32) -> Qwen25VL:
    """The port's `Qwen25VL` with every weight of an HF directory, read by
    the port's loader (strict: every port key, no other)."""
    model = Qwen25VL(cfg, device=device, dtype=dtype)
    state = load_qwen25vl_state_dict(hf_dir, dtype)
    model.load_state_dict(state, strict=True)
    return model.eval()


def hf_and_port(out_dir: str, hf_cfg, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32,
                hf_model=None) -> Tuple[object, Qwen25VL, Qwen25VLConfig]:
    """(transformers' model, the port's model read back from its saved
    directory `out_dir`, the port's config). The HF model is drawn from
    `seed` unless given."""
    hf = hf_model if hf_model is not None else random_hf_model(hf_cfg, seed)
    os.makedirs(out_dir, exist_ok=True)
    hf.save_pretrained(out_dir, safe_serialization=True)
    cfg = port_config(hf.config)
    return hf, port_model_from_dir(out_dir, cfg, device=device, dtype=dtype), cfg


def hf_hidden_states(hf, input_ids: torch.Tensor, autocast_bf16: bool = False,
                     **kw) -> Tuple[list, torch.Tensor]:
    """(every decoder layer's output as HF returns them, the logits), in
    f32 on the host: `hidden_states[0]` is the embeddings, the last is after
    the final norm. `autocast_bf16` runs HF under CPU bf16 autocast."""
    ctx = (torch.autocast("cpu", dtype=torch.bfloat16) if autocast_bf16
           else torch.autocast("cpu", enabled=False))
    with torch.no_grad(), ctx:
        out = hf(input_ids=input_ids, output_hidden_states=True, **kw)
    return [h.float() for h in out.hidden_states], out.logits.float()


def port_hidden_states(model: Qwen25VL, input_ids: torch.Tensor,
                       position_ids: Optional[torch.Tensor] = None):
    """(each decoder layer's output, the final hidden states after the
    norm, the logits) of the port's model, in f32 on the host."""
    lm = model.lm
    layers = [getattr(lm.model, f"layers_{i}") for i in range(lm.cfg.num_hidden_layers)]
    outs = []
    hooks = [layer.register_forward_hook(
        lambda mod, inp, out: outs.append((out[0] if isinstance(out, tuple) else out).float()))
        for layer in layers]
    try:
        with torch.no_grad():
            res = model(input_ids.to(model.device), position_ids=position_ids)
    finally:
        for h in hooks:
            h.remove()
    return ([o.cpu() for o in outs], res["hidden_states"].float().cpu(),
            res["logits"].float().cpu())
