"""SAM2 checkpoints (`sam2_hiera_large.pt`, reference module names) -> the
port's `Sam2Model` state dict, counterpart of `rga3_tpu/models/sam2/loader.py`.

The port keeps PyTorch's layouts, so every tensor loads as it is stored
(Linear `(out, in)`, Conv OIHW, ConvTranspose `(in, out, kh, kw)`, the
positional embeddings NCHW): only names change. `SAM2_KEY_TABLE` is the
whole mapping, one (reference name, port name, transform) row per pattern,
where `{i}` stands for a layer index and `{p}` for `weight` or `bias`; the
transform is None for every row (a row may name a function of the tensor).
Reference names no row matches are skipped, as the JAX loader skips them;
`load_state_dict(strict=True)` then names any parameter left out.
`reference_state_dict` is the inverse: the port's names back to the
reference's, as an export writes them.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import torch

_MD = "sam_mask_decoder"
_ATTN_PROJ = ("q_proj", "k_proj", "v_proj", "out_proj")


def _rows() -> List[Tuple[str, str, Optional[Callable]]]:
    rows = [(name, name, None) for name in
            ("no_mem_embed", "no_mem_pos_enc", "maskmem_tpos_enc", "no_obj_ptr")]
    rows += [
        ("obj_ptr_proj.layers.{i}.{p}", "obj_ptr_proj.layers_{i}.{p}", None),
        # Hiera trunk
        ("image_encoder.trunk.patch_embed.proj.{p}", "image_encoder.trunk.patch_embed_proj.{p}",
         None),
        ("image_encoder.trunk.pos_embed", "image_encoder.trunk.pos_embed", None),
        ("image_encoder.trunk.pos_embed_window", "image_encoder.trunk.pos_embed_window", None),
    ]
    blk = ("image_encoder.trunk.blocks.{i}.", "image_encoder.trunk.blocks_{i}.")
    for ref, port in (("norm1", "norm1"), ("norm2", "norm2"), ("attn.qkv", "attn_qkv"),
                      ("attn.proj", "attn_proj"), ("mlp.layers.0", "mlp_layers_0"),
                      ("mlp.layers.1", "mlp_layers_1"), ("proj", "proj")):
        rows.append((f"{blk[0]}{ref}.{{p}}", f"{blk[1]}{port}.{{p}}", None))
    rows.append(("image_encoder.neck.convs.{i}.conv.{p}", "image_encoder.neck.convs_{i}_conv.{p}",
                 None))
    # memory attention
    ma = ("memory_attention.layers.{i}.", "memory_attention.layers_{i}.")
    for attn in ("self_attn", "cross_attn_image"):
        for proj in _ATTN_PROJ:
            rows.append((f"{ma[0]}{attn}.{proj}.{{p}}", f"{ma[1]}{attn}.{proj}.{{p}}", None))
    for mod in ("linear1", "linear2", "norm1", "norm2", "norm3"):
        rows.append((f"{ma[0]}{mod}.{{p}}", f"{ma[1]}{mod}.{{p}}", None))
    rows.append(("memory_attention.norm.{p}", "memory_attention.norm.{p}", None))
    # memory encoder
    rows += [
        ("memory_encoder.mask_downsampler.encoder.{i}.{p}",
         "memory_encoder.mask_downsampler.encoder_{i}.{p}", None),
        ("memory_encoder.pix_feat_proj.{p}", "memory_encoder.pix_feat_proj.{p}", None),
        ("memory_encoder.out_proj.{p}", "memory_encoder.out_proj.{p}", None),
        ("memory_encoder.fuser.layers.{i}.g_weight", "memory_encoder.fuser_layers_{i}.g_weight",
         None),
    ]
    for mod in ("dwconv", "norm", "pwconv1", "pwconv2"):
        rows.append((f"memory_encoder.fuser.layers.{{i}}.{mod}.{{p}}",
                     f"memory_encoder.fuser_layers_{{i}}.{mod}.{{p}}", None))
    # prompt encoder
    pe = "sam_prompt_encoder"
    rows += [
        (f"{pe}.pe_layer.positional_encoding_gaussian_matrix",
         f"{pe}.pe_layer.positional_encoding_gaussian_matrix", None),
        (f"{pe}.point_embeddings.{{i}}.weight", f"{pe}.point_embeddings_{{i}}.weight", None),
        (f"{pe}.not_a_point_embed.weight", f"{pe}.not_a_point_embed.weight", None),
        (f"{pe}.no_mask_embed.weight", f"{pe}.no_mask_embed.weight", None),
        (f"{pe}.mask_downscaling.{{i}}.{{p}}", f"{pe}.mask_downscaling_{{i}}.{{p}}", None),
    ]
    # mask decoder
    rows += [(f"{_MD}.{tok}.weight", f"{_MD}.{tok}.weight", None)
             for tok in ("iou_token", "mask_tokens", "obj_score_token")]
    tl = (f"{_MD}.transformer.layers.{{i}}.", f"{_MD}.transformer.layers_{{i}}.")
    for attn in ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token"):
        for proj in _ATTN_PROJ:
            rows.append((f"{tl[0]}{attn}.{proj}.{{p}}", f"{tl[1]}{attn}.{proj}.{{p}}", None))
    for norm in ("norm1", "norm2", "norm3", "norm4"):
        rows.append((f"{tl[0]}{norm}.{{p}}", f"{tl[1]}{norm}.{{p}}", None))
    rows.append((f"{tl[0]}mlp.layers.{{j}}.{{p}}", f"{tl[1]}mlp.layers_{{j}}.{{p}}", None))
    for proj in _ATTN_PROJ:
        rows.append((f"{_MD}.transformer.final_attn_token_to_image.{proj}.{{p}}",
                     f"{_MD}.transformer.final_attn_token_to_image.{proj}.{{p}}", None))
    rows += [
        (f"{_MD}.transformer.norm_final_attn.{{p}}", f"{_MD}.transformer.norm_final_attn.{{p}}",
         None),
        (f"{_MD}.output_upscaling.{{i}}.{{p}}", f"{_MD}.output_upscaling_{{i}}.{{p}}", None),
        (f"{_MD}.conv_s0.{{p}}", f"{_MD}.conv_s0.{{p}}", None),
        (f"{_MD}.conv_s1.{{p}}", f"{_MD}.conv_s1.{{p}}", None),
        (f"{_MD}.output_hypernetworks_mlps.{{i}}.layers.{{j}}.{{p}}",
         f"{_MD}.output_hypernetworks_mlps_{{i}}.layers_{{j}}.{{p}}", None),
    ]
    for head in ("iou_prediction_head", "pred_obj_score_head"):
        rows.append((f"{_MD}.{head}.layers.{{j}}.{{p}}", f"{_MD}.{head}.layers_{{j}}.{{p}}", None))
    return rows


SAM2_KEY_TABLE: Tuple[Tuple[str, str, Optional[Callable]], ...] = tuple(_rows())


def _pattern(template: str) -> "re.Pattern":
    """A table name as a regex: `{i}` / `{j}` a decimal index, `{p}` weight or bias."""
    rx = re.escape(template)
    rx = rx.replace(r"\{i\}", r"(?P<i>\d+)").replace(r"\{j\}", r"(?P<j>\d+)")
    return re.compile(rx.replace(r"\{p\}", r"(?P<p>weight|bias)") + "$")


_COMPILED = tuple((_pattern(ref), port, fn) for ref, port, fn in SAM2_KEY_TABLE)
_INVERSE = tuple((_pattern(port), ref, fn) for ref, port, fn in SAM2_KEY_TABLE)


def map_sam2_key(ref_key: str) -> Optional[Tuple[str, Optional[Callable]]]:
    """Reference SAM2 name -> (port name, transform), or None if no row
    matches."""
    for rx, port, fn in _COMPILED:
        m = rx.match(ref_key)
        if m:
            return port.format(**m.groupdict()), fn
    return None


def reference_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's `Sam2Model` state dict under the reference's names: the
    inverse of `convert_sam2_checkpoint` through `SAM2_KEY_TABLE`, with
    `.g_weight` written as `.gamma`. Raises ValueError for a name that no
    row, or more than one, maps back, or whose row has a transform."""
    out = {}
    for key, val in sd.items():
        hits = [(ref.format(**m.groupdict()), fn) for rx, ref, fn in _INVERSE
                if (m := rx.match(key))]
        if len(hits) != 1 or hits[0][1] is not None:
            raise ValueError(f"{key}: no single transform-free SAM2_KEY_TABLE row maps it "
                             f"back ({[ref for ref, _ in hits]})")
        out[hits[0][0].replace(".g_weight", ".gamma")] = val
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint (`{"model": state_dict}` or a bare state
    dict) with `.gamma` read as `.g_weight`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd:
        sd = sd["model"]
    return {k.replace(".gamma", ".g_weight"): v for k, v in sd.items()}


def convert_sam2_checkpoint(sd: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32
                            ) -> Dict[str, torch.Tensor]:
    """Reference-named state dict -> the port's `Sam2Model` state dict."""
    out = {}
    for key, val in sd.items():
        mapped = map_sam2_key(key)
        if mapped is None:
            continue
        port, fn = mapped
        out[port] = (fn(val) if fn else val).to(dtype).contiguous()
    return out


def load_sam2_state_dict(path: str, dtype: torch.dtype = torch.float32
                         ) -> Dict[str, torch.Tensor]:
    return convert_sam2_checkpoint(load_torch_state_dict(path), dtype)
