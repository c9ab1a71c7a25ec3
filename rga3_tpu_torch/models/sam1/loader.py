"""SAM-v1 checkpoints (Meta's `sam_vit_h_4b8939.pth`, the reference's
module names) -> the port's `Sam1Model` state dict, counterpart of
`rga3_tpu/models/sam1/loader.py`.

As the SAM2 loader (`models/sam2/loader.py`), the port keeps PyTorch's
layouts, so tensors load as stored and only names change, except the
absolute position embedding, which the reference stores NHWC and the port
NCHW. `SAM1_KEY_TABLE` is the whole mapping, one (reference name, port
name, transform) row per pattern (`{i}` / `{j}` a layer index, `{p}`
`weight` or `bias`); reference names no row matches are skipped, and
`load_state_dict(strict=True)` names any parameter left out.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..sam2.loader import _pattern

_ATTN_PROJ = ("q_proj", "k_proj", "v_proj", "out_proj")


def _nhwc_to_nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _rows() -> List[Tuple[str, str, Optional[Callable]]]:
    enc = "image_encoder"
    rows = [
        (f"{enc}.patch_embed.proj.{{p}}", f"{enc}.patch_embed_proj.{{p}}", None),
        (f"{enc}.pos_embed", f"{enc}.pos_embed", _nhwc_to_nchw),
    ]
    blk = (f"{enc}.blocks.{{i}}.", f"{enc}.blocks_{{i}}.")
    for ref, port in (("norm1", "norm1"), ("norm2", "norm2"), ("attn.qkv", "attn.qkv"),
                      ("attn.proj", "attn.proj"), ("mlp.lin1", "mlp_lin1"),
                      ("mlp.lin2", "mlp_lin2")):
        rows.append((f"{blk[0]}{ref}.{{p}}", f"{blk[1]}{port}.{{p}}", None))
    for rel in ("rel_pos_h", "rel_pos_w"):
        rows.append((f"{blk[0]}attn.{rel}", f"{blk[1]}attn.{rel}", None))
    rows.append((f"{enc}.neck.{{i}}.{{p}}", f"{enc}.neck_{{i}}.{{p}}", None))
    pe = "prompt_encoder"
    rows += [
        (f"{pe}.pe_layer.positional_encoding_gaussian_matrix",
         f"{pe}.pe_layer.positional_encoding_gaussian_matrix", None),
        (f"{pe}.point_embeddings.{{i}}.weight", f"{pe}.point_embeddings_{{i}}.weight", None),
        (f"{pe}.not_a_point_embed.weight", f"{pe}.not_a_point_embed.weight", None),
        (f"{pe}.no_mask_embed.weight", f"{pe}.no_mask_embed.weight", None),
        (f"{pe}.mask_downscaling.{{i}}.{{p}}", f"{pe}.mask_downscaling_{{i}}.{{p}}", None),
    ]
    md = "mask_decoder"
    rows += [(f"{md}.{tok}.weight", f"{md}.{tok}.weight", None)
             for tok in ("iou_token", "mask_tokens")]
    tl = (f"{md}.transformer.layers.{{i}}.", f"{md}.transformer.layers_{{i}}.")
    for attn in ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token"):
        for proj in _ATTN_PROJ:
            rows.append((f"{tl[0]}{attn}.{proj}.{{p}}", f"{tl[1]}{attn}.{proj}.{{p}}", None))
    for norm in ("norm1", "norm2", "norm3", "norm4"):
        rows.append((f"{tl[0]}{norm}.{{p}}", f"{tl[1]}{norm}.{{p}}", None))
    # SAM-v1's two-way MLP is common.MLPBlock (lin1 / lin2)
    rows += [(f"{tl[0]}mlp.lin1.{{p}}", f"{tl[1]}mlp.layers_0.{{p}}", None),
             (f"{tl[0]}mlp.lin2.{{p}}", f"{tl[1]}mlp.layers_1.{{p}}", None)]
    for proj in _ATTN_PROJ:
        rows.append((f"{md}.transformer.final_attn_token_to_image.{proj}.{{p}}",
                     f"{md}.transformer.final_attn_token_to_image.{proj}.{{p}}", None))
    rows += [
        (f"{md}.transformer.norm_final_attn.{{p}}", f"{md}.transformer.norm_final_attn.{{p}}",
         None),
        (f"{md}.output_upscaling.{{i}}.{{p}}", f"{md}.output_upscaling_{{i}}.{{p}}", None),
        (f"{md}.output_hypernetworks_mlps.{{i}}.layers.{{j}}.{{p}}",
         f"{md}.output_hypernetworks_mlps_{{i}}.layers_{{j}}.{{p}}", None),
        (f"{md}.iou_prediction_head.layers.{{j}}.{{p}}",
         f"{md}.iou_prediction_head.layers_{{j}}.{{p}}", None),
    ]
    return rows


SAM1_KEY_TABLE: Tuple[Tuple[str, str, Optional[Callable]], ...] = tuple(_rows())


_COMPILED = tuple((_pattern(ref), port, fn) for ref, port, fn in SAM1_KEY_TABLE)


def map_sam1_key(ref_key: str) -> Optional[Tuple[str, Optional[Callable]]]:
    """Reference SAM-v1 name -> (port name, transform), or None."""
    for rx, port, fn in _COMPILED:
        m = rx.match(ref_key)
        if m:
            return port.format(**m.groupdict()), fn
    return None


def convert_sam1_checkpoint(sd: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32
                            ) -> Dict[str, torch.Tensor]:
    """Reference-named state dict -> the port's `Sam1Model` state dict."""
    out = {}
    for key, val in sd.items():
        mapped = map_sam1_key(key)
        if mapped is not None:
            port, fn = mapped
            out[port] = (fn(val) if fn else val).to(dtype).contiguous()
    return out


def load_sam1_state_dict(path: str, dtype: torch.dtype = torch.float32
                         ) -> Dict[str, torch.Tensor]:
    """A reference checkpoint (`{"model": state_dict}` or a bare state dict)
    as the port's `Sam1Model` state dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd:
        sd = sd["model"]
    return convert_sam1_checkpoint(sd, dtype)
