"""Export a trained UniGR: LoRA merged into the base weights, written as an
HF-layout safetensors directory that `models.qwen25vl.loader.
load_unigr_state_dict` (and the JAX package's `load_unigr_params`) reads
back. Counterpart of `rga3_tpu/train/export.py`.

    export_hf_safetensors(model_or_state, out_dir)

takes the port's `UniGR`, or a `TrainState` (`train.step`, as
`train.checkpoints` restores it), whose f32 masters are read where it keeps
them. It writes `model.safetensors` and `rga3_export_manifest.json`
(`num_tensors`), every tensor in f32:

  * the Qwen2.5-VL tensors under their HF names (`models.qwen25vl.loader.
    hf_key`, the inverse of `map_hf_key`), Linear weights `(out, in)`, the
    patch embedding as the Conv3d `(O, C, T, P, P)`;
  * the [SEG] projection as `text_hidden_fcs.0.{0,2}.{weight,bias}`;
  * SAM2 under `grounding_encoder.sam2_model.` + the reference's names
    (`models.sam2.loader.reference_state_dict`, `.g_weight` as `.gamma`).
    This is a deliberate deviation: the JAX package's exporter writes flax
    paths joined by "." there (and a ConvTranspose kernel in flax's
    flipped layout), which no loader of either package reads, while its
    docstring promises the reference's names; the port writes those.

The file is written through `utils.safetensors_io` (no `safetensors`
package), one tensor at a time: a tensor on the card is cast to f32 and
copied to the host when its turn comes.
"""
from __future__ import annotations

import json
import os
import re
from collections.abc import Mapping
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from ..models.qwen25vl.loader import hf_key
from ..models.sam2.loader import reference_state_dict
from ..utils import safetensors_io

EXPORT_FILE = "model.safetensors"
MANIFEST = "rga3_export_manifest.json"
SAM2_PREFIX = "grounding_encoder.sam2_model."


def merge_lora(sd: Dict[str, torch.Tensor], lora_alpha: float, lora_rank: int
               ) -> Dict[str, torch.Tensor]:
    """A copy of state dict `sd` with every `<x>_lora_a` / `<x>_lora_b` pair
    folded into `<x>.weight` and dropped: `kernel + (alpha / r) * (a @ b)`
    in numpy float32 on the flax layout (kernel `(in, out)`, a `(in, r)`,
    b `(r, out)`), as the JAX package's `merge_lora` computes it, so that the
    merged bytes are its own; the merged weight is an f32 host tensor in
    the port's `(out, in)` layout. Other entries are kept as they are."""
    out = dict(sd)
    scale = lora_alpha / lora_rank
    for ka in [k for k in sd if k.endswith("_lora_a")]:
        base = ka[: -len("_lora_a")]
        kb, kw = base + "_lora_b", base + ".weight"
        if kb not in sd or kw not in sd:
            continue
        a = sd[ka].detach().cpu().float().numpy()
        b = sd[kb].detach().cpu().float().numpy()
        kernel = sd[kw].detach().cpu().float().numpy().T
        merged = kernel + scale * (a @ b)
        out[kw] = torch.from_numpy(np.ascontiguousarray(merged.T))
        del out[ka], out[kb]
    return out


def _source(model_or_state) -> Tuple[torch.nn.Module, Dict[str, torch.Tensor]]:
    """(the model, its state dict with the f32 masters where a state keeps
    them)."""
    if hasattr(model_or_state, "opt"):
        model, opt = model_or_state.model, model_or_state.opt
        sd = dict(model.state_dict())
        sd.update((name, opt.value(name)) for name in opt.master)
        return model, sd
    return model_or_state, dict(model_or_state.state_dict())


def merged_state_dict(model_or_state) -> Dict[str, torch.Tensor]:
    """The port's state dict of what the export writes: the masters where a
    state keeps them, q_proj / v_proj with their LoRA merged (`merge_lora`),
    no LoRA factors. Tensors stay where they are and in their dtype: the
    export casts each to f32 as it writes it."""
    model, sd = _source(model_or_state)
    text = model.cfg.qwen.text
    with torch.no_grad():
        return merge_lora(sd, text.lora_alpha, text.lora_rank) if text.lora_rank else sd


def _hf_entries(model, sd: Dict[str, torch.Tensor]
                ) -> Iterator[Tuple[str, str, Callable[[torch.Tensor], torch.Tensor]]]:
    """(HF name, port key, layout transform) of every exported entry."""
    vision = model.cfg.qwen.vision
    conv3d = (vision.in_channels, vision.temporal_patch_size, vision.patch_size,
              vision.patch_size)
    same = lambda t: t  # noqa: E731
    sam_keys = {k[len("grounding_encoder."):]: k for k in sd
                if k.startswith("grounding_encoder.")}
    for key in sd:
        if key.startswith("qwen."):
            name = hf_key(key[len("qwen."):])
            if name is None:
                raise ValueError(f"{key}: no HF name")
            fn = ((lambda t: t.reshape(t.shape[0], *conv3d))
                  if name == "visual.patch_embed.proj.weight" else same)
            yield name, key, fn
        elif key.startswith("text_hidden_fcs."):
            m = re.match(r"text_hidden_fcs\.fc([12])\.(weight|bias)$", key)
            if m is None:
                raise ValueError(f"{key}: no HF name")
            yield f"text_hidden_fcs.0.{0 if m.group(1) == '1' else 2}.{m.group(2)}", key, same
        elif not key.startswith("grounding_encoder."):
            raise ValueError(f"{key}: no HF name")
    # reference_state_dict renames the keys of a dict: here its values are
    # the port's full keys
    for ref, key in reference_state_dict(sam_keys).items():
        yield SAM2_PREFIX + ref, key, same


class _F32View(Mapping):
    """{HF name: tensor}: each entry read through its transform and cast
    to f32 when it is asked for (so the card never holds a second copy of
    the model)."""

    def __init__(self, entries: Dict[str, Tuple[torch.Tensor, Callable]]):
        self.entries = entries

    def __getitem__(self, name: str) -> torch.Tensor:
        t, fn = self.entries[name]
        return fn(t.detach()).float().contiguous()

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)


def export_hf_safetensors(model_or_state, out_dir: str) -> int:
    """Write the merged model of `model_or_state` (a `UniGR` or a
    `TrainState`) to `out_dir` as `model.safetensors` (f32, HF names) and
    `rga3_export_manifest.json`. Returns the number of tensors written."""
    model = model_or_state.model if hasattr(model_or_state, "opt") else model_or_state
    sd = merged_state_dict(model_or_state)
    entries = {name: (sd[key], fn) for name, key, fn in _hf_entries(model, sd)}
    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        safetensors_io.save_file(_F32View(entries), os.path.join(out_dir, EXPORT_FILE))
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump({"num_tensors": len(entries)}, f)
    return len(entries)
