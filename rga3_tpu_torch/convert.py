"""Weight bridge: the JAX package's flax parameter tree -> a PyTorch
`state_dict` for the port's modules.

The port's submodules carry the flax names (`blocks_3`, `attn_qkv`,
`layers_0`, ...), so a path `a/b/c/kernel` becomes the key `a.b.c.weight`
and only the leaves change:

  * Dense `kernel (in, out)` -> `weight (out, in)`;
  * Conv `kernel` HWIO -> OIHW; ConvTranspose `kernel (kh, kw, in, out)` ->
    `weight (in, out, kh, kw)` with the taps flipped, which is what
    torch's `conv_transpose2d` computes with flax's kernel;
  * LayerNorm / RMSNorm `scale` -> `weight`; Embed `embedding` -> `weight`;
  * Hiera's `pos_embed` / `pos_embed_window` NHWC -> NCHW;
  * raw parameters (LoRA `q_proj_lora_a` (in, r) / `*_lora_b` (r, out),
    `no_mem_embed`, the random positional matrix, ...) stay as they are.

Subtrees the ported path does not run yet (the SAM2 memory attention and
memory encoder, and their positional parameters) are dropped by name; any
other key the port lacks makes `load_state_dict(strict=True)` fail.
`load_params_npz` reads the flat `a/b/kernel` npz the JAX package's
exporter writes, with numpy alone.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

Tree = Mapping[str, Union[np.ndarray, "Tree"]]

# not on the ported path yet: the tracker's memory modules
SKIPPED = ("memory_attention", "memory_encoder", "maskmem_tpos_enc",
           "no_mem_pos_enc")
CONV_TRANSPOSE = ("output_upscaling_0", "output_upscaling_3")
NCHW_PARAMS = ("pos_embed", "pos_embed_window")


def _flatten(tree: Tree, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _leaf(path: tuple, x: np.ndarray):
    """(torch leaf name, array in torch layout) for one flax leaf."""
    name, parent = path[-1], path[-2] if len(path) > 1 else ""
    if any(p.endswith("_scan") for p in path):
        raise ValueError(
            f"{'/'.join(path)}: scanned (stacked) layers are not supported; "
            "unstack them first"
        )
    if name == "kernel":
        if x.ndim == 2:
            return "weight", x.T
        if x.ndim == 4 and parent in CONV_TRANSPOSE:
            return "weight", x[::-1, ::-1].transpose(2, 3, 0, 1)
        if x.ndim == 4:
            return "weight", x.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {x.ndim} at {'/'.join(path)}")
    if name in ("scale", "embedding"):
        return "weight", x
    if name in NCHW_PARAMS:
        return name, x.transpose(0, 3, 1, 2)
    return name, x


def torch_state_dict_from_flax(
    params: Tree, dtype: torch.dtype = torch.float32
) -> Dict[str, torch.Tensor]:
    """Nested numpy tree (optionally under a top-level "params") -> flat
    state_dict of `dtype` tensors."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    out = {}
    for path, x in _flatten(params).items():
        if any(p in SKIPPED for p in path):
            continue
        name, y = _leaf(path, x)
        key = ".".join(path[:-1] + (name,))
        out[key] = torch.from_numpy(np.ascontiguousarray(y)).to(dtype)
    return out


def load_params_npz(path: str) -> Dict[str, object]:
    """Flat `a/b/kernel` npz (f16 or f32 leaves) -> nested f32 numpy tree."""
    tree: Dict[str, object] = {}
    with np.load(path) as z:
        for key in z.files:
            arr = z[key]
            if arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return tree
