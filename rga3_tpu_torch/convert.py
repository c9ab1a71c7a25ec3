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
    `no_mem_embed`, the random positional matrix, ...) stay as they are;
  * quantized Dense leaves (`ops.quant`'s layout, which the port's
    `QuantLinear` keeps) stay as they are and keep their dtypes:
    `kernel_q` / `kernel_q4` int8 (in, out) / (in/2, out), untransposed,
    and `scale` / `scale_g` f32 (a `scale` beside a `kernel_q` is not a
    norm's). Every other leaf is cast to `dtype`.

Every subtree maps: a key the port lacks makes
`load_state_dict(strict=True)` fail. `flax_tree_from_torch` is the
inverse, from a module (whose types tell a Dense kernel from an Embed
table and a conv from a transposed conv).
`load_params_npz` reads the flat `a/b/kernel` npz the JAX package's
exporter writes, and `load_keystr_npz` the self-describing `keystr`-keyed
npz of its CoTracker3 weights, with numpy alone.
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch

Tree = Mapping[str, Union[np.ndarray, "Tree"]]

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


QUANT_LEAVES = ("kernel_q", "kernel_q4", "scale_g")


def _leaf(path: tuple, x: np.ndarray, quantized: bool = False):
    """(torch leaf name, array in torch layout) for one flax leaf;
    `quantized`: the leaf belongs to a quantized Dense."""
    name, parent = path[-1], path[-2] if len(path) > 1 else ""
    if quantized and (name in QUANT_LEAVES or name == "scale"):
        return name, x
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
    flat = _flatten(params)
    quant = {p[:-1] for p in flat if p[-1] in QUANT_LEAVES}
    for path, x in flat.items():
        quantized = path[:-1] in quant
        name, y = _leaf(path, x, quantized)
        key = ".".join(path[:-1] + (name,))
        t = torch.from_numpy(np.require(y, requirements=["C", "W"]))
        if name in ("kernel_q", "kernel_q4"):
            out[key] = t.to(torch.int8)
        elif quantized and name in ("scale", "scale_g"):
            out[key] = t.to(torch.float32)
        else:
            out[key] = t.to(dtype)
    return out


# flax's nn.LayerNorm names its weight `scale`: in UniGR only the Hiera
# trunk's block norms; every other norm is the JAX package's own module,
# whose weight is `weight`
FLAX_SCALE_NORMS = re.compile(r"(^|\.)image_encoder\.trunk\.blocks_\d+\.norm[12]$")


def _flax_layout(module: torch.nn.Module, parent: str, name: str, ndim: int):
    """(flax leaf name, the permutation of the torch dims into flax's or
    None, whether flax's first two dims are flipped) of state-dict entry
    `name` of `module` (at path `parent`): the inverse of `_leaf`."""
    if name == "weight" and isinstance(module, torch.nn.Embedding):
        return "embedding", None, False
    if name == "weight" and isinstance(module, torch.nn.Linear):
        return "kernel", (1, 0), False
    if name == "weight" and isinstance(module, torch.nn.ConvTranspose2d):
        return "kernel", (2, 3, 0, 1), True
    if name == "weight" and isinstance(module, torch.nn.Conv2d):
        return "kernel", (2, 3, 1, 0), False
    if name == "weight" and ndim == 1 and FLAX_SCALE_NORMS.search(parent):
        return "scale", None, False
    if name in NCHW_PARAMS:
        return name, (0, 2, 3, 1), False
    return name, None, False


def _flax_leaf(module: torch.nn.Module, parent: str, name: str, t: torch.Tensor):
    """(flax leaf name, numpy array in flax layout) for one state-dict
    entry `name` of `module` (at path `parent`): the inverse of `_leaf`."""
    leaf, perm, flip = _flax_layout(module, parent, name, t.dim())
    x = t.detach().cpu()
    if perm is not None:
        x = x.permute(*perm)
    if flip:
        x = x.flip(0, 1)
    return leaf, x.numpy()


def flax_path_and_shape(model: torch.nn.Module, key: str, shape) -> Tuple[tuple, tuple]:
    """(flax parameter path without the top-level "params", flax shape) of
    state-dict entry `key` of `model` with torch shape `shape`."""
    parent, _, name = key.rpartition(".")
    module = model.get_submodule(parent) if parent else model
    leaf, perm, _ = _flax_layout(module, parent, name, len(shape))
    fshape = tuple(shape[i] for i in perm) if perm is not None else tuple(shape)
    return tuple(parent.split(".") if parent else ()) + (leaf,), fshape


def torch_leaf(path: tuple, x: np.ndarray) -> np.ndarray:
    """A flax leaf at `path` (an unquantized model's) in torch layout."""
    return _leaf(path, x)[1]


def flax_tree_from_torch(model: torch.nn.Module) -> Dict[str, Any]:
    """The JAX package's nested numpy parameter tree (without the top-level
    "params") of a port module: float leaves in f32, the quantized layers'
    int8 kernels and f32 scales as they are."""
    tree: Dict[str, Any] = {}
    for key, t in model.state_dict().items():
        parent, _, name = key.rpartition(".")
        module = model.get_submodule(parent) if parent else model
        if t.is_floating_point():
            t = t.float()
        leaf, arr = _flax_leaf(module, parent, name, t)
        node = tree
        for p in parent.split(".") if parent else ():
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(arr, order="C")
    return tree


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


def load_keystr_npz(path: str) -> Tuple[Dict[str, object], Dict[str, Any]]:
    """An npz keyed by `jax.tree_util.keystr` paths
    (`"['params']['fnet']['conv1']['kernel']"`) with a `__config__` JSON
    entry -> (nested f32 numpy tree, the config dict); f16 leaves are read
    as f32."""
    tree: Dict[str, object] = {}
    with np.load(path) as z:
        config = json.loads(bytes(z["__config__"].tobytes()).decode())
        for key in z.files:
            if key == "__config__":
                continue
            parts = re.findall(r"\['([^']*)'\]", key)
            if not parts or "".join(f"['{p}']" for p in parts) != key:
                raise ValueError(f"{path}: {key!r} is not a keystr path")
            arr = z[key]
            if arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return tree, config
