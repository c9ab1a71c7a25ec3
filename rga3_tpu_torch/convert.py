"""Weight bridge: the JAX package's flax parameter tree -> a PyTorch
`state_dict` for the port's modules.

The port's submodules carry the flax names (`blocks_3`, `attn_qkv`,
`layers_0`, ...), so a path `a/b/c/kernel` becomes the key `a.b.c.weight`
and only the leaves change:

  * Dense `kernel (in, out)` -> `weight (out, in)`; the DenseGeneral
    kernels of flax's `MultiHeadDotProductAttention` flattened to one:
    `query` / `key` / `value` `kernel (in, heads, head_dim)` -> `weight
    (heads * head_dim, in)` and `bias (heads, head_dim)` -> `(heads *
    head_dim,)`, `out` `kernel (heads, head_dim, out)` -> `weight (out,
    heads * head_dim)`;
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

Stacked layers (flax's `nn.scan`: `<base>_scan/<layer>/...` with a
leading layer axis, the JAX package's `scan_layers` / `scan_blocks`) map
onto the port's per-layer modules (`<base>_<i>`); `flax_tree_from_torch`
stacks them again for a module whose config scans (`flax_scan`).

Every subtree maps: a key the port lacks makes
`load_state_dict(strict=True)` fail. `flax_tree_from_torch` is the
inverse, from a module (whose types tell a Dense kernel from an Embed
table and a conv from a transposed conv; a port module that is not a
`torch.nn` layer names its flax layout in a `flax_kind` attribute:
"dense", "conv", "norm", or "heads_in" / "heads_out" with `heads`).
`load_flax_tree` fills a model (one cut to a rank's blocks too) from a
tree one leaf at a time. `load_params_npz` reads the flat `a/b/kernel` npz the JAX package's
exporter writes, `load_keystr_npz` the `keystr`-keyed npz of its tracker
weights (with or without a `__config__` entry), with numpy alone, and
`save_keystr_npz` writes one. `load_optax_state` carries the JAX
package's optimizer state (its optax AdamW's moments and counts, as numpy)
into the port's `MaskedAdamW`.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

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


SCAN = "_scan"  # flax's stacked layers: `<base>_scan/<layer>/...`


def _unstack(flat: Dict[tuple, np.ndarray]) -> Dict[tuple, np.ndarray]:
    """A flat tree with every stacked leaf `(..., <base>_scan, <layer>,
    ...)` split into its layers `(..., <base>_<i>, ...)`."""
    out = {}
    for path, x in flat.items():
        at = next((i for i, p in enumerate(path[:-2]) if p.endswith(SCAN)), None)
        if at is None:
            out[path] = x
            continue
        base = path[at][: -len(SCAN)]
        for i in range(x.shape[0]):
            out[path[:at] + (f"{base}_{i}",) + path[at + 2:]] = x[i]
    return out


def scan_position(model: torch.nn.Module, key: str) -> Optional[Tuple[str, int, int]]:
    """For a state-dict entry of a layer that the JAX package stacks (a
    module with `flax_scan`, such as `QwenLM` under `scan_layers`): (the
    entry's key with the layer's name replaced by the stacked path, as
    `<base>_scan.<layer>`, the layer's index, the number of layers); else
    None."""
    parts = key.split(".")
    module = model
    for i, part in enumerate(parts[:-1]):
        scan = getattr(module, "flax_scan", None)
        if scan is not None and part.startswith(scan[0]) and part[len(scan[0]):].isdigit():
            count = sum(1 for name, _ in module.named_children() if name.startswith(scan[0])
                        and name[len(scan[0]):].isdigit())
            stacked = scan[1].replace("/", ".")
            return (".".join(parts[:i] + [stacked] + parts[i + 1:]),
                    int(part[len(scan[0]):]), count)
        module = getattr(module, part)
    return None


def _stack_scanned(model: torch.nn.Module, tree: Dict[str, Any]) -> Dict[str, Any]:
    """`tree` (flax_tree_from_torch's, per layer) with the layers of each
    module with `flax_scan` stacked under the JAX package's scanned path."""
    for mpath, module in model.named_modules():
        scan = getattr(module, "flax_scan", None)
        if scan is None:
            continue
        node = tree
        for p in mpath.split(".") if mpath else ():
            node = node[p]
        prefix = scan[0]
        names = sorted((k for k in node if k.startswith(prefix) and k[len(prefix):].isdigit()),
                       key=lambda k: int(k[len(prefix):]))
        layers = [_flatten(node.pop(k)) for k in names]
        stacked: Dict[str, Any] = {}
        for leaf_path in layers[0]:
            sub = stacked
            for p in leaf_path[:-1]:
                sub = sub.setdefault(p, {})
            sub[leaf_path[-1]] = np.stack([layer[leaf_path] for layer in layers])
        outer, inner = scan[1].split("/")
        node[outer] = {inner: stacked}
    return tree


QUANT_LEAVES = ("kernel_q", "kernel_q4", "scale_g")
# flax's MultiHeadDotProductAttention: the DenseGeneral projections
HEAD_PROJECTIONS = ("query", "key", "value")


def _leaf(path: tuple, x: np.ndarray, quantized: bool = False):
    """(torch leaf name, array in torch layout) for one flax leaf;
    `quantized`: the leaf belongs to a quantized Dense."""
    name, parent = path[-1], path[-2] if len(path) > 1 else ""
    if quantized and (name in QUANT_LEAVES or name == "scale"):
        return name, x
    if any(p.endswith(SCAN) for p in path):
        raise ValueError(f"{'/'.join(path)}: a stacked leaf; `_unstack` the tree first")
    if name == "kernel":
        if x.ndim == 2:
            return "weight", x.T
        if x.ndim == 3 and parent in HEAD_PROJECTIONS:
            return "weight", x.reshape(x.shape[0], -1).T
        if x.ndim == 3 and parent == "out":
            return "weight", x.reshape(-1, x.shape[-1]).T
        if x.ndim == 4 and parent in CONV_TRANSPOSE:
            return "weight", x[::-1, ::-1].transpose(2, 3, 0, 1)
        if x.ndim == 4:
            return "weight", x.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {x.ndim} at {'/'.join(path)}")
    if name in ("scale", "embedding"):
        return "weight", x
    if name in NCHW_PARAMS:
        return name, x.transpose(0, 3, 1, 2)
    if name == "bias" and x.ndim == 2 and parent in HEAD_PROJECTIONS:
        return name, x.reshape(-1)
    return name, x


def torch_state_dict_from_flax(
    params: Tree, dtype: torch.dtype = torch.float32
) -> Dict[str, torch.Tensor]:
    """Nested numpy tree (optionally under a top-level "params") -> flat
    state_dict of `dtype` tensors."""
    if set(params.keys()) == {"params"}:
        params = params["params"]
    out = {}
    flat = _unstack(_flatten(params))
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


def _flax_layout(module: torch.nn.Module, parent: str, name: str, shape: Tuple[int, ...]):
    """(flax leaf name, the permutation of the torch dims into flax's or
    None, whether flax's first two dims are flipped, the flax shape) of
    state-dict entry `name` of `module` (at path `parent`) with torch shape
    `shape`: the inverse of `_leaf`."""
    kind = getattr(module, "flax_kind", None)
    leaf, perm, flip = name, None, False
    if name == "weight" and isinstance(module, torch.nn.Embedding):
        leaf = "embedding"
    elif name == "weight" and (isinstance(module, torch.nn.Linear)
                               or kind in ("dense", "heads_in", "heads_out")):
        leaf, perm = "kernel", (1, 0)
    elif name == "weight" and isinstance(module, torch.nn.ConvTranspose2d):
        leaf, perm, flip = "kernel", (2, 3, 0, 1), True
    elif name == "weight" and (isinstance(module, torch.nn.Conv2d) or kind == "conv"):
        leaf, perm = "kernel", (2, 3, 1, 0)
    elif name == "weight" and len(shape) == 1 and (
            kind == "norm" or FLAX_SCALE_NORMS.search(parent)):
        leaf = "scale"
    elif name in NCHW_PARAMS:
        perm = (0, 2, 3, 1)
    fshape = tuple(shape[i] for i in perm) if perm is not None else tuple(shape)
    if kind == "heads_in":  # (in, H * hd) / (H * hd,) -> (in, H, hd) / (H, hd)
        fshape = fshape[:-1] + (module.heads, fshape[-1] // module.heads)
    elif kind == "heads_out" and leaf == "kernel":  # (H * hd, out) -> (H, hd, out)
        fshape = (module.heads, fshape[0] // module.heads, fshape[1])
    return leaf, perm, flip, fshape


def _flax_leaf(module: torch.nn.Module, parent: str, name: str, t: torch.Tensor):
    """(flax leaf name, numpy array in flax layout) for one state-dict
    entry `name` of `module` (at path `parent`): the inverse of `_leaf`."""
    leaf, perm, flip, fshape = _flax_layout(module, parent, name, tuple(t.shape))
    x = t.detach().cpu()
    if perm is not None:
        x = x.permute(*perm)
    if flip:
        x = x.flip(0, 1)
    return leaf, x.reshape(fshape).numpy()


def flax_path_and_shape(model: torch.nn.Module, key: str, shape) -> Tuple[tuple, tuple]:
    """(flax parameter path without the top-level "params", flax shape) of
    state-dict entry `key` of `model` with torch shape `shape`. For a layer
    the JAX package stacks (`scan_position`), the path is the stacked
    leaf's and the shape one layer's."""
    parent, _, name = key.rpartition(".")
    module = model.get_submodule(parent) if parent else model
    leaf, _, _, fshape = _flax_layout(module, parent, name, tuple(shape))
    scanned = scan_position(model, key)
    if scanned is not None:
        parent = scanned[0].rpartition(".")[0]
    return tuple(parent.split(".") if parent else ()) + (leaf,), fshape


def torch_leaf(path: tuple, x: np.ndarray) -> np.ndarray:
    """A flax leaf at `path` (an unquantized model's; one layer's for a
    stacked path) in torch layout."""
    return _leaf(tuple(p for p in path if not p.endswith(SCAN)), x)[1]


@torch.no_grad()
def load_flax_tree(model: torch.nn.Module, params: Tree, dtype: torch.dtype = None) -> None:
    """Fill `model` from a nested numpy flax tree (optionally under
    "params"), one leaf at a time: each leaf converted to the torch layout
    (`torch_state_dict_from_flax`'s rules) and, in a model cut by
    `parallel.fsdp.shard_model`, only the rank's block of it kept, so that
    no rank holds the whole tree's tensors at once. `dtype` (default: each
    entry's own) for the float leaves. Raises KeyError for a leaf the model
    lacks and ValueError for a missing entry or a shape that differs."""
    from .parallel.fsdp import state_entries_one

    if set(params.keys()) == {"params"}:
        params = params["params"]
    plan = getattr(model, "shard_plan", None)
    flat = _unstack(_flatten(params))
    quant = {p[:-1] for p in flat if p[-1] in QUANT_LEAVES}
    seen = set()
    for path, x in flat.items():
        name, y = _leaf(path, x, path[:-1] in quant)
        key = ".".join(path[:-1] + (name,))
        target = state_entries_one(model, key)
        shape = plan.blocks[key].full_shape if plan is not None else tuple(target.shape)
        if tuple(y.shape) != tuple(shape):
            raise ValueError(f"{key}: {tuple(y.shape)} in the tree, {tuple(shape)} in the model")
        t = torch.from_numpy(np.require(y, requirements=["C", "W"]))
        t = t.to(target.dtype if dtype is None or not target.is_floating_point() else dtype)
        if plan is not None:
            plan.load_(model, key, t)
        else:
            target.copy_(t)
        seen.add(key)
    missing = set(model.state_dict()) - seen
    if missing:
        raise ValueError(f"the tree has no leaf for {sorted(missing)[:5]}")


def flax_tree_from_torch(model: torch.nn.Module) -> Dict[str, Any]:
    """The JAX package's nested numpy parameter tree (without the top-level
    "params") of a port module: float leaves in f32, the quantized layers'
    int8 kernels and f32 scales as they are. A model cut by
    `parallel.fsdp.shard_model` gives its whole tensors, gathered (every
    rank calls it together)."""
    from .parallel.fsdp import whole_state_dict

    tree: Dict[str, Any] = {}
    for key, t in whole_state_dict(model).items():
        parent, _, name = key.rpartition(".")
        module = model.get_submodule(parent) if parent else model
        if t.is_floating_point():
            t = t.float()
        leaf, arr = _flax_leaf(module, parent, name, t)
        node = tree
        for p in parent.split(".") if parent else ():
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(arr, order="C")
    return _stack_scanned(model, tree)


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


def load_keystr_npz(path: str) -> Tuple[Dict[str, object], Optional[Dict[str, Any]]]:
    """An npz keyed by `jax.tree_util.keystr` paths
    (`"['params']['fnet']['conv1']['kernel']"`), with or without a
    `__config__` JSON entry -> (nested f32 numpy tree, the config dict or
    None); f16 leaves are read as f32."""
    tree: Dict[str, object] = {}
    config = None
    with np.load(path) as z:
        for key in z.files:
            if key == "__config__":
                config = json.loads(bytes(z["__config__"].tobytes()).decode())
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


def save_keystr_npz(path: str, model_or_tree, config: Optional[Dict[str, Any]] = None,
                    dtype=np.float32) -> None:
    """A port module's parameters (`flax_tree_from_torch`'s layout), or a
    nested numpy flax tree (optionally under "params"), as the JAX
    package's flat npz keyed by `jax.tree_util.keystr` paths under
    "params": f32 leaves stored as `dtype`, and `config` as a `__config__`
    JSON entry when given."""
    if isinstance(model_or_tree, torch.nn.Module):
        tree = flax_tree_from_torch(model_or_tree)
    else:
        tree = model_or_tree
        if set(tree.keys()) == {"params"}:
            tree = tree["params"]
    arrays = {}
    for leaf_path, arr in _flatten(tree).items():
        key = "".join(f"['{p}']" for p in ("params",) + leaf_path)
        arrays[key] = arr.astype(dtype) if arr.dtype == np.float32 else arr
    if config is not None:
        arrays["__config__"] = np.frombuffer(json.dumps(config).encode(), np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def _drop_empty(tree):
    """A nested tree without its masked-out leaves: None, or optax's
    `MaskedNode` (an empty named tuple)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            sub = _drop_empty(v)
            if sub:
                out[k] = sub
        elif v is not None and not (isinstance(v, tuple) and len(v) == 0):
            out[k] = v
    return out


def _moment_tensors(tree: Tree) -> Dict[str, np.ndarray]:
    """{torch parameter name: f32 array in torch layout} of a moment tree in
    the parameters' flax layout (optionally under "params")."""
    tree = _drop_empty(tree)
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, x in _unstack(_flatten(tree)).items():
        name, y = _leaf(path, np.asarray(x).astype(np.float32))
        out[".".join(path[:-1] + (name,))] = np.ascontiguousarray(y)
    return out


@torch.no_grad()
def load_optax_state(opt, state: Mapping[str, Any]) -> None:
    """Carry the JAX package's optimizer state into `opt` (a
    `train.optimizer.MaskedAdamW` over the same trainable parameters), in
    place. `state` holds, as numpy, the "train" branch of its
    `multi_transform`: {"train": {"mu": tree, "nu": tree, "count": the
    `ScaleByAdamState` count, "schedule_count": the `ScaleByScheduleState`
    count}}, the trees in the parameters' flax layout (frozen leaves None,
    optax's empty `MaskedNode`, or left out). `mu` is cast to the optimizer's `adam_mu_dtype` (exact from a
    bfloat16 state) and `nu` to its parameters' dtype; each rank takes its
    blocks where the optimizer shards a tensor. The parameters themselves
    come through `torch_state_dict_from_flax`. Raises KeyError for a missing
    branch or entry, and ValueError when the names, the shapes or the two
    counts disagree."""
    if "train" not in state:
        raise KeyError(f"the optax state has no 'train' branch (got {sorted(state)})")
    train = state["train"]
    for key in ("mu", "nu", "count", "schedule_count"):
        if key not in train:
            raise KeyError(f"the optax state's 'train' branch has no {key!r}")
    count, sched = int(np.asarray(train["count"])), int(np.asarray(train["schedule_count"]))
    if count != sched:
        raise ValueError(f"Adam's count {count} and the schedule's {sched} differ: the port "
                         "keeps one count")
    moments = {"mu": _moment_tensors(train["mu"]), "nu": _moment_tensors(train["nu"])}
    for kind, tensors in moments.items():
        if set(tensors) != set(opt.params):
            diff = sorted(set(tensors) ^ set(opt.params))[:5]
            raise ValueError(f"the optax {kind} and the trainable parameters differ: {diff}")
        for name, x in tensors.items():
            shape = (opt.plan.blocks[name].full_shape if opt.plan is not None
                     else tuple(opt.params[name].shape))
            if tuple(x.shape) != tuple(shape):
                raise ValueError(f"{kind} of {name}: shape {tuple(x.shape)} in the optax state, "
                                 f"{tuple(shape)} in the model")
    for kind, tensors in moments.items():
        target = getattr(opt, kind)
        for name, x in tensors.items():
            t = opt.tensor_block(name, torch.from_numpy(x))
            target[name].copy_(opt.shard(name, t).to(target[name].dtype))
    opt.count = count
