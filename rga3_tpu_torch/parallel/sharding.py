"""Which dimensions of each tensor the tensor and fsdp axes shard,
counterpart of `rga3_tpu/parallel/sharding.py` (the JAX package's whole rule).

The JAX package reads the logical names a leaf carries (`LOGICAL_RULES`:
`vocab`, `mlp` and `heads` onto `tensor`) and puts `tensor` on the first
named dimension that maps to it and that the tensor size divides; then
`fsdp` on the largest other dimension that fsdp divides (`_fsdp_spec`), in
flax's layout. A leaf without names (LoRA A / B, the biases, the norms, the
vision tower, SAM2, `text_hidden_fcs`) gets fsdp only.

The port decides in the same layout: its LM modules carry JAX's names in a
`logical_axes` attribute (the flax kernel's axes; an int8 `scale` takes the
last of them, an int4 `scale_g` (None, the last)), each tensor's flax shape
comes from `convert._flax_layout`, and JAX's choices there are mapped back
to the torch dimensions they came from. A flax dimension that is part of a
merged torch dimension but not its leading part (the head dim of flax's
DenseGeneral kernels, none of them in the LM) has no contiguous torch block:
such a tensor is not sharded on it. Every leaf is covered, frozen ones too:
the trainable state is sharded over fsdp by `train.optimizer.MaskedAdamW`
(ZeRO-2), the frozen weights by `parallel.fsdp.shard_model`, and the LM's
named leaves over tensor (`parallel.tensor`).

`shard_batch_spec` names the axes that split a batch's rows, and
`parallel.mesh.batch_axes` the JAX script's rule for a micro-batch that they
may not divide.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..convert import _flax_layout

# logical axis name -> mesh axis (the JAX package's LOGICAL_RULES)
LOGICAL_RULES = (
    ("vocab", "tensor"),
    ("mlp", "tensor"),
    ("heads", "tensor"),
    ("embed", None),
)
# flax leaves that carry their module's kernel axes
KERNEL_LEAVES = ("kernel", "kernel_q", "kernel_q4", "embedding")


def _fsdp_dim(shape: Sequence[int], fsdp: int, tensor_axis: Optional[int] = None
              ) -> Optional[int]:
    """The largest dimension `fsdp` divides (the first of equal sizes),
    skipping `tensor_axis`; None when fsdp <= 1 or no dimension fits."""
    if fsdp <= 1 or not shape:
        return None
    for i in sorted(range(len(shape)), key=lambda i: shape[i], reverse=True):
        if i != tensor_axis and shape[i] % fsdp == 0 and shape[i] >= fsdp:
            return i
    return None


def logical_names(module: nn.Module, leaf: str) -> Optional[Tuple]:
    """The logical names of flax leaf `leaf` of `module` (None: unnamed)."""
    axes = getattr(module, "logical_axes", None)
    if axes is None:
        return None
    if leaf in KERNEL_LEAVES:
        return tuple(axes)
    if leaf == "scale":
        return tuple(axes[-1:])
    if leaf == "scale_g":
        return (None, axes[-1])
    return None


def _tensor_dim(shape: Sequence[int], names: Optional[Tuple], tensor: int) -> Optional[int]:
    if names is None or tensor <= 1:
        return None
    rules = dict(LOGICAL_RULES)
    for i, name in enumerate(names):
        if rules.get(name) == "tensor" and shape[i] % tensor == 0:
            return i
    return None


def _torch_dims(module: nn.Module, parent: str, name: str, shape: Sequence[int],
                fsdp: int, tensor: int = 1) -> Tuple[Optional[int], Optional[int]]:
    """(tensor dim, fsdp dim) in torch dimensions of state entry `name` of
    `module` (at path `parent`) with torch shape `shape`."""
    leaf, perm, _, fshape = _flax_layout(module, parent, name, tuple(shape))
    tdim = _tensor_dim(fshape, logical_names(module, leaf), tensor)
    fdim = _fsdp_dim(fshape, fsdp, tdim)
    kind = getattr(module, "flax_kind", None)
    k = len(shape) - 1
    # the flax dim -> the dim of the permuted torch tensor, where the heads
    # split one permuted dim in two (only its leading part is contiguous)
    if kind == "heads_in":  # (..., H * hd) -> (..., H, hd)
        owner = {**{i: i for i in range(k + 1)}, k + 1: None}
    elif kind == "heads_out" and leaf == "kernel":  # (H * hd, out) -> (H, hd, out)
        owner = {0: 0, 1: None, 2: 1}
    else:
        owner = {i: i for i in range(len(fshape))}

    def back(fd):
        if fd is None or owner[fd] is None:
            return None
        return perm[owner[fd]] if perm is not None else owner[fd]

    return back(tdim), back(fdim)


def state_entries(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{state-dict name: its tensor} of the parameters and persistent buffers."""
    out = dict(model.named_parameters())
    for mod_name, mod in model.named_modules():
        for name, buf in mod._buffers.items():
            if buf is not None and name not in mod._non_persistent_buffers_set:
                out[f"{mod_name}.{name}" if mod_name else name] = buf
    return out


def infer_param_sharding(model: nn.Module, mesh, names: Optional[Iterable[str]] = None
                         ) -> Dict[str, Tuple[Optional[int], Optional[int]]]:
    """{state name: (the torch dimension the tensor axis of `mesh` shards,
    the one its fsdp axis shards), each None where the axis shards none}
    for `names` (every parameter and persistent buffer when None), decided
    on the whole shapes (a cut model's are its shard plan's)."""
    fsdp, tensor = mesh.shape.get("fsdp", 1), mesh.shape.get("tensor", 1)
    entries = state_entries(model)
    plan = getattr(model, "shard_plan", None)
    out = {}
    for key in (entries if names is None else names):
        parent, _, name = key.rpartition(".")
        module = model.get_submodule(parent) if parent else model
        shape = plan.blocks[key].full_shape if plan is not None else entries[key].shape
        out[key] = _torch_dims(module, parent, name, shape, fsdp, tensor)
    return out


def shard_batch_spec(mesh):
    """The axes every batch row is split over: ("data", "fsdp") when both
    are larger than 1, else "fsdp" when it is, else "data"."""
    shape = mesh.shape
    if shape.get("fsdp", 1) > 1 and shape.get("data", 1) > 1:
        return ("data", "fsdp")
    if shape.get("fsdp", 1) > 1:
        return "fsdp"
    return "data"
