"""Which dimension of each tensor the fsdp axis shards, counterpart of
`rga3_tpu/parallel/sharding.py`.

The JAX package shards each leaf over `fsdp` on its largest dimension that
the axis divides (`_fsdp_spec`), in flax's layout. The port decides in the
same layout: it reads each tensor's flax shape (`convert._flax_layout`),
takes JAX's choice there and maps it back to the torch dimension it came
from. A flax dimension that is part of a merged torch dimension but not its
leading part (the head dim of flax's DenseGeneral kernels, none of them
trainable) has no contiguous torch block: such a tensor is not sharded.
The port shards the trainable state and the gradients (ZeRO-2,
`train.optimizer.MaskedAdamW`); the frozen weights stay whole on every rank.

`shard_batch_spec` names the axes that split a batch's rows, and
`parallel.mesh.batch_axes` the JAX script's rule for a micro-batch that they
may not divide. The tensor axis is not ported (`make_mesh` raises).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch.nn as nn

from ..convert import _flax_layout


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


def _torch_dim(module: nn.Module, parent: str, name: str, shape: Sequence[int],
               fsdp: int) -> Optional[int]:
    leaf, perm, _, fshape = _flax_layout(module, parent, name, tuple(shape))
    fdim = _fsdp_dim(fshape, fsdp)
    if fdim is None:
        return None
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
    pdim = owner[fdim]
    if pdim is None:
        return None
    return perm[pdim] if perm is not None else pdim


def infer_param_sharding(model: nn.Module, mesh, names: Optional[Iterable[str]] = None
                         ) -> Dict[str, Optional[int]]:
    """{parameter name: the torch dimension the fsdp axis of `mesh` shards,
    or None} for `names` (every parameter when None)."""
    fsdp = mesh.shape.get("fsdp", 1)
    params = dict(model.named_parameters())
    out = {}
    for key in (params if names is None else names):
        parent, _, name = key.rpartition(".")
        module = model.get_submodule(parent) if parent else model
        out[key] = _torch_dim(module, parent, name, params[key].shape, fsdp)
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
