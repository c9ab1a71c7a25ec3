"""Each rank's blocks of a model over the mesh, and the frozen weights
sharded over fsdp (the JAX package's `make_train_state(..., mesh)` shards
every leaf, frozen ones too).

`shard_model(model, mesh, trainable=...)` cuts every state entry (the
parameters and the quantized layers' buffers) to what this rank keeps, in
place, and returns the `ShardPlan` it also leaves in `model.shard_plan`:

  * a leaf the tensor axis shards (`parallel.sharding` + `parallel.tensor`)
    keeps the rank's tensor block;
  * a frozen leaf the fsdp axis shards keeps, within that, the rank's fsdp
    block, when it lies in one of the gathered blocks below; a trainable
    one stays whole over fsdp (its optimizer state is sharded:
    `train.optimizer.MaskedAdamW`, ZeRO-2);
  * the rest stays whole. The frozen leaves outside the gathered blocks
    (SAM2's prompt encoder, the object pointer projection and its raw
    embeddings) are under 1 MB at Hiera-L.

A model built on the meta device gets empty blocks on `device`: the caller
then fills them one whole leaf at a time (`ShardPlan.load_`), so that no
rank ever holds the whole model.

The gathered blocks are one LM decoder layer, the LM's final norm, its
embedding and head, one vision block (and the tower's patch embedding and
merger), one Hiera block (and the trunk's patch embedding and positional
embeddings), the FPN neck, one memory-attention layer (and its final norm)
and the memory encoder. A block's frozen leaves are all-gathered over
fsdp just before its module runs and dropped after it: the module's
entries are swapped for the gathered tensors (new objects; the rank's
block goes back after). The backward needs them again: inside the LM's
remat recompute the layer's forward gathers them anew; elsewhere, under
autograd, the block runs under `saved_tensors_hooks` that save a gathered
weight (or a view of it) as a recipe and all-gather it again when the
backward reads it, so no gathered block lives until the backward.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from .distributed import all_gather_along
from .sharding import infer_param_sharding, state_entries
from . import tensor as tensor_axis


@dataclass
class Block:
    """How a rank stores one state entry: the whole shape, the tensor
    dimension and (parts, index) of the block it keeps along it (None:
    whole over tensor), the rule's fsdp dimension, and whether the rank
    keeps only its fsdp block (a frozen leaf in a gathered block)."""

    full_shape: Tuple[int, ...]
    tensor_dim: Optional[int]
    tensor: Optional[Tuple[int, int]]
    fsdp_dim: Optional[int]
    fsdp_stored: bool


def _narrow(t: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    per = t.shape[dim] // parts
    return t.narrow(dim, index * per, per)


def _kept(b: Block, whole: torch.Tensor, fsdp: int, fsdp_index: int) -> torch.Tensor:
    """What a rank keeps of a whole tensor stored as `b` (a view)."""
    t = whole if b.tensor is None else _narrow(whole, b.tensor_dim, *b.tensor)
    return _narrow(t, b.fsdp_dim, fsdp, fsdp_index) if b.fsdp_stored else t


class ShardPlan:
    """The blocks of every state entry of a sharded model (`blocks`), the
    mesh, and the trainable tensors whose gradients the tensor ranks hold in
    part (`partial`)."""

    def __init__(self, mesh, blocks: Dict[str, Block], partial: set):
        self.mesh, self.blocks, self.partial = mesh, blocks, partial
        self.fsdp = mesh.shape.get("fsdp", 1)
        self.fsdp_index = mesh.coords[1]

    def tensor_block(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """The rank's tensor block of a whole tensor of `name` (a view)."""
        b = self.blocks[name]
        if b.tensor is None:
            return whole
        return _narrow(whole, b.tensor_dim, *b.tensor)

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """What the rank keeps of a whole tensor of `name` (a view)."""
        return _kept(self.blocks[name], whole, self.fsdp, self.fsdp_index)

    def tensor_whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of `name` from the rank's tensor block `t`,
        gathered over the tensor group (every rank calls it together)."""
        b = self.blocks[name]
        if b.tensor is None:
            return t
        axis = self.mesh.shape["tensor"]
        every = all_gather_along(t, b.tensor_dim, self.mesh.group("tensor"))
        parts, _ = b.tensor
        if parts == axis:
            return every
        # blocks that several ranks hold (whole KV heads): one of each
        share = axis // parts
        return torch.cat([_narrow(every, b.tensor_dim, axis, j * share)
                          for j in range(parts)], b.tensor_dim)

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of `name` from what the rank keeps (`t`):
        gathered over fsdp and tensor (every rank calls it together)."""
        b = self.blocks[name]
        if b.fsdp_stored:
            t = all_gather_along(t, b.fsdp_dim, self.mesh.group("fsdp"))
        return self.tensor_whole(name, t)

    @torch.no_grad()
    def load_(self, model: nn.Module, name: str, whole: torch.Tensor) -> None:
        """Copy the rank's block of a whole tensor of `name` into `model`."""
        target = state_entries_one(model, name)
        target.copy_(self.local(name, whole.to(target.device)))


def state_entries_one(model: nn.Module, name: str) -> torch.Tensor:
    parent, _, leaf = name.rpartition(".")
    owner = model.get_submodule(parent) if parent else model
    t = owner._parameters.get(leaf)
    return t if t is not None else owner._buffers[leaf]


class _Regather:
    """A saved gathered weight, as the recipe to gather it again."""

    def __init__(self, unit: "_Unit", index: int, t: torch.Tensor):
        self.unit, self.index = unit, index
        self.view = (t.size(), t.stride(), t.storage_offset())

    def get(self) -> torch.Tensor:
        full = self.unit.gather(self.index)
        return full.as_strided(*self.view)


class _Unit:
    """One gathered block: its frozen fsdp-stored entries (owner module,
    leaf name, is a parameter, fsdp dim) gathered in its forward."""

    def __init__(self, group, saved_hooks: bool = True):
        self.group, self.saved_hooks = group, saved_hooks
        self.entries: List[Tuple[nn.Module, str, bool, int]] = []
        self.swapped: List[Tuple[nn.Module, str, bool, torch.Tensor]] = []
        self.live: Dict[int, int] = {}
        self.hooks = None
        self.depth = 0

    def gather(self, index: int) -> torch.Tensor:
        owner, leaf, is_param, dim = self.entries[index]
        store = owner._parameters if is_param else owner._buffers
        return all_gather_along(store[leaf], dim, self.group)

    def pre(self, *_):
        self.depth += 1
        if self.depth > 1:
            return
        for i, (owner, leaf, is_param, dim) in enumerate(self.entries):
            store = owner._parameters if is_param else owner._buffers
            shard = store[leaf]
            full = all_gather_along(shard, dim, self.group)
            store[leaf] = nn.Parameter(full, requires_grad=False) if is_param else full
            self.swapped.append((owner, leaf, is_param, shard))
            self.live[full.untyped_storage().data_ptr()] = i
        if self.saved_hooks and torch.is_grad_enabled():
            self.hooks = torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)
            self.hooks.__enter__()

    def post(self, *_):
        self.depth -= 1
        if self.depth > 0:
            return
        if self.hooks is not None:
            self.hooks.__exit__(None, None, None)
            self.hooks = None
        for owner, leaf, is_param, shard in self.swapped:
            (owner._parameters if is_param else owner._buffers)[leaf] = shard
        self.swapped, self.live = [], {}

    def _pack(self, t):
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return t
        index = self.live.get(t.untyped_storage().data_ptr())
        return t if index is None else _Regather(self, index, t)

    @staticmethod
    def _unpack(x):
        return x.get() if isinstance(x, _Regather) else x


def _unit_modules(model: nn.Module) -> Dict[str, nn.Module]:
    """{path: module} of the gathered blocks of `model`."""
    from ..models.qwen25vl.language import DecoderLayer, QwenForCausalLM, QwenLM
    from ..models.qwen25vl.vision import QwenVisionTower, VisionBlock
    from ..models.sam2.hiera import Hiera, MultiScaleBlock
    from ..models.sam2.memory import MemoryAttention, MemoryAttentionLayer, MemoryEncoder
    from ..models.sam2.neck import FpnNeck

    kinds = (DecoderLayer, QwenLM, QwenVisionTower, VisionBlock, Hiera, MultiScaleBlock,
             FpnNeck, MemoryAttention, MemoryAttentionLayer, MemoryEncoder)
    out = {}
    for path, mod in model.named_modules():
        if isinstance(mod, kinds):
            out[path] = mod
        elif isinstance(mod, QwenForCausalLM):
            pre = f"{path}." if path else ""
            out[pre + "embed_tokens"] = mod.embed_tokens
            if not mod.cfg.tie_word_embeddings:
                out[pre + "lm_head"] = mod.lm_head
    return out


def _owner_unit(units: Dict[str, nn.Module], parent: str) -> Optional[str]:
    """The innermost gathered block holding module path `parent`."""
    best = None
    for path in units:
        if (path == parent or path == "" or parent.startswith(path + ".")) and (
                best is None or len(path) > len(best)):
            best = path
    return best


def _remat_layers(model: nn.Module) -> set:
    """Decoder layers that run under the LM's remat (their recompute
    gathers again: no saved-tensor hooks there)."""
    from ..models.qwen25vl.language import QwenLM

    out = set()
    for path, mod in model.named_modules():
        if isinstance(mod, QwenLM) and mod.remat != "none":
            pre = f"{path}." if path else ""
            out.update(f"{pre}layers_{i}" for i in range(mod.cfg.num_hidden_layers))
    return out


@torch.no_grad()
def shard_model(model: nn.Module, mesh, trainable: Callable[[str], bool] = lambda n: False,
                device=None) -> ShardPlan:
    """Cut `model` to this rank's blocks over `mesh` in place (see the
    module doc) and return the plan (also `model.shard_plan`). `trainable`
    names the tensors that stay whole over fsdp. Entries on the meta device become empty blocks
    on `device`; the others are cut from their values. Raises ValueError
    for a tensor size the LM cannot compute over."""
    if getattr(model, "shard_plan", None) is not None:
        raise ValueError("the model is sharded already")
    rule = infer_param_sharding(model, mesh)
    t, f = mesh.shape.get("tensor", 1), mesh.shape.get("fsdp", 1)
    tblocks = {}
    if t > 1:
        axis = tensor_axis.TensorAxis(mesh.group("tensor"), t, mesh.coords[2])
        tblocks = tensor_axis.setup(model, axis, rule)
    units = _unit_modules(model) if f > 1 else {}
    remat = _remat_layers(model)
    gathered: Dict[str, _Unit] = {}
    blocks = {}
    for name, x in state_entries(model).items():
        tdim, fdim = rule[name]
        tb = tblocks.get(name)
        parent, _, leaf = name.rpartition(".")
        unit = _owner_unit(units, parent) if fdim is not None and not trainable(name) else None
        b = Block(tuple(x.shape), tdim if tb else None, tb, fdim, unit is not None)
        blocks[name] = b
        owner = model.get_submodule(parent) if parent else model
        is_param = leaf in owner._parameters
        if b.tensor is not None or b.fsdp_stored or x.is_meta:
            if x.is_meta:
                shape = list(x.shape)
                if b.tensor is not None:
                    shape[b.tensor_dim] //= b.tensor[0]
                if b.fsdp_stored:
                    shape[fdim] //= f
                new = torch.empty(shape, dtype=x.dtype, device=device)
            else:
                new = _kept(b, x.detach(), f, mesh.coords[1]).clone(
                    memory_format=torch.contiguous_format)
            if is_param:
                owner._parameters[leaf] = nn.Parameter(new, requires_grad=x.requires_grad)
            else:
                owner._buffers[leaf] = new
        if unit is not None:
            if unit not in gathered:
                gathered[unit] = _Unit(mesh.group("fsdp"), saved_hooks=unit not in remat)
            gathered[unit].entries.append((owner, leaf, is_param, fdim))
    for path, unit in gathered.items():
        mod = units[path]
        mod.register_forward_pre_hook(unit.pre)
        mod.register_forward_hook(unit.post, always_call=True)
        mod.fsdp_unit = unit
    plan = ShardPlan(mesh, blocks, tensor_axis.partial_gradients(model) if t > 1 else set())
    model.shard_plan = plan
    return plan


@contextlib.contextmanager
def gathered(module: nn.Module):
    """`module`'s frozen fsdp blocks gathered whole inside the block (for a
    read of its weights outside its forward: the tied head); nothing for a
    module without them."""
    unit = getattr(module, "fsdp_unit", None)
    if unit is None:
        yield
        return
    unit.pre()
    try:
        yield
    finally:
        unit.post()


def whole_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict, each entry whole: gathered over fsdp and
    tensor where `shard_model` cut it (every rank calls it together)."""
    plan = getattr(model, "shard_plan", None)
    sd = dict(model.state_dict())
    if plan is None:
        return sd
    return {name: plan.whole(name, t) for name, t in sd.items()}


def frozen_bytes(model: nn.Module) -> Dict[str, int]:
    """Bytes of the frozen state entries a rank holds: in all, and of those
    it keeps whole over fsdp while the rule gives them an fsdp dimension
    (outside the gathered blocks)."""
    plan = getattr(model, "shard_plan", None)
    held = outside = 0
    for name, x in state_entries(model).items():
        if isinstance(x, nn.Parameter) and x.requires_grad:
            continue
        n = x.numel() * x.element_size()
        held += n
        if plan is not None and plan.blocks[name].fsdp_dim is not None \
                and not plan.blocks[name].fsdp_stored:
            outside += n
    return {"held": held, "whole_over_fsdp": outside}
