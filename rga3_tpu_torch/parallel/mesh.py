"""The ranks' mesh, counterpart of `rga3_tpu/parallel/mesh.py` over
`torch.distributed` ranks instead of jax devices.

Axes, as in the JAX package: `data` splits the batch and is the only axis
that may cross nodes (one gradient all-reduce a step); `fsdp` shards the
trainable state, the gradients and the frozen weights (reduce-scatter and
all-gather every step and every layer, so it stays inside a node's NVLink);
`tensor` splits the LM's heads, MLP columns and vocabulary (Megatron-style
layers, `parallel.tensor`: an all-reduce after every row-parallel product,
so it stays inside a node as well). A node plays the part of a TPU slice:
`mesh_rank_array` orders the ranks as the JAX package's `mesh_device_array`
orders the devices of a multi-slice pod.

`make_mesh(cfg)` gives a `Mesh`: the rank grid, this rank's coordinates and
one process group for each axis, for the ranks that hold the same rows
("replica": data x fsdp at one tensor index) and for the world. Without an
initialised process group the mesh is one rank, and its collectives do
nothing.
"""
from __future__ import annotations

import socket
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ..config import MeshConfig

def mesh_rank_array(cfg: MeshConfig, nodes: Sequence) -> np.ndarray:
    """(data, fsdp, tensor) array of ranks; `nodes[r]` names the node of
    rank r. Ranks on several nodes: each node's ranks in their order, in
    blocks along `data` (nodes sorted by name), so that fsdp and tensor
    groups never cross a node; this needs `data` to be a multiple of the
    node count. On one node: the ranks in order."""
    n = len(nodes)
    if cfg.data * cfg.fsdp * cfg.tensor != n:
        raise ValueError(f"mesh {cfg.data}x{cfg.fsdp}x{cfg.tensor} != {n} ranks")
    names = sorted(set(nodes))
    if len(names) == 1:
        return np.arange(n).reshape(cfg.data, cfg.fsdp, cfg.tensor)
    if cfg.data % len(names) != 0:
        raise ValueError(f"data axis ({cfg.data}) must be a multiple of the node count "
                         f"({len(names)}): fsdp/tensor collectives cannot cross nodes")
    blocks = []
    for name in names:
        ranks = np.asarray([r for r in range(n) if nodes[r] == name])
        if ranks.size * len(names) != n:
            raise ValueError(f"node {name!r} holds {ranks.size} of {n} ranks: the nodes "
                             "must hold as many ranks each")
        blocks.append(ranks.reshape(cfg.data // len(names), cfg.fsdp, cfg.tensor))
    return np.concatenate(blocks, axis=0)


def default_config(nodes: Sequence) -> MeshConfig:
    """The JAX package's default mesh: `data` = the node count, `fsdp` = the
    rest."""
    n_nodes = len(set(nodes))
    return MeshConfig(data=n_nodes, fsdp=len(nodes) // n_nodes, tensor=1)


def batch_axes(shape: Dict[str, int], size: int):
    """The axes that split `size` rows (the JAX script's `batch_axis_spec`):
    ("data", "fsdp") when data x fsdp divides them, else "data", else
    "fsdp", else None (every rank takes every row)."""
    d, fs = shape.get("data", 1), shape.get("fsdp", 1)
    if d * fs > 1 and size % (d * fs) == 0:
        return ("data", "fsdp")
    if d > 1 and size % d == 0:
        return "data"
    if fs > 1 and size % fs == 0:
        return "fsdp"
    return None


@dataclass
class Mesh:
    """The rank grid of `cfg` (`ranks[d, f, t]`), this process's `rank`,
    and the process groups this rank belongs to along "data", "fsdp",
    "tensor", "replica" (data x fsdp: the ranks of its tensor index) and
    "world" (none without an initialised process group)."""

    cfg: MeshConfig
    ranks: np.ndarray
    rank: int = 0
    groups: Dict[str, Optional[object]] = field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.cfg.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def coords(self) -> Tuple[int, int, int]:
        d, f, t = np.argwhere(self.ranks == self.rank)[0]
        return int(d), int(f), int(t)

    def group(self, axes) -> Optional[object]:
        """The process group of `axes` ("data", "fsdp", "tensor", ("data",
        "fsdp") or None) that holds this rank; None for no axes or one
        process. ("data", "fsdp") is the ranks of this rank's tensor index
        (the world when tensor is 1)."""
        if axes is None:
            return None
        if isinstance(axes, tuple):
            axes = "replica" if len(axes) > 1 else axes[0]
        return self.groups.get(axes)

    def rows(self, size: int) -> Tuple[slice, Optional[str]]:
        """(this rank's rows of `size`, the axes that split them): the
        contiguous block of `batch_axes`' split, in the order the JAX
        package's sharding lays rows over (data, fsdp)."""
        axes = batch_axes(self.shape, size)
        d, f, _ = self.coords
        if axes is None:
            return slice(0, size), None
        if axes == ("data", "fsdp"):
            parts, index = self.shape["data"] * self.shape["fsdp"], d * self.shape["fsdp"] + f
        elif axes == "data":
            parts, index = self.shape["data"], d
        else:
            parts, index = self.shape["fsdp"], f
        per = size // parts
        return slice(index * per, (index + 1) * per), axes

    def row_group(self, axes) -> Optional[object]:
        """The process group over which the normalisers and losses of rows
        split by `axes` are summed: the ranks that hold the other rows. Rows
        every rank holds (`axes` None) need no sum; a one-rank run under a
        process group still sums over its one-rank world, so that it makes
        the collectives of a larger run."""
        if axes is None:
            return self.groups.get("world") if self.size == 1 else None
        return self.group(axes)

    def replicas(self, axes) -> int:
        """How many ranks hold each row when `axes` split the rows."""
        split = {None: 1, "data": self.shape["data"], "fsdp": self.shape["fsdp"],
                 ("data", "fsdp"): self.shape["data"] * self.shape["fsdp"]}[axes]
        return self.size // split


def node_names() -> list:
    """Every rank's host name, by rank (one all-gather); one process: its
    own."""
    if not dist.is_initialized():
        return [socket.gethostname()]
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return names


def make_mesh(cfg: Optional[MeshConfig] = None, nodes: Optional[Sequence] = None) -> Mesh:
    """The mesh of `cfg` over the initialised process group (the JAX
    package's default config when None), with a process group for each axis
    this rank is on. Every rank calls it, with the same `cfg`. `nodes`
    (each rank's node) defaults to the ranks' host names."""
    if nodes is None:
        nodes = node_names()
    cfg = cfg or default_config(nodes)
    ranks = mesh_rank_array(cfg, nodes)
    if not dist.is_initialized():
        return Mesh(cfg, ranks)
    rank = dist.get_rank()
    groups = {"world": dist.group.WORLD}
    # every rank creates every group, in one order
    for t in range(cfg.tensor):
        for f in range(cfg.fsdp):
            g = dist.new_group([int(r) for r in ranks[:, f, t]])
            if rank in ranks[:, f, t]:
                groups["data"] = g
    for t in range(cfg.tensor):
        for d in range(cfg.data):
            g = dist.new_group([int(r) for r in ranks[d, :, t]])
            if rank in ranks[d, :, t]:
                groups["fsdp"] = g
    for d in range(cfg.data):
        for f in range(cfg.fsdp):
            g = dist.new_group([int(r) for r in ranks[d, f, :]])
            if rank in ranks[d, f, :]:
                groups["tensor"] = g
    if cfg.tensor == 1:
        groups["replica"] = groups["world"]
    else:
        for t in range(cfg.tensor):
            g = dist.new_group([int(r) for r in ranks[:, :, t].reshape(-1)])
            if rank in ranks[:, :, t]:
                groups["replica"] = g
    return Mesh(cfg, ranks, rank, groups)
