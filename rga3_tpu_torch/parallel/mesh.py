"""The ranks' mesh, counterpart of `rga3_tpu/parallel/mesh.py` over
`torch.distributed` ranks instead of jax devices.

Axes, as in the JAX package: `data` splits the batch and is the only axis
that may cross nodes (one gradient all-reduce a step); `fsdp` shards the
trainable state and the gradients (ZeRO-2: reduce-scatter and all-gather
every step, so it stays inside a node's NVLink); `tensor` is the LM's tensor
axis, which is not ported (`make_mesh` raises for tensor > 1). A node plays
the part of a TPU slice: `mesh_rank_array` orders the ranks as the JAX
package's `mesh_device_array` orders the devices of a multi-slice pod.

`make_mesh(cfg)` gives a `Mesh`: the rank grid, this rank's coordinates and
one process group for each axis (and the world). Without an initialised
process group the mesh is one rank, and its collectives do nothing.
"""
from __future__ import annotations

import socket
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ..config import MeshConfig

TENSOR_AXIS_TODO = ("the mesh's tensor axis is not ported (ROADMAP Queue 1 item 1: the "
                    "tensor axis); use --mesh_tensor 1")


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
    and the process groups this rank belongs to along "data", "fsdp" and
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
        """The process group of `axes` ("data", "fsdp", ("data", "fsdp") or
        None) that holds this rank; None for no axes or one process."""
        if axes is None:
            return None
        if isinstance(axes, tuple):
            axes = "world" if len(axes) > 1 else axes[0]
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
    if cfg.tensor > 1:
        raise NotImplementedError(TENSOR_AXIS_TODO)
    ranks = mesh_rank_array(cfg, nodes)
    if not dist.is_initialized():
        return Mesh(cfg, ranks)
    rank = dist.get_rank()
    groups = {"world": dist.group.WORLD}
    # every rank creates every group, in one order
    for f in range(cfg.fsdp):
        g = dist.new_group([int(r) for r in ranks[:, f, 0]])
        if rank in ranks[:, f, 0]:
            groups["data"] = g
    for d in range(cfg.data):
        g = dist.new_group([int(r) for r in ranks[d, :, 0]])
        if rank in ranks[d, :, 0]:
            groups["fsdp"] = g
    return Mesh(cfg, ranks, rank, groups)
