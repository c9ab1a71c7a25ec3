"""Process groups and cross-rank helpers, counterpart of
`rga3_tpu/parallel/distributed.py` over `torch.distributed`.

`init_distributed` joins the ranks of a run, launched either as the JAX
script is (`--coordinator_address host:port --num_processes N --process_id
i`, or `COORDINATOR_ADDRESS` / `NUM_PROCESSES` / `PROCESS_ID`) or by
torchrun (`MASTER_ADDR` / `MASTER_PORT` / `RANK` / `WORLD_SIZE` /
`LOCAL_RANK`). On the card it takes NCCL and makes `cuda:<local rank>` the
rank's device; gloo and the CPU only when the caller asks for the CPU. One
process with none of these set is a no-op, as in the JAX package.

Every collective of the port goes through the helpers here, which refuse a
CPU tensor while NCCL is the backend: no collective quietly runs on the
host. `init_distributed(..., backend="gloo")` takes gloo for CUDA tensors
(two ranks that share one card, which NCCL refuses); gloo carries
all-reduce and broadcast of a CUDA tensor, so there the helpers express an
all-gather or a reduce-scatter of one through an all-reduce (a rank's block
added to zeros is exact) and count it in `GLOO_CUDA_VIA_ALL_REDUCE`. The
tensor axis's collectives that autograd differentiates (`copy_to_tensor`,
`reduce_from_tensor`, `gather_from_tensor`) are here too.

Each rank builds the same host batch (`sample_global` is a pure function
of the index) and `put_global` gives it its rows; `host_local_slice`
names them. `replicate_to_host` gathers a sharded state whole.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: DeviceLike = None, backend: Optional[str] = None) -> int:
    """Join the run's process group and return this process's rank (0 when
    there is nothing to join). `device="cpu"` (or a CPU device) takes gloo
    on the CPU; otherwise NCCL on `cuda:<local rank>`, which raises without
    CUDA, or gloo with CUDA tensors under `backend="gloo"` (ranks that share
    a card). An initialised group is left as it is."""
    if dist.is_initialized():
        return dist.get_rank()
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if address:
        world = num_processes if num_processes is not None else _env_int("NUM_PROCESSES")
        rank = process_id if process_id is not None else _env_int("PROCESS_ID")
        if world is None or rank is None:
            raise ValueError("a coordinator address needs the number of processes and this "
                             "process's id (--num_processes / --process_id, or NUM_PROCESSES "
                             "/ PROCESS_ID)")
        init_method = address if "://" in address else f"tcp://{address}"
    elif os.environ.get("MASTER_ADDR") and _env_int("WORLD_SIZE") is not None:
        world, rank = _env_int("WORLD_SIZE"), _env_int("RANK") or 0
        init_method = "env://"
    else:
        return 0
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        if local is None:
            local = rank % torch.cuda.device_count()
        torch.cuda.set_device(local)
        if backend == "gloo":
            dist.init_process_group("gloo", init_method=init_method, world_size=world,
                                    rank=rank)
        else:
            dist.init_process_group("nccl", init_method=init_method, world_size=world,
                                    rank=rank, device_id=torch.device("cuda", local))
    elif dev.type == "cpu":
        dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)
    else:
        raise RuntimeError(f"no process group backend for {dev}")
    return rank


def is_main() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device() -> torch.device:
    """The device of this rank's tensors: the current CUDA device under
    NCCL, the CPU under gloo (and without a process group)."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def rank0_print(*args, **kwargs) -> None:
    if is_main():
        print(*args, **kwargs, flush=True)


def barrier() -> None:
    """Every rank waits here for the others (around checkpoint writes)."""
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def _on_backend(t: torch.Tensor, name: str) -> None:
    """A collective's tensor: on the card under NCCL, and contiguous (NCCL
    refuses a strided tensor, gloo would take it: the check makes the CPU
    tests see what the card would)."""
    if dist.get_backend() == "nccl" and not t.is_cuda:
        raise RuntimeError(f"{name}: a {t.device} tensor under NCCL; the port's collectives "
                           "run on the card")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the tensor must be contiguous")


def all_reduce(t: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """Sum (or with `op="max"` take the largest of) `t` in place over
    `group` (the world when None); nothing without a process group."""
    if dist.is_initialized():
        _on_backend(t, "all_reduce")
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=group)
    return t


# collectives of CUDA tensors under gloo that went through an all-reduce, by
# name (gloo has no CUDA all-gather / reduce-scatter)
GLOO_CUDA_VIA_ALL_REDUCE: Dict[str, int] = {}


def _gloo_cuda(t: torch.Tensor, name: str) -> bool:
    if t.is_cuda and dist.get_backend() == "gloo":
        GLOO_CUDA_VIA_ALL_REDUCE[name] = GLOO_CUDA_VIA_ALL_REDUCE.get(name, 0) + 1
        return True
    return False


def _group_index(group) -> int:
    return dist.get_rank(group) if group is not None else dist.get_rank()


def reduce_scatter_along(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of the sum of `t` over `group`, split along `dim`
    into as many blocks as the group has ranks (contiguous)."""
    n = dist.get_world_size(group)
    src = t.detach().movedim(dim, 0).contiguous()
    _on_backend(src, "reduce_scatter")
    per = src.shape[0] // n
    if _gloo_cuda(src, "reduce_scatter"):
        i = _group_index(group)
        dist.all_reduce(src, group=group)
        return src[i * per:(i + 1) * per].movedim(0, dim).contiguous()
    out = torch.empty((per,) + src.shape[1:], dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def all_gather_along(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of `t` of every rank of `group`, joined along `dim` in rank
    order of the group (contiguous)."""
    n = dist.get_world_size(group)
    src = t.detach().movedim(dim, 0).contiguous()
    _on_backend(src, "all_gather")
    if _gloo_cuda(src, "all_gather"):
        i, per = _group_index(group), src.shape[0]
        out = torch.zeros((per * n,) + src.shape[1:], dtype=t.dtype, device=t.device)
        out[i * per:(i + 1) * per] = src
        dist.all_reduce(out, group=group)
        return out.movedim(0, dim).contiguous()
    out = torch.empty((src.shape[0] * n,) + src.shape[1:], dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


# ---------------------------------------------------------------------------
# the tensor axis's collectives under autograd (Megatron's f / g operators)
# ---------------------------------------------------------------------------

class _CopyToTensor(torch.autograd.Function):
    """Identity forward; the gradient summed over the tensor group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _ReduceFromTensor(torch.autograd.Function):
    """Sum over the tensor group forward; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTensor(torch.autograd.Function):
    """The blocks of the tensor group joined along the last dim forward;
    this rank's block of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return all_gather_along(x, x.dim() - 1, group)

    @staticmethod
    def backward(ctx, g):
        i = _group_index(ctx.group)
        return g[..., i * ctx.width:(i + 1) * ctx.width].contiguous(), None


def copy_to_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """x as it is, entering a column-parallel product (its gradient, partial
    on each rank of `group`, is summed); x itself without a group."""
    return x if group is None else _CopyToTensor.apply(x, group)


def reduce_from_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of a row-parallel product's partial outputs."""
    return x if group is None else _ReduceFromTensor.apply(x, group)


def gather_from_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' blocks of `group` joined along the last dimension."""
    return x if group is None else _GatherFromTensor.apply(x, group)


def broadcast_scalar(value: Optional[float]) -> Optional[float]:
    """Rank 0's `value` on every rank (None travels as NaN): the val metric
    that only rank 0 computes, so that every rank agrees on "best"."""
    if not dist.is_initialized():
        return value
    t = torch.tensor([np.nan if value is None else float(value)], dtype=torch.float64,
                     device=rank_device())
    dist.broadcast(t, src=0)
    out = float(t.item())
    return None if np.isnan(out) else out


def replicate_to_host(tensors: Dict[str, torch.Tensor], dims: Dict[str, Optional[int]],
                      group) -> Dict[str, torch.Tensor]:
    """Every tensor whole on the host, on every rank: those with a dim in
    `dims` are this rank's shard along it, gathered over `group` (one
    all-gather each; every rank of the group calls it together); the rest
    are whole already."""
    out = {}
    for name, t in tensors.items():
        d = dims.get(name)
        if d is not None and group is not None:
            t = all_gather_along(t, d, group)
        out[name] = t.detach().cpu()
    return out


def host_local_slice(mesh, size: int) -> slice:
    """This rank's rows of a host batch of `size` rows (see `Mesh.rows`)."""
    return mesh.rows(size)[0]


def put_global(mesh, full_host_array: np.ndarray) -> np.ndarray:
    """This rank's rows (axis 0) of a host array every rank built alike."""
    return np.ascontiguousarray(np.asarray(full_host_array)[host_local_slice(
        mesh, len(full_host_array))])
