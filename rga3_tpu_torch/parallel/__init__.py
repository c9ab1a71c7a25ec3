"""Training and generation across ranks: the (data, fsdp, tensor) mesh over
`torch.distributed`, which dimensions the tensor and fsdp axes shard, each
rank's blocks of a model (`fsdp.shard_model`), the tensor-parallel layers
and the cross-rank helpers (counterpart of `rga3_tpu/parallel/`)."""
from .distributed import (  # noqa: F401
    barrier, broadcast_scalar, host_local_slice, init_distributed, put_global, rank0_print,
    replicate_to_host,
)
from .mesh import Mesh, batch_axes, make_mesh, mesh_rank_array  # noqa: F401
from .sharding import infer_param_sharding, shard_batch_spec  # noqa: F401
from .fsdp import ShardPlan, shard_model  # noqa: F401
