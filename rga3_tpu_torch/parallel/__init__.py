"""Training across ranks: the (data, fsdp) mesh over `torch.distributed`,
which dimension the fsdp axis shards, and the cross-rank helpers
(counterpart of `rga3_tpu/parallel/`)."""
from .distributed import (  # noqa: F401
    barrier, broadcast_scalar, host_local_slice, init_distributed, put_global, rank0_print,
    replicate_to_host,
)
from .mesh import Mesh, batch_axes, make_mesh, mesh_rank_array  # noqa: F401
from .sharding import infer_param_sharding, shard_batch_spec  # noqa: F401
