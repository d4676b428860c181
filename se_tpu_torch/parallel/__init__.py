"""Parallelism over torch.distributed ranks: the port of se_tpu/parallel
(a "data" mesh axis over the batch, a "model" axis over the kernels'
leading axis)."""

from se_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    activation_mesh,
    active_mesh,
    check_replicated,
    host_local_batch_to_global,
    initialize_multihost,
    make_mesh,
    map_leading,
    rank_device,
    replicate,
    shard_batch,
    shard_map_leading,
)
