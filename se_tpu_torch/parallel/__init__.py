"""Data parallelism over torch.distributed ranks: the port of
se_tpu/parallel (a "data" mesh axis; the "model" axis is ROADMAP item
13b)."""

from se_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    activation_mesh,
    active_mesh,
    check_replicated,
    host_local_batch_to_global,
    initialize_multihost,
    make_mesh,
    rank_device,
    replicate,
    shard_batch,
)
