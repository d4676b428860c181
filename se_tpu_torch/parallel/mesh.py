"""Meshes and sharding for data parallelism over torch.distributed ranks:
the port of se_tpu/parallel/mesh.py, with its names.

se_tpu is single-controller (one process drives every device, GSPMD
splits the arrays). The port runs one process a rank: every rank calls
the same function on the same global batch, computes its own rows, and
returns the whole result, as se_tpu returns a global array. A step or a
decode over a mesh computes what one device computes on the global batch.

    initialize_multihost("tcp://localhost:29500", 2, rank)  # or a launcher
    mesh = make_mesh()                     # every rank on "data"
    replicate(model, mesh)                 # rank 0's weights, checked
    rows = shard_batch(batch, mesh)        # this rank's rows
    with activation_mesh(mesh):
        ...                                # BN, dropout, losses go global

The mesh has one axis, "data". A "model" axis above 1 (se_tpu shards
Uformer's attention folds over it) raises: ROADMAP item 13b.
`shard_activation` and `shard_map_leading` have no counterpart: on a
data-only mesh the first is the identity, and each kernel runs on its
rank's own tensors, which is what the second does for se_tpu's Pallas
calls.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

from se_tpu_torch.parallel import collectives as C

MODEL_AXIS_TODO = ("a 'model' mesh axis above 1 (sequence-parallel "
                   "attention folds over a model group) is not ported: "
                   "ROADMAP Queue 1 item 13b")


class Mesh:
    """The ranks of the default process group on the axes `shape`
    ({"data": n}, "model" 1 if given); `rank` this process's, `backend`
    the group's (None: a world of one without a group)."""

    def __init__(self, shape: dict, rank: int, backend: str | None):
        self.shape, self.rank, self.backend = shape, rank, backend

    @property
    def data(self) -> int:
        return self.shape["data"]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend})")


def make_mesh(axes: Mapping[str, int] | None = None) -> Mesh:
    """A mesh over every rank. Default: all ranks on one "data" axis.
    Raises where the axes' product is not the world size (se_tpu's
    device count), on an axis other than "data" and "model", and on a
    "model" axis above 1 (ROADMAP item 13b)."""
    ready = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if ready else 1
    axes = dict({"data": world} if axes is None else axes)
    unknown = set(axes) - {"data", "model"}
    if unknown:
        raise ValueError(f"mesh axes are 'data' and 'model', got {unknown}")
    if axes.get("model", 1) > 1:
        raise NotImplementedError(MODEL_AXIS_TODO)
    if math.prod(axes.values()) != world:
        raise ValueError(f"mesh {axes} != {world} ranks")
    axes.setdefault("data", 1)
    return Mesh(axes, dist.get_rank() if ready else 0,
                dist.get_backend() if ready else None)


def _tensors(module: torch.nn.Module) -> list:
    return [*module.parameters(), *module.buffers()]


def check_replicated(module: torch.nn.Module, mesh: Mesh) -> None:
    """Raise unless every rank holds rank 0's weights: the parameters and
    buffers, flattened in order to fp64, give three numbers (their sum,
    their sum of squares and their sum weighted by position), gathered
    from every rank and held to rank 0's exactly. A handful of launches
    and one small collective, whatever the module's size."""
    if mesh.data == 1:
        return
    ts = _tensors(module)
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in ts]).double() if ts else \
            torch.zeros(1, dtype=torch.float64)
        where = torch.arange(flat.numel(), dtype=torch.float64,
                             device=flat.device) / flat.numel()
        mark = torch.stack([flat.sum(), flat.square().sum(),
                            (flat * where).sum()])
        every = C.all_gather_rows(mark[None], mesh)
    differ = [r for r in range(mesh.data) if not torch.equal(every[r],
                                                             every[0])]
    if differ:
        raise RuntimeError(f"ranks {differ} hold other weights than rank 0")


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place,
    then `check_replicated`; returns `module`."""
    for t in _tensors(module):
        C.broadcast_(t.data, mesh)
    check_replicated(module, mesh)
    return module


def _rows(x, mesh: Mesh):
    n = x.shape[0]
    if n % mesh.data:
        raise ValueError(f"a batch of {n} rows does not divide over the "
                         f"'data' axis of {mesh.data}")
    k = n // mesh.data
    return x[mesh.rank * k:(mesh.rank + 1) * k]


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree, mesh: Mesh):
    """This rank's contiguous rows of every leaf's leading axis (se_tpu's
    P("data") layout); raises where a leading axis does not divide over
    the "data" axis, as a NamedSharding does."""
    return _map(lambda x: _rows(x, mesh), tree)


def host_local_batch_to_global(tree, mesh: Mesh):
    """The global batch from each rank's local rows: every leaf (tensor
    or numpy array) gathered in rank order, on every rank (se_tpu's
    make_array_from_process_local_data); `shard_batch` of it gives each
    rank its local rows back."""

    def gather(x):
        t = torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x
        out = C.all_gather_rows(t, mesh)
        return out if isinstance(x, torch.Tensor) else out.numpy()

    return _map(gather, tree)


# The active mesh is a module global, not a context variable as se_tpu's:
# autograd runs a CUDA backward (and a checkpoint's recompute) on a thread
# of its own, which must see it too.
_ACTIVE: list = [None]


@contextlib.contextmanager
def activation_mesh(mesh: Mesh | None):
    """Make `mesh` what BN, dropout, drop_band and the losses see: their
    statistics, masks, groups and denominators become the global batch's."""
    before = _ACTIVE[0]
    _ACTIVE[0] = mesh
    try:
        yield
    finally:
        _ACTIVE[0] = before


def active_mesh() -> Mesh | None:
    return _ACTIVE[0]


def data_size() -> int:
    """The active mesh's "data" size; 1 without one."""
    mesh = _ACTIVE[0]
    return 1 if mesh is None else mesh.data


def row_offset(rows: int) -> int:
    """The global index of this rank's first row, its shard `rows` long;
    0 without an active mesh."""
    mesh = _ACTIVE[0]
    return 0 if mesh is None else mesh.rank * rows


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the active mesh's ranks, outside autograd (a
    count); `t` itself without a mesh."""
    mesh = _ACTIVE[0]
    return t if mesh is None or mesh.data == 1 else \
        C.all_reduce_sum(t, mesh)


def rank_device(device_type: str, local_rank: int | None = None
                ) -> torch.device:
    """This rank's device: the CPU, or the card of its local rank
    (`local_rank`, else LOCAL_RANK, else its rank in the group) modulo the
    host's card count: ranks that outnumber the cards share them."""
    if device_type == "cpu":
        return torch.device("cpu")
    if local_rank is None:
        local_rank = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda",
                        local_rank % max(torch.cuda.device_count(), 1))


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device_type: str = "cuda") -> str | None:
    """Join the ranks' process group: torch.distributed's
    `init_process_group` with the backend `collectives.choose_backend`
    picks for `device_type` (ranks a host: LOCAL_WORLD_SIZE, else the
    world). The address is "tcp://host:port", "file:///path" or
    "host:port"; None reads a launcher's environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE). A no-op, returning the group's
    backend, when a group exists, and returning None when nothing is
    configured (single process). Returns the backend."""
    if dist.is_initialized():
        return dist.get_backend()
    if coordinator_address is None and num_processes is None \
            and "WORLD_SIZE" not in os.environ:
        return None
    world = num_processes if num_processes is not None else \
        int(os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else \
        int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = C.choose_backend(device_type, per_host, cards)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(
            "cuda", int(os.environ.get("LOCAL_RANK", rank))))
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return backend
