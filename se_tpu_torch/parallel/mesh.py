"""Meshes and sharding over torch.distributed ranks: the port of
se_tpu/parallel/mesh.py, with its names.

se_tpu is single-controller (one process drives every device, GSPMD
splits the arrays). The port runs one process a rank: every rank calls
the same function on the same global batch, computes its own rows, and
returns the whole result, as se_tpu returns a global array. A step or a
decode over a mesh computes what one device computes on the global batch.

    initialize_multihost("tcp://localhost:29500", 4, rank)  # or a launcher
    mesh = make_mesh({"data": 2, "model": 2})
    replicate(model, mesh)                 # rank 0's weights, checked
    rows = shard_batch(batch, mesh)        # this rank's rows
    with activation_mesh(mesh):
        ...                                # BN, dropout, losses go global;
                                           # the kernels split over "model"

The axes are se_tpu's, laid out as its row-major device array: rank r =
i * model + j has data coordinate i and model coordinate j. The ranks of
one data coordinate (a model group) hold the same rows; the ranks of one
model coordinate (a data group) hold the batch between them. Whatever is
global over the batch (BN's statistics, dropout's mask, drop_band's
groups, the losses' denominators, the gradients) reduces over the data
group (`collectives`).

The model group splits the kernels. se_tpu runs each Pallas kernel under
`shard_map_leading`, its leading axis split over the whole mesh, and
Uformer's axial attentions ask GSPMD to lay each fold's B·F or B·T rows
over "model" (`shard_activation(fold, "model", ...)`). Here a rank holds
its data rows already, and each kernel wrapper maps its leading axis over
the model group (`map_leading`, through `shard_map_leading`): a rank runs
the kernel on its 1/model of the rows and the group gathers the outputs.
That is the fold's sequence-parallel split inside `sdp_attention`, so the
port has no `shard_activation`: the folds themselves need no layout.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

from se_tpu_torch.ops._autograd import _fill, _flatten, _skeleton
from se_tpu_torch.parallel import collectives as C


class Mesh:
    """The ranks of the default process group on the axes `shape`
    ({"data": d, "model": m}, "model" 1 where not given); `rank` this
    process's, `backend` the group's (None: a world of one without a
    group), `groups` the subgroups of this rank's data and model
    coordinates (an axis absent: the default group, or no collective)."""

    def __init__(self, shape: dict, rank: int, backend: str | None,
                 groups: dict | None = None):
        self.shape = {"data": 1, **shape}
        self.rank, self.backend = rank, backend
        self.groups = groups or {}

    @property
    def data(self) -> int:
        return self.shape["data"]

    @property
    def model(self) -> int:
        return self.shape.get("model", 1)

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        """This rank's data coordinate i (r = i * model + j)."""
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        """This rank's model coordinate j."""
        return self.rank % self.model

    def axis(self, name: str) -> tuple:
        """(size, process group) of axis `name`, "data", "model" or
        "world"; the group None is the default group."""
        if name == "world":
            return self.size, None
        size = self.data if name == "data" else self.model
        return size, self.groups.get(name)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend})")


def _subgroups(d: int, m: int, rank: int, backend) -> dict:
    """This rank's data and model groups where both axes exceed 1 (else
    the one axis above 1 is the world). Every rank creates every group,
    in one order: the data groups (same j), then the model groups (same
    i)."""
    if d == 1 or m == 1:
        return {}
    groups = {}
    for j in range(m):
        g = dist.new_group([i * m + j for i in range(d)], backend=backend)
        if j == rank % m:
            groups["data"] = g
    for i in range(d):
        g = dist.new_group([i * m + j for j in range(m)], backend=backend)
        if i == rank // m:
            groups["model"] = g
    return groups


def make_mesh(axes: Mapping[str, int] | None = None) -> Mesh:
    """A mesh over every rank. Default: all ranks on one "data" axis.
    Raises where the axes' product is not the world size (se_tpu's
    device count) and on an axis other than "data" and "model". Every
    rank calls it alike: a mesh with both axes above 1 creates its
    subgroups."""
    ready = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if ready else 1
    axes = dict({"data": world} if axes is None else axes)
    unknown = set(axes) - {"data", "model"}
    if unknown:
        raise ValueError(f"mesh axes are 'data' and 'model', got {unknown}")
    if math.prod(axes.values()) != world:
        raise ValueError(f"mesh {axes} != {world} ranks")
    rank = dist.get_rank() if ready else 0
    backend = dist.get_backend() if ready else None
    d, m = axes.get("data", 1), axes.get("model", 1)
    return Mesh(axes, rank, backend, _subgroups(d, m, rank, backend))


def _tensors(module: torch.nn.Module) -> list:
    return [*module.parameters(), *module.buffers()]


def check_replicated(module: torch.nn.Module, mesh: Mesh) -> None:
    """Raise unless every rank holds rank 0's weights: the parameters and
    buffers, flattened in order to fp64, give three numbers (their sum,
    their sum of squares and their sum weighted by position), gathered
    from every rank and held to rank 0's exactly. A handful of launches
    and one small collective, whatever the module's size."""
    if mesh.size == 1:
        return
    ts = _tensors(module)
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in ts]).double() if ts else \
            torch.zeros(1, dtype=torch.float64)
        where = torch.arange(flat.numel(), dtype=torch.float64,
                             device=flat.device) / flat.numel()
        mark = torch.stack([flat.sum(), flat.square().sum(),
                            (flat * where).sum()])
        every = C.all_gather_rows(mark[None], mesh, "world")
    differ = [r for r in range(mesh.size) if not torch.equal(every[r],
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
    return x[mesh.data_index * k:(mesh.data_index + 1) * k]


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree, mesh: Mesh):
    """This rank's contiguous rows of every leaf's leading axis (se_tpu's
    P("data") layout: a model group's ranks hold the same); raises where a leading axis does not divide over
    the "data" axis, as a NamedSharding does."""
    return _map(lambda x: _rows(x, mesh), tree)


def host_local_batch_to_global(tree, mesh: Mesh):
    """The global batch from each rank's local rows: every leaf (tensor
    or numpy array) gathered over the data group in its order, on every
    rank (se_tpu's
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
    return 0 if mesh is None else mesh.data_index * rows


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the active mesh's data group, outside autograd (a
    count); `t` itself without a mesh."""
    mesh = _ACTIVE[0]
    return t if mesh is None or mesh.data == 1 else \
        C.all_reduce_sum(t, mesh)


class _Mapped:
    """What a mapped call closes over: `fn`, the mesh, the rows of a
    rank's slice, how many leading args are mapped, whether the call was
    made under grad mode, and, once the forward ran, its outputs'
    skeleton, its leaves and its local outputs."""

    def __init__(self, fn, mesh: Mesh, rows: int, n_mapped: int):
        self.fn, self.mesh, self.rows = fn, mesh, rows
        self.n_mapped = n_mapped
        self.grad = torch.is_grad_enabled()
        self.outputs = self.leaves = self.local = None

    def slice(self, t: torch.Tensor) -> torch.Tensor:
        j = self.mesh.model_index
        return t[j * self.rows:(j + 1) * self.rows].contiguous()


class _MapLeading(torch.autograd.Function):
    """fn over this rank's slice of the mapped args, the outputs gathered
    over the model group; the conjugate collectives backward: fn's VJP
    on this rank's slice of the output gradient, the mapped args'
    gradients gathered over the model group and the replicated args'
    summed over it (jax.shard_map's transpose of a replicated input)."""

    @staticmethod
    def forward(ctx, spec, *args):
        ctx.set_materialize_grads(False)
        ctx.spec = spec
        local = [spec.slice(a) if i < spec.n_mapped and a is not None
                 else a for i, a in enumerate(args)]
        wants = ctx.needs_input_grad[1:] if spec.grad else ()
        if any(wants):  # fn's graph on the slice, kept for the backward
            local = [a.detach().requires_grad_(w)
                     if isinstance(a, torch.Tensor) else a
                     for a, w in zip(local, wants)]
            with torch.enable_grad():
                out = spec.fn(*local)
            spec.leaves = local
        else:
            out = spec.fn(*local)
        spec.outputs = _skeleton(out)
        spec.local = _flatten(out)
        full = tuple(C.all_gather_rows(o, spec.mesh, "model")
                     for o in spec.local)
        ctx.mark_non_differentiable(*(g for g, o in zip(full, spec.local)
                                      if not o.requires_grad))
        if not any(wants):
            spec.local = None
        return full

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        pairs = [(o, spec.slice(g)) for o, g in zip(spec.local, grads)
                 if g is not None and o.requires_grad]
        wanted = [t for t in spec.leaves
                  if isinstance(t, torch.Tensor) and t.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs else [None] * len(wanted))
        out = []
        for i, leaf in enumerate(spec.leaves):
            if not (isinstance(leaf, torch.Tensor) and leaf.requires_grad):
                out.append(None)
                continue
            g = next(got)
            g = torch.zeros_like(leaf) if g is None else g.contiguous()
            out.append(C.all_gather_rows(g, spec.mesh, "model")
                       if i < spec.n_mapped
                       else C.all_reduce_sum(g, spec.mesh, "model"))
        spec.leaves = spec.local = None
        return (None, *out)


def shard_map_leading(fn, mesh: Mesh, leading: int, n_mapped: int,
                      n_replicated: int = 0):
    """se_tpu's `shard_map_leading` over the model group: a function of
    `n_mapped` args whose leading axis is `leading` long (a tensor, or
    None for an absent one) and `n_replicated` args every rank holds
    whole (the weights), which runs `fn` on this rank's contiguous
    leading / model rows of the mapped args (model coordinate j: rows j k
    .. (j + 1) k) and returns every output gathered over the model group
    (each output's leading axis is the mapped one), in one autograd
    Function with the conjugate collectives backward (`_MapLeading`).
    `fn` itself on a model axis of 1 (each rank runs its own rows); None
    where `leading` does not divide over the model group, as se_tpu's
    returns None where it does not divide over its mesh."""
    m = mesh.model
    if m == 1:
        return fn
    if leading % m:
        return None

    def mapped(*args):
        if len(args) != n_mapped + n_replicated:
            raise TypeError(f"shard_map_leading: {len(args)} args, mapped "
                            f"{n_mapped} + replicated {n_replicated}")
        spec = _Mapped(fn, mesh, leading // m, n_mapped)
        full = _MapLeading.apply(spec, *args)
        return _fill(spec.outputs, iter(full))

    return mapped


def map_leading(fn, mapped: tuple, replicated: tuple = ()):
    """`fn(*mapped, *replicated)`, under an active mesh with a model axis
    above 1 through `shard_map_leading` (the kernel wrappers' call: a
    rank's kernel on its share of the rows). Where the leading axis does
    not divide over the model group every rank runs `fn` on all its rows
    (se_tpu's callers then take their XLA path; here the wrapper's own
    kernel, whole)."""
    mesh = _ACTIVE[0]
    if mesh is not None and mesh.model > 1:
        f = shard_map_leading(fn, mesh, mapped[0].shape[0], len(mapped),
                              len(replicated))
        if f is not None:
            return f(*mapped, *replicated)
    return fn(*mapped, *replicated)


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
