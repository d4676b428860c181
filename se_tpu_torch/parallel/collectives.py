"""The collectives of the port's parallelism, in one place.

One process a rank. Each collective runs over one axis of the mesh: the
"data" group (the ranks that hold other rows of the batch and the same
model coordinate: what a loss, a BN statistic or a gradient sums over),
the "model" group (the ranks that hold the same rows and split a
kernel's leading axis among them: `mesh.shard_map_leading`), or the
"world" (every rank: the replica check, the broadcast of rank 0's
weights, the barrier). A mesh with one axis above 1 has that axis span
the world, in torch.distributed's default group. The backend is chosen
from the topology before the run (`choose_backend`): NCCL where each rank
has a card of its own, gloo where ranks share a card (NCCL refuses two
ranks on one device: "Duplicate GPU detected") or run on the CPU; the
subgroups take the default group's. gloo takes CUDA tensors in
all_reduce, broadcast and all_gather itself, through host memory
(`chip_smoke.py` phase 10 checks each on the card), so nothing here
stages them.

An axis of size 1 runs no collective: each function returns its input's
value.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def choose_backend(device_type: str, ranks_per_host: int,
                   cards: int) -> str:
    """"nccl" when the ranks run on CUDA and each rank of a host has a
    card of its own (ranks_per_host <= cards); "gloo" on the CPU and where
    ranks share a card."""
    if device_type == "cuda" and ranks_per_host <= cards:
        return "nccl"
    return "gloo"


def all_reduce_sum(t: torch.Tensor, mesh, axis: str = "data"
                   ) -> torch.Tensor:
    """The sum of `t` over the ranks of `axis` ("data", "model" or
    "world"), on each of them (a new tensor, outside autograd)."""
    out = t.detach().clone()
    n, group = mesh.axis(axis)
    if n > 1:
        dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = Σ x over the data group on each of its ranks; the backward is
    the same all-reduce of the gradient: each rank's x reaches every
    rank's loss through y, and the step's objective is the sum of the
    ranks' losses."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_sum(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous(), ctx.mesh), None


def all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """`all_reduce_sum` over the data group inside autograd (its backward
    all-reduces the gradient)."""
    if mesh.data == 1:
        return x
    return _AllReduceSum.apply(x, mesh)


def all_gather_rows(t: torch.Tensor, mesh, axis: str = "data"
                    ) -> torch.Tensor:
    """The `t` of the ranks of `axis` (equal shapes) concatenated along
    the leading axis in their order on that axis, on each of them
    (outside autograd)."""
    src = t.detach().contiguous()
    n, group = mesh.axis(axis)
    if n == 1:
        return src.clone()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts)


def broadcast_(t: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `t` written into every rank's `t`, in place."""
    if mesh.size > 1:
        with torch.no_grad():
            dist.broadcast(t, src)
    return t


def barrier(mesh) -> None:
    """Every rank waits for every other."""
    if mesh.size > 1:
        dist.barrier()
