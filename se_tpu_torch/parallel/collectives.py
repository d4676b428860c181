"""The collectives of the port's data parallelism, in one place.

One process a rank (torch.distributed's default group); every collective
here runs over all of it. The backend is chosen from the topology before
the run (`choose_backend`): NCCL where each rank has a card of its own,
gloo where ranks share a card (NCCL refuses two ranks on one device:
"Duplicate GPU detected") or run on the CPU. gloo takes CUDA tensors in
all_reduce, broadcast and all_gather itself, through host memory
(`chip_smoke.py` phase 10 checks each on the card), so nothing here
stages them.

A mesh whose "data" size is 1 (a world of one) runs no collective: each
function returns its input's value.
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


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of `t` over the ranks, on every rank (a new tensor, outside
    autograd)."""
    out = t.detach().clone()
    if mesh.data > 1:
        dist.all_reduce(out)
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x on every rank; the backward is the same all-reduce of
    the gradient: each rank's x reaches every rank's loss through y, and
    the step's objective is the sum of the ranks' losses."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_sum(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous(), ctx.mesh), None


def all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """`all_reduce_sum` inside autograd (its backward all-reduces the
    gradient)."""
    if mesh.data == 1:
        return x
    return _AllReduceSum.apply(x, mesh)


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' `t` (equal shapes) concatenated along the leading axis
    in rank order, on every rank (outside autograd)."""
    src = t.detach().contiguous()
    if mesh.data == 1:
        return src.clone()
    parts = [torch.empty_like(src) for _ in range(mesh.data)]
    dist.all_gather(parts, src)
    return torch.cat(parts)


def broadcast_(t: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `t` written into every rank's `t`, in place."""
    if mesh.data > 1:
        with torch.no_grad():
            dist.broadcast(t, src)
    return t


def barrier(mesh) -> None:
    """Every rank waits for every other."""
    if mesh.data > 1:
        dist.barrier()
