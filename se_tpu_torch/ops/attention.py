"""Scaled-dot-product attention for the Uformer axial attentions: the port
of se_tpu/ops/pallas_attention.py (`sdp_attention`, kernel `_att_kernel`).

On a CUDA tensor `sdp_attention` launches csrc/attention.cu for every L
(the JAX package sends L < 64 to einsum; the port does not); on a CPU
tensor it runs `_reference`, the plain twin.
"""

from __future__ import annotations

import torch

from se_tpu_torch.ops import _build

HEAD_DIM = 16  # the kernel's compile-time head width (Uformer's hidden 16)


def _reference(q, k, v, scale: float):
    e = torch.einsum("nhld,nhmd->nhlm", q, k) * scale
    p = torch.softmax(e, dim=-1)
    return torch.einsum("nhlm,nhmd->nhld", p, v)


def sdp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (N, H, L, D) for each (n, h)."""
    if q.device.type == "cpu":
        return _reference(q, k, v, scale)
    n, h, l, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"attention kernel takes D = {HEAD_DIM}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check(t, (n, h, l, d), name)
    out = torch.empty_like(q)
    _build.launch("se_attention_fwd", q, k, v, out, n * h, l, float(scale))
    _build.LAUNCHES["attention"] += 1
    return out
