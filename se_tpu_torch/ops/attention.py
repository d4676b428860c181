"""Scaled-dot-product attention for the Uformer axial attentions: the port
of se_tpu/ops/pallas_attention.py (`sdp_attention`, kernel `_att_kernel`).

On a CUDA tensor `sdp_attention` launches csrc/attention.cu for every L
(the JAX package sends L < 64 to einsum; the port does not); on a CPU
tensor it runs `_reference`, the plain twin. Under autograd the launch
is a Function (`_autograd.kernel_call`) whose backward is the VJP of
`_reference`, recomputed, for either design (se_tpu's
`pallas_attention.py:77-79`).

csrc/attention.cu has two designs, picked a call by `att_design` from the
shape: a flash-attention forward on the tensor cores (`se_att_flash_tc`:
3xTF32 mma.sync, 16 query rows a warp, K/V tiles of 64 keys through a
cp.async ring; any L, the T-attention's 401) and a packed CUDA-core
kernel for short L (`se_att_small_l`: 128 / L (n, h) pairs a block, one
thread a query row; L <= SMALL_L_MAX, the F-attention's 4). Each launch
counts in `_build.LAUNCHES["attention"]` and in the design's own
`attention_flash_tc` / `attention_small_l`.

bf16 q, k and v keep the TPU kernel's rounding points (fp32 scores and
softmax, P normalised, then rounded to bf16, a bf16 output; `_reference`
mirrors them) and launch a kernel of their own: `se_att_flash_tc_bf16`
(bf16 `mma.m16n8k16` fed by a bf16 cp.async ring, two sweeps over K: the
row's max and sum, then P and P V) or `se_att_small_l_bf16`. Counted as
`attention_bf16` and the design's `attention_<design>_bf16`.
"""

from __future__ import annotations

import functools
import math

import torch

from se_tpu_torch.ops import _autograd, _build
from se_tpu_torch.ops.encoder import _aligned
from se_tpu_torch.parallel.mesh import map_leading

HEAD_DIM = 16  # the kernels' compile-time head width (Uformer's hidden 16)
SMALL_L_MAX = 32  # the largest L att_small_l takes (csrc SMALL_L_MAX)
FLASH_ROWS = 16   # query rows a warp of att_flash_tc
FLASH_KEYS = 64   # keys a tile of att_flash_tc
DESIGNS = ("flash_tc", "small_l")


def _reference(q, k, v, scale: float):
    """The plain twin. In bf16 it keeps the TPU kernel's rounding points
    (pallas_attention.py:43-49), not einsum's: q, k, v widened to fp32,
    the scores and the softmax in fp32, P rounded to bf16 after the
    normalisation, P V in fp32, the output rounded once."""
    if q.dtype == torch.bfloat16:
        q, k, v = q.float(), k.float(), v.float()
        e = torch.einsum("nhld,nhmd->nhlm", q, k) * scale
        p = torch.softmax(e, dim=-1).to(torch.bfloat16).float()
        return torch.einsum("nhlm,nhmd->nhld", p, v).to(torch.bfloat16)
    e = torch.einsum("nhld,nhmd->nhlm", q, k) * scale
    p = torch.softmax(e, dim=-1)
    return torch.einsum("nhlm,nhmd->nhld", p, v)


def att_design(n_heads_total: int, l: int) -> str:
    """The design csrc/attention.cu runs softmax(q k^T s) v with over
    (n_heads_total, l, 16): "small_l" (the packed CUDA-core kernel, bound
    by bytes) for every L it takes (<= SMALL_L_MAX), "flash_tc" (the
    tensor-core flash kernel) past it. Measured on an NVIDIA H100 80GB
    HBM3 at 700 W (chip_smoke.py phase 3, device time by kernel), small_l
    against flash_tc: at N H = 12,832 (the complex F-attention at B = 4)
    5.6 / 10.2 / 24.0 / 50.2 us against 28.2 / 28.4 / 34.9 / 51.7 at L = 4
    / 8 / 16 / 32; at L = 4 also 2.9 against 6.0 at N H = 1,604 and 40.7
    against 216.7 at 102,656 (B = 32). The choice rests on L alone."""
    del n_heads_total  # no N H measured moves it
    return "small_l" if l <= SMALL_L_MAX else "flash_tc"


def flash_warps(n_heads_total: int, l: int, sms: int) -> int:
    """att_flash_tc's warps a block (16 query rows each): 4, unless the
    grid (n_heads_total x row tiles) would then fill fewer than two waves
    of one block an SM, or a warp would own no row; then 2, then 1 (the
    real T-attention at B = 4: 16 (n, h) x 401 rows)."""
    for warps in (4, 2):
        tiles = -(-l // (FLASH_ROWS * warps))
        if (FLASH_ROWS * (warps - 1) < l
                and n_heads_total * tiles >= 2 * sms):
            return warps
    return 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sdp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (N, H, L, D) for each (n, h). Under
    an active mesh with a "model" axis N splits over the model group
    (`parallel.map_leading`: Uformer's folds, sequence-parallel)."""
    return map_leading(lambda q, k, v: _attention(q, k, v, scale),
                       (q, k, v))


def _attention(q, k, v, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return _reference(q, k, v, scale)
    n, h, l, _ = q.shape
    design = att_design(n * h, l)
    return _autograd.kernel_call(
        lambda q, k, v: _launch(q, k, v, scale, design),
        lambda q, k, v: _reference(q, k, v, scale), q, k, v)


def _launch(q, k, v, scale: float, design: str) -> torch.Tensor:
    """Launch `design` ("flash_tc" or "small_l") on CUDA tensors, its fp32
    or its bf16 variant by q, k and v's one dtype."""
    n, h, l, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"attention kernel takes D = {HEAD_DIM}, got {d}")
    dtype = _build.launch_dtype("attention", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check(t, (n, h, l, d), name, dtype)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    scale_log2 = float(scale) * math.log2(math.e)
    if design == "flash_tc":
        warps = flash_warps(n * h, l, _sm_count(q.device.index))
        _build.launch(_build.variant("se_att_flash_tc", dtype), q, k, v, out,
                      n * h, l, scale_log2, warps)
    elif design == "small_l":
        if l > SMALL_L_MAX:
            raise ValueError(f"attention small_l design takes L <= "
                             f"{SMALL_L_MAX}, got {l}")
        _build.launch(_build.variant("se_att_small_l", dtype), q, k, v, out,
                      n * h, l, scale_log2)
    else:
        raise ValueError(f"unknown attention design {design!r}")
    _build.LAUNCHES[_build.variant("attention", dtype)] += 1
    _build.LAUNCHES[_build.variant(f"attention_{design}", dtype)] += 1
    return out
