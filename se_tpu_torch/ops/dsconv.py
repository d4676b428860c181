"""Gated dilated DSConv blocks of the Uformer conformer: the port of
`dsconv_block` (kernel `_kernel`, math `_block_math`) and
`dsconv_pair_block` (kernel `_pair_kernel`, math `_pair_math`) in
se_tpu/ops/pallas_dsconv.py.

One block, on x (B, T, F, Cin) channel-concat ([re | im] for the complex
branch, ncomp = 2; the real branch has ncomp = 1):
LN per component (shared gamma/beta) -> 1x1 conv -> PReLU -> two 3x3 convs
dilated along T by d1 and d2 -> a * sigmoid(g) -> LN per component ->
z * sigmoid(z) -> 1x1 conv -> + x.

`params` is se_tpu's 13-tuple (`_dsconv_params`): (g1, b1, w1, bb1, alpha,
wd1, bd1, wd2, bd2, g2, b2, ws, bs), vectors shaped (1, C), alpha (1, 1),
the dilated kernels flattened to (9*Cm, Cm) in (t-tap, f-tap, cin) row
order. On a CUDA tensor `dsconv_block` launches csrc/dsconv.cu (two
kernels); on a CPU tensor it runs `_reference`, the plain twin.

`dsconv_pair_block` is one conformer stage: the complex block on xc =
[re | im], the real block on xm and Uformer's cross-branch fusion. On a
CUDA tensor it launches csrc/dsconv.cu's pair entry (a pre kernel per
branch, then one post kernel for both branches that applies the fusion
before it writes); on a CPU tensor it runs `_pair_reference`.
"""

from __future__ import annotations

import numpy as np
import torch

from se_tpu_torch.nn.conv import conv2d_nhwc
from se_tpu_torch.ops import _build

_LN_EPS = 1e-5
_FUSION_EPS = float(np.finfo(np.float32).eps)


def _prelu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


def _reference(x, params, d1: int, d2: int, ncomp: int):
    (g1, b1, w1, bb1, alpha, wd1, bd1, wd2, bd2, g2, b2, ws, bs) = params
    tot = w1.shape[1]

    def ln(z, g, b):
        c = z.shape[-1] // ncomp
        zs = z.reshape(*z.shape[:-1], ncomp, c)
        mu = zs.mean(-1, keepdim=True)
        var = (zs - mu).square().mean(-1, keepdim=True)
        zn = ((zs - mu) * torch.rsqrt(var + _LN_EPS)).reshape(z.shape)
        return zn * g[0] + b[0]

    y = torch.matmul(ln(x, g1, b1), w1) + bb1[0]
    y = _prelu(y, alpha[0, 0])

    def dconv(w9, b, d):
        w = w9.reshape(3, 3, tot, tot)
        return conv2d_nhwc(y, w, padding=((d, d), (1, 1)),
                           dilation=(d, 1)) + b[0]

    z = dconv(wd1, bd1, d1) * torch.sigmoid(dconv(wd2, bd2, d2))
    z = ln(z, g2, b2)
    z = z * torch.sigmoid(z)
    return x + (torch.matmul(z, ws) + bs[0])


def _check_block(x, params, ncomp: int, what: str) -> int:
    """Raise unless x and the 13-tuple suit the kernel; return Cm."""
    (g1, b1, w1, bb1, alpha, wd1, bd1, wd2, bd2, g2, b2, ws, bs) = params
    cin, tot = x.shape[-1], w1.shape[-1]
    # shared memory: 16 rows of Cin (pre) and of 10*Cm (post) under 48 KB
    if (ncomp not in (1, 2) or cin % ncomp or tot % ncomp or tot > 64
            or cin > 768):
        raise ValueError(f"{what} kernel: unsupported ncomp={ncomp}, "
                         f"Cin={cin}, Cm={tot}")
    shapes = {"x": (x, x.shape), "g1": (g1, (1, cin)),
              "b1": (b1, (1, cin)), "w1": (w1, (cin, tot)),
              "bb1": (bb1, (1, tot)), "alpha": (alpha, (1, 1)),
              "wd1": (wd1, (9 * tot, tot)), "bd1": (bd1, (1, tot)),
              "wd2": (wd2, (9 * tot, tot)), "bd2": (bd2, (1, tot)),
              "g2": (g2, (1, tot)), "b2": (b2, (1, tot)),
              "ws": (ws, (tot, cin)), "bs": (bs, (1, cin))}
    for name, (arr, shape) in shapes.items():
        _build.check(arr, shape, name)
    return tot


def dsconv_block(x: torch.Tensor, params, d1: int, d2: int,
                 ncomp: int) -> torch.Tensor:
    """x (B, T, F, Cin) -> same shape, residual included."""
    if x.device.type == "cpu":
        return _reference(x, tuple(params), d1, d2, ncomp)
    b, t, f, cin = x.shape
    tot = _check_block(x, params, ncomp, "dsconv")
    y = torch.empty((b, t, f, tot), device=x.device, dtype=x.dtype)
    out = torch.empty_like(x)
    _build.launch("se_dsconv_fwd", x, *params, y, out, b, t, f, cin, tot,
                  ncomp, d1, d2)
    _build.LAUNCHES["dsconv"] += 1
    return out


def _pair_reference(xc, xm, params_c, params_m, d1: int, d2: int):
    """Both blocks, then the fusion: |z| = sqrt(max(re^2 + im^2, eps)),
    re/im += sigmoid(m), m += sigmoid(|z|)."""
    yc = _reference(xc, tuple(params_c), d1, d2, ncomp=2)
    ym = _reference(xm, tuple(params_m), d1, d2, ncomp=1)
    c = yc.shape[-1] // 2
    re, im = yc[..., :c], yc[..., c:]
    cplx_mag = torch.sqrt(torch.clamp(re * re + im * im, min=_FUSION_EPS))
    s = torch.sigmoid(ym)
    return torch.cat([re + s, im + s], dim=-1), ym + torch.sigmoid(cplx_mag)


def dsconv_pair_block(xc: torch.Tensor, xm: torch.Tensor, params_c,
                      params_m, d1: int, d2: int):
    """One conformer stage: xc (B, T, F, 2C) = [re | im] and xm (B, T, F,
    C) -> (oc, om) of the same shapes, residuals and fusion included."""
    params_c, params_m = tuple(params_c), tuple(params_m)
    if xc.device.type == "cpu":
        return _pair_reference(xc, xm, params_c, params_m, d1, d2)
    b, t, f, cc = xc.shape
    cm = xm.shape[-1]
    if xm.shape != (b, t, f, cc // 2) or cc != 2 * cm:
        raise ValueError(f"dsconv_pair kernel: xc {tuple(xc.shape)} must be "
                         f"xm {tuple(xm.shape)} with twice the channels")
    totc = _check_block(xc, params_c, 2, "dsconv_pair")
    totm = _check_block(xm, params_m, 1, "dsconv_pair")
    yc = torch.empty((b, t, f, totc), device=xc.device, dtype=xc.dtype)
    ym = torch.empty((b, t, f, totm), device=xc.device, dtype=xc.dtype)
    oc, om = torch.empty_like(xc), torch.empty_like(xm)
    _build.launch("se_dsconv_pair_fwd", xc, *params_c, xm, *params_m, yc, ym,
                  oc, om, b, t, f, cm, totc, totm, d1, d2)
    _build.LAUNCHES["dsconv_pair"] += 1
    return oc, om
