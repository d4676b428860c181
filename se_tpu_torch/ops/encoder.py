"""One Uformer encoder level, both branches: the port of
se_tpu/ops/pallas_encoder.py (`encoder_level`, kernel `_kernel`, math
`_level_math`).

Per branch: a stride-(1, 2) (2, 5) conv, causal along T (pad (1, 0)) and
padded (2, 2) along F -> BN (eval affine) -> PReLU; then the cross-branch
`fusion`. `params` is se_tpu's 10-tuple, complex then real branch, each
(w (2, 5, Cin_b, Cout_b), bias (1, Cout_b), bn_scale (1, Cout_b),
bn_shift (1, Cout_b), alpha (1, 1)); the complex weight is the interleaved
[[Wr, Wi], [-Wi, Wr]] kernel on channel-concat [re | im]. On a CUDA
tensor `encoder_level` launches csrc/encoder.cu; on a CPU tensor it runs
`_reference`, the plain twin.
"""

from __future__ import annotations

import numpy as np
import torch

from se_tpu_torch.nn.conv import conv2d_nhwc
from se_tpu_torch.ops import _build

EPS = float(np.finfo(np.float32).eps)


def _prelu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


def fusion(re, im, mag):
    """Uformer's cross-branch coupling: mag += sigmoid(|cplx|), re/im +=
    sigmoid(mag), with |cplx| = sqrt(max(re^2 + im^2, EPS))."""
    cplx_mag = torch.sqrt(torch.clamp(re * re + im * im, min=EPS))
    mag_out = mag + torch.sigmoid(cplx_mag)
    s = torch.sigmoid(mag)
    return re + s, im + s, mag_out


def fuse(yc: torch.Tensor, ym: torch.Tensor):
    """`fusion` on channel-concat yc = [re | im] and the real branch ym."""
    c = yc.shape[-1] // 2
    re, im, mag = fusion(yc[..., :c], yc[..., c:], ym)
    return torch.cat([re, im], dim=-1), mag


def _reference(xc, xm, params):
    def branch(x, w, b, s, t, a):
        y = conv2d_nhwc(x, w, strides=(1, 2), padding=((1, 0), (2, 2)))
        return _prelu((y + b[0]) * s[0] + t[0], a[0, 0])

    return fuse(branch(xc, *params[:5]), branch(xm, *params[5:10]))


def encoder_level(xc: torch.Tensor, xm: torch.Tensor, params):
    """xc (B, T, F, 2*Cin), xm (B, T, F, Cin) -> ((B, T, F//2, 2*Cout),
    (B, T, F//2, Cout))."""
    params = tuple(params)
    if xc.device.type == "cpu":
        return _reference(xc, xm, params)
    b, t, f, c2 = xc.shape
    cin, cout = c2 // 2, params[5].shape[-1]
    if f % 2:
        raise ValueError(f"encoder kernel: F must be even, got {f}")
    names = ("wc", "bc", "sc", "tc", "ac", "wm", "bm", "sm", "tm", "am")
    shapes = ((2, 5, 2 * cin, 2 * cout), (1, 2 * cout), (1, 2 * cout),
              (1, 2 * cout), (1, 1), (2, 5, cin, cout), (1, cout),
              (1, cout), (1, cout), (1, 1))
    _build.check(xc, (b, t, f, 2 * cin), "xc")
    _build.check(xm, (b, t, f, cin), "xm")
    for name, arr, shape in zip(names, params, shapes):
        _build.check(arr, shape, name)
    yc = torch.empty((b, t, f // 2, 2 * cout), device=xc.device,
                     dtype=xc.dtype)
    ym = torch.empty((b, t, f // 2, cout), device=xc.device, dtype=xc.dtype)
    _build.launch("se_encoder_level", xc, xm, *params, yc, ym, b, t, f, cin,
                  cout)
    _build.LAUNCHES["encoder"] += 1
    return yc, ym
