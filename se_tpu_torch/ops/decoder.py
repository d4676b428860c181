"""One Uformer decoder level, both branches: the port of
se_tpu/ops/pallas_decoder.py (`decoder_level`, kernel `_kernel`, math
`_level_math`, and `split_phase_weights`).

Per branch: the channel-concat [skip, x] -> stride-(1, 2) transposed (2, 5)
conv (torch geometry: padding (0, 2), output_padding (0, 1), output T
trimmed to the input's) in phase-split form: even output columns from
f-taps wf0/2/4, odd ones from wf1/3 -> (BN affine -> PReLU, if `has_bn`);
then the cross-branch `fusion`. `params` is se_tpu's 12-tuple, complex then
real branch, each (w_even (6, Cin_b, Cout_b), w_odd (4, Cin_b, Cout_b),
bias (1, Cout_b), bn_scale (1, Cout_b), bn_shift (1, Cout_b), alpha (1, 1)).
The complex input is [skip_re | x_re | skip_im | x_im]. On a CUDA tensor
`decoder_level` launches csrc/decoder.cu; on a CPU tensor it runs
`_reference`, the plain twin.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from se_tpu_torch.ops import _build
from se_tpu_torch.ops.encoder import _prelu, fuse


def split_phase_weights(kernel: torch.Tensor):
    """(2, 5, Cin, Cout) unflipped tconv kernel -> (w_even (6, Cin, Cout),
    w_odd (4, Cin, Cout)), taps ordered (t-tap major, f-tap): with
    wf = flip(kernel), even-phase f-taps are [wf0, wf2, wf4] over
    x[q-1..q+1], odd-phase f-taps [wf1, wf3] over x[q..q+1]."""
    wf = torch.flip(kernel, dims=(0, 1))
    cin, cout = kernel.shape[2], kernel.shape[3]
    w_even = wf[:, 0::2].reshape(2 * 3, cin, cout)
    w_odd = wf[:, 1::2].reshape(2 * 2, cin, cout)
    return w_even, w_odd


def _tconv_phase_split(x, w_even, w_odd, bias):
    """x (B, T, F, Cin) -> (B, T, 2F, Cout), one matmul per tap."""
    b, t, f, _ = x.shape
    xp_t = F.pad(x, (0, 0, 0, 0, 1, 0))  # row t reads x[t-1], x[t]

    def phase(w_taps, pads, n_taps):
        xf = F.pad(xp_t, (0, 0) + pads)
        acc = 0
        for it in range(2):
            for jf in range(n_taps):
                tap = xf[:, it : it + t, jf : jf + f]
                acc = acc + torch.matmul(tap, w_taps[it * n_taps + jf])
        return acc

    y_even = phase(w_even, (1, 1), 3)
    y_odd = phase(w_odd, (0, 1), 2)
    y = torch.stack([y_even, y_odd], dim=3).reshape(b, t, 2 * f, -1)
    return y + bias


def _reference(xc, xm, params, has_bn: bool):
    def branch(x, w_e, w_o, b, s, t, a):
        y = _tconv_phase_split(x, w_e, w_o, b[0])
        return _prelu(y * s[0] + t[0], a[0, 0]) if has_bn else y

    return fuse(branch(xc, *params[:6]), branch(xm, *params[6:12]))


def decoder_level(xc: torch.Tensor, xm: torch.Tensor, params,
                  has_bn: bool):
    """xc (B, T, F, 2*Cc) = [skip_re | x_re | skip_im | x_im], xm (B, T, F,
    Cc) = [skip_m | m] -> ((B, T, 2F, 2*Cout), (B, T, 2F, Cout))."""
    params = tuple(params)
    if xc.device.type == "cpu":
        return _reference(xc, xm, params, has_bn)
    b, t, f, c2 = xc.shape
    cc, cout = c2 // 2, params[6].shape[-1]
    names = ("wce", "wco", "bc", "sc", "tc", "ac",
             "wme", "wmo", "bm", "sm", "tm", "am")
    shapes = ((6, 2 * cc, 2 * cout), (4, 2 * cc, 2 * cout), (1, 2 * cout),
              (1, 2 * cout), (1, 2 * cout), (1, 1),
              (6, cc, cout), (4, cc, cout), (1, cout), (1, cout), (1, cout),
              (1, 1))
    _build.check(xc, (b, t, f, 2 * cc), "xc")
    _build.check(xm, (b, t, f, cc), "xm")
    for name, arr, shape in zip(names, params, shapes):
        _build.check(arr, shape, name)
    yc = torch.empty((b, t, 2 * f, 2 * cout), device=xc.device,
                     dtype=xc.dtype)
    ym = torch.empty((b, t, 2 * f, cout), device=xc.device, dtype=xc.dtype)
    _build.launch("se_decoder_level", xc, xm, *params, yc, ym, b, t, f, cc,
                  cout, bool(has_bn))
    _build.LAUNCHES["decoder"] += 1
    return yc, ym
