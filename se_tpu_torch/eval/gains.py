"""Statistical gain functions of DeepXi (the port of se_tpu/eval/gains.py;
ref DeepXi/deepxi/gain.py:13-192), on tensors of any shape and device.

The Bessel terms of the MMSE-STSA gain are `torch.special.i0` / `i1`; the
exponential integral E1 of the MMSE-LSA gain is se_tpu's branch-free
Abramowitz & Stegun approximation, copied, not an exact E1 (they part by
up to 5e-5 relative for x > 1).
"""

from __future__ import annotations

import math

import torch


def exp1(x: torch.Tensor) -> torch.Tensor:
    """E1(x) for x > 0: A&S 5.1.53 (|err| < 2e-7) for x <= 1, the rational
    5.1.56 (|rel err| < 5e-5) for x > 1, joined by a select."""
    x = torch.clamp(x, min=1e-12)
    a = (-0.57721566, 0.99999193, -0.24991055,
         0.05519968, -0.00976004, 0.00107857)
    small = -torch.log(x) + a[0] + x * (
        a[1] + x * (a[2] + x * (a[3] + x * (a[4] + x * a[5]))))
    xs = torch.clamp(x, min=1.0)  # the large branch well conditioned
    num = xs * xs + 2.334733 * xs + 0.250621
    den = xs * xs + 3.330657 * xs + 1.681534
    large = torch.exp(-xs) / xs * (num / den)
    return torch.where(x <= 1.0, small, large)


def wf(xi):
    """Wiener filter."""
    return xi / (xi + 1.0)


def srwf(xi):
    """Square-root Wiener filter."""
    return torch.sqrt(wf(xi))


def cwf(xi):
    """Constrained Wiener filter (ref gain.py:95-105)."""
    return wf(torch.sqrt(xi))


def irm(xi):
    """Ideal ratio mask (the square-root Wiener filter)."""
    return srwf(xi)


def ibm(xi):
    """Ideal binary mask at 0 dB."""
    return (xi > 1.0).to(xi.dtype)


def mmse_stsa(xi, gamma):
    """MMSE short-time spectral amplitude estimator in its Bessel form,
    the Wiener gain where that is NaN or Inf (ref gain.py:13-45): i0 / i1
    overflow fp32 past nu / 2 ~ 89."""
    xi = torch.clamp(xi, min=1e-12)
    gamma = torch.clamp(gamma, min=1e-12)
    nu = xi * gamma / (1.0 + xi)
    g = ((math.sqrt(math.pi) / 2.0) * (torch.sqrt(nu) / gamma)
         * torch.exp(-nu / 2.0)
         * ((1.0 + nu) * torch.special.i0(nu / 2.0)
            + nu * torch.special.i1(nu / 2.0)))
    bad = torch.isnan(g) | torch.isinf(g)
    return torch.where(bad, wf(xi), g)


def mmse_lsa(xi, gamma):
    """MMSE log-spectral amplitude estimator (ref gain.py:47-69)."""
    xi = torch.clamp(xi, min=1e-12)
    gamma = torch.clamp(gamma, min=1e-12)
    v1 = xi / (1.0 + xi)
    return v1 * torch.exp(0.5 * exp1(v1 * gamma))


def dgwf(xi, cdm):
    """Dual-gain Wiener filter (ref gain.py:107-127): g+ where the
    constructive/destructive mask `cdm` holds, g- elsewhere."""
    v1 = 2.0 / math.pi
    v2 = 2.0 * v1
    v3 = torch.sqrt(xi)
    v4 = xi + 1.0
    g_minus = (xi - v1 * v3) / (v4 - v2 * v3)
    g_plus = (xi + v1 * v3) / (v4 + v2 * v3)
    return torch.where(cdm, g_plus, g_minus)


def deepmmse(xi, gamma):
    """MMSE noise-periodogram estimate gain (ref gain.py:150-167)."""
    return 1.0 / torch.square(1.0 + xi) + xi / (gamma * (1.0 + xi))


def gfunc(xi, gamma=None, gtype: str = "mmse-lsa", cdm=None):
    """Gain dispatcher (ref gain.py:169-192)."""
    table = {
        "mmse-lsa": lambda: mmse_lsa(xi, gamma),
        "mmse-stsa": lambda: mmse_stsa(xi, gamma),
        "wf": lambda: wf(xi),
        "srwf": lambda: srwf(xi),
        "cwf": lambda: cwf(xi),
        "dgwf": lambda: dgwf(xi, cdm),
        "irm": lambda: irm(xi),
        "ibm": lambda: ibm(xi),
        "deepmmse": lambda: deepmmse(xi, gamma),
    }
    if gtype not in table:
        raise ValueError(f"invalid gain function type {gtype!r}")
    return table[gtype]()
