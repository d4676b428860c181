"""The tensor-core design of the Uformer decoder level (csrc/decoder.cu
`decoder_level_tc`) on the CPU: the kernel runs only on the card
(tests/test_torch_cuda.py), so what it computes is formed here in plain
torch exactly as the kernel forms it, and held against the twin
`decoder._reference` (itself held against se_tpu's Pallas decoder in
tests/test_torch_kernels.py).

- The implicit GEMM: row p of A is the 6 taps of input position p, tap
  (it, jf) read at p + (it - 1) F + (jf - 1), zero where the tap falls
  before t = 0 or outside [0, F) and past Cin (the kernel's zero-filled
  copies); B is `pack_decoder_weights`' K-major layout, read back in its
  packed column order; then the epilogue.
- In float64, and in the kernel's 3xTF32 (tests/test_torch_lstm_tc.py's
  emulation: big = v rounded to TF32, small truncated by the mma), at
  narrow widths and at level 0's (Cc 256, Cout 128, K = 3072), with and
  without BN: within 1e-5 * max(1, max|twin|) (fp32 sums of up to 3072
  terms in another order).
- `pack_decoder_weights` is a permutation of the phase weights plus
  zeros, and `level_design` sends Uformer's levels 0-4 to the tensor cores
  and level 5 to the CUDA cores.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from se_tpu_torch.ops import decoder
from se_tpu_torch.ops.encoder import _prelu, fuse
from test_torch_lstm_tc import matmul_3xtf32
from torch_kernel_inputs import dec_params, rand, to_torch

RTOL = 1e-5
KERNELS = (1, 8, 16, 32, 64, 128, 128)  # Uformer's encoder widths


def gather_taps(x: torch.Tensor, cinp: int) -> torch.Tensor:
    """(B, T, F, Cin) -> A (B T F, 6 Cinp) as the kernel's copies fill it."""
    b, t, f, cin = x.shape
    m = b * t * f
    rows = x.reshape(m, cin)
    p = torch.arange(m)
    q, tt = p % f, (p // f) % t
    cols = []
    for it in range(2):
        for jf in range(3):
            src = p + (it - 1) * f + (jf - 1)
            ok = ~((it == 0) & (tt == 0))
            if jf == 0:
                ok &= q != 0
            if jf == 2:
                ok &= q != f - 1
            tap = torch.where(ok[:, None], rows[src.clamp(0, m - 1)],
                              torch.zeros_like(rows[:1]))
            cols.append(F.pad(tap, (0, cinp - cin)))
    return torch.cat(cols, dim=1)


def implicit_gemm_level(xc, xm, params, has_bn, packed, matmul):
    """decoder_level_tc's arithmetic: both branches' GEMMs against the
    packed weights, sums read back in the packed column order, then the
    epilogue; `matmul` forms the products (fp64 or 3xTF32)."""
    b, t, f, _ = xc.shape
    cout = params[6].shape[-1]
    wc, wm = packed
    coutp = wm.shape[0] // 2
    sc = matmul(gather_taps(xc, wc.shape[1] // 6), wc.t())
    sm = matmul(gather_taps(xm, wm.shape[1] // 6), wm.t())
    sc = sc.reshape(-1, coutp // 8, 2, 2, 8)  # (p, g8, phase, part, c8)
    sm = sm.reshape(-1, coutp // 8, 2, 8)     # (p, g8, phase, c8)
    outs_c, outs_m = [], []
    for ph in range(2):
        re = sc[:, :, ph, 0].reshape(-1, coutp)[:, :cout]
        im = sc[:, :, ph, 1].reshape(-1, coutp)[:, :cout]
        g = sm[:, :, ph].reshape(-1, coutp)[:, :cout]
        yc = torch.cat([re, im], dim=1) + params[2][0]
        ym = g + params[8][0]
        if has_bn:
            yc = _prelu(yc * params[3][0] + params[4][0], params[5][0, 0])
            ym = _prelu(ym * params[9][0] + params[10][0], params[11][0, 0])
        oc, om = fuse(yc, ym)
        outs_c.append(oc)
        outs_m.append(om)
    # output column 2q + phase of row (b, t)
    yc = torch.stack(outs_c, dim=1).reshape(b, t, 2 * f, 2 * cout)
    ym = torch.stack(outs_m, dim=1).reshape(b, t, 2 * f, cout)
    return yc, ym


def _fp64(a, w):
    return (a.double() @ w.double()).float()


def _inputs(rng, b, t, f, cc, cout):
    params = to_torch(dec_params(rng, cc, cout))
    xc, xm = to_torch((rand(rng, b, t, f, 2 * cc), rand(rng, b, t, f, cc)))
    return xc, xm, params


def _close(got, want):
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=RTOL * scale)


# (B, T, F, Cc, Cout): narrow (Cin and Cout not multiples of the tiles,
# T = 1, F = 1 and 4), level 3's widths, level 0's
SHAPES = [(2, 5, 4, 6, 3), (1, 1, 4, 12, 20), (2, 3, 1, 8, 16),
          (1, 4, 8, 64, 16), (2, 3, 4, 256, 128)]


@pytest.mark.parametrize("has_bn", [True, False])
@pytest.mark.parametrize("matmul", [_fp64, matmul_3xtf32],
                         ids=["fp64", "3xtf32"])
@pytest.mark.parametrize("b,t,f,cc,cout", SHAPES)
def test_implicit_gemm_matches_twin(rng, b, t, f, cc, cout, matmul, has_bn):
    xc, xm, params = _inputs(rng, b, t, f, cc, cout)
    packed = decoder.pack_decoder_weights(params)
    got = implicit_gemm_level(xc, xm, params, has_bn, packed, matmul)
    _close(got, decoder._reference(xc, xm, params, has_bn))


def test_one_tf32_pass_misses_the_tolerance_at_level_0(rng):
    """Why three passes: one TF32 product at K = 3072 is off by ~1e-3."""
    xc, xm, params = _inputs(rng, 2, 3, 4, 256, 128)
    packed = decoder.pack_decoder_weights(params)
    one = lambda a, w: split_big(a) @ split_big(w)
    got = implicit_gemm_level(xc, xm, params, True, packed, one)
    want = decoder._reference(xc, xm, params, True)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert err > RTOL * max(float(w.abs().max()) for w in want)


def split_big(v):
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("cc,cout", [(6, 3), (256, 128), (12, 20)])
def test_pack_is_a_permutation_plus_zeros(rng, cc, cout):
    _, _, params = _inputs(rng, 1, 1, 1, cc, cout)
    wc, wm = decoder.pack_decoder_weights(params)
    coutp = -(-cout // 16) * 16
    cinp_c, cinp_m = -(-2 * cc // 32) * 32, -(-cc // 32) * 32
    assert wc.shape == (4 * coutp, 6 * cinp_c)
    assert wm.shape == (2 * coutp, 6 * cinp_m)
    for w, (we, wo) in ((wc, params[0:2]), (wm, params[6:8])):
        vals = torch.sort(w[w != 0]).values
        want = torch.cat([we.flatten(), wo.flatten()])
        want = torch.sort(want[want != 0]).values
        torch.testing.assert_close(vals, want, rtol=0, atol=0)


def test_pack_columns_hold_re_im_m_of_one_channel(rng):
    """Packed column (g8, phase, part, c8): complex re even of channel c at
    row 8 * 4 * (c // 8) + c % 8 holds w_even[tap, :, c], im even 8 rows
    on holds w_even[tap, :, Cout + c]; the odd phase's jf = 0 taps are
    zero."""
    cc, cout = 8, 24
    _, _, params = _inputs(rng, 1, 1, 1, cc, cout)
    wc, _ = decoder.pack_decoder_weights(params)
    kc = wc.shape[1] // 6
    we, wo = params[0], params[1]
    for c in (0, 7, 9, 23):
        base = 32 * (c // 8) + c % 8
        for it in range(2):
            for jf in range(3):
                tap = it * 3 + jf
                k = slice(tap * kc, tap * kc + 2 * cc)
                torch.testing.assert_close(wc[base, k],
                                           we[tap, :, c])
                torch.testing.assert_close(wc[base + 8, k],
                                           we[tap, :, cout + c])
                odd_re = wc[base + 16, k]
                odd_im = wc[base + 24, k]
                if jf == 0:
                    assert not odd_re.any() and not odd_im.any()
                else:
                    torch.testing.assert_close(odd_re,
                                               wo[it * 2 + jf - 1, :, c])
                    torch.testing.assert_close(
                        odd_im, wo[it * 2 + jf - 1, :, cout + c])


@pytest.mark.parametrize("level", range(6))
def test_level_design_of_uformers_levels(level):
    cc, cout = 2 * KERNELS[6 - level], KERNELS[5 - level]
    want = "tc" if level < 5 else "cuda_core"
    assert decoder.level_design(cc, cout) == want


def test_level_design_by_width():
    assert decoder.level_design(256, 8) == "tc"
    assert decoder.level_design(256, 4) == "cuda_core"  # Cout < 8
    assert decoder.level_design(6, 16) == "cuda_core"   # Cc % 4 != 0


def test_uformer_keeps_decoder_weights_until_they_change():
    """Uformer makes a level's 12-tuple (and, on the card, its packed
    weights) once, not once a call: the same objects come back until a
    weight changes in place; under autograd nothing is cached."""
    from se_tpu_torch.models.uformer import Uformer

    model = Uformer(device="cpu")
    with torch.no_grad():
        first, packed = model._decoder_weights(0)
        again, _ = model._decoder_weights(0)
        assert again is first and packed is None  # on the CPU: no packing
        model.decoder_real[0][0].conv.weight.mul_(2.0)
        changed, _ = model._decoder_weights(0)
    assert changed is not first
    torch.testing.assert_close(changed[6], 2.0 * first[6])
    graph, _ = model._decoder_weights(0)
    assert graph is not changed and graph[0].requires_grad
