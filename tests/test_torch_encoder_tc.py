"""The two designs of the Uformer encoder level (csrc/encoder.cu) on the
CPU: the kernels run only on the card (tests/test_torch_cuda.py), so what
they compute is formed here in plain torch exactly as they form it, and
held against the twin `encoder._reference` (itself held against se_tpu's
Pallas encoder in tests/test_torch_kernels.py).

- `encoder_level_tc`, the implicit GEMM: row p of A is the 10 taps of
  output position p = (b, t, fo), tap (it, jf) read at input row 2p + (it -
  1) F + jf - 2, zero where the tap falls before t = 0 or outside [0, F)
  and past Cin (the kernel's zero-filled copies); B is
  `pack_encoder_weights`' K-major layout, read back in its packed column
  order; then the epilogue. In float64 and in the kernel's 3xTF32
  (tests/test_torch_lstm_tc.py's emulation), at narrow widths (Cin and
  Cout not multiples of the tiles, T = 1), at level 1's padded widths and
  at level 5's (K = 2560): within 1e-5 * max(1, max|twin|) (fp32 sums of
  up to 2560 terms in another order).
- `encoder_level_cc`: its input tile (rows 2 p0 - F - 2 on) holds every
  row a chunk's taps read, at the tile row the kernel reads.
- `pack_encoder_weights` is a permutation of the kernels plus zeros;
  `level_design` sends Uformer's level 0 to the CUDA cores and levels 1-5
  to the tensor cores.
"""

import pytest
import torch
import torch.nn.functional as F

from se_tpu_torch.ops import encoder
from test_torch_decoder_tc import split_big
from test_torch_lstm_tc import matmul_3xtf32
from torch_kernel_inputs import enc_params, rand, to_torch

RTOL = 1e-5
KERNELS = (1, 8, 16, 32, 64, 128, 128)  # Uformer's encoder widths


def gather_taps(x: torch.Tensor, cinp: int) -> torch.Tensor:
    """(B, T, F, Cin) -> A (B T F/2, 10 Cinp) as the kernel's copies fill
    it: output position p reads input row 2p + (it - 1) F + jf - 2."""
    b, t, f, cin = x.shape
    m = b * t * (f // 2)
    rows = x.reshape(-1, cin)
    p = torch.arange(m)
    fo, tt = p % (f // 2), (p // (f // 2)) % t
    cols = []
    for it in range(2):
        for jf in range(5):
            src = 2 * p + (it - 1) * f + jf - 2
            ff = 2 * fo + jf - 2
            ok = ~((it == 0) & (tt == 0)) & (ff >= 0) & (ff < f)
            tap = torch.where(ok[:, None], rows[src.clamp(0, rows.shape[0] - 1)],
                              torch.zeros_like(rows[:1]))
            cols.append(F.pad(tap, (0, cinp - cin)))
    return torch.cat(cols, dim=1)


def epilogue(re, im, g, params):
    """Bias, BN affine, PReLU and the fusion on the sums (as
    unet_common.cuh `level_out`)."""
    yc = torch.cat([re, im], dim=-1) + params[1][0]
    ym = g + params[6][0]
    yc = encoder._prelu(yc * params[2][0] + params[3][0], params[4][0, 0])
    ym = encoder._prelu(ym * params[7][0] + params[8][0], params[9][0, 0])
    return encoder.fuse(yc, ym)


def implicit_gemm_level(xc, xm, params, packed, matmul):
    """encoder_level_tc's arithmetic: both branches' GEMMs against the
    packed weights, sums read back in the packed column order, then the
    epilogue; `matmul` forms the products (fp64 or 3xTF32)."""
    b, t, f, _ = xc.shape
    cout = params[5].shape[-1]
    wc, wm = packed
    coutp = wm.shape[0]
    sc = matmul(gather_taps(xc, wc.shape[1] // 10), wc.t())
    sm = matmul(gather_taps(xm, wm.shape[1] // 10), wm.t())
    sc = sc.reshape(-1, coutp // 8, 2, 8)  # (p, g8, part, c8)
    re = sc[:, :, 0].reshape(-1, coutp)[:, :cout]
    im = sc[:, :, 1].reshape(-1, coutp)[:, :cout]
    g = sm[:, :cout]
    yc, ym = epilogue(re, im, g, params)
    return (yc.reshape(b, t, f // 2, 2 * cout),
            ym.reshape(b, t, f // 2, cout))


def _fp64(a, w):
    return (a.double() @ w.double()).float()


def _inputs(rng, b, t, f, cin, cout):
    params = to_torch(enc_params(rng, cin, cout))
    xc, xm = to_torch((rand(rng, b, t, f, 2 * cin), rand(rng, b, t, f, cin)))
    return xc, xm, params


def _close(got, want):
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=RTOL * scale)


# (B, T, F, Cin, Cout): narrow (Cin and Cout not multiples of the tiles,
# T = 1, F = 2), level 0's Cin 1, level 1's padded widths (real Cin 8 ->
# 32), level 3's, level 5's (K = 2560 complex)
SHAPES = [(2, 5, 6, 3, 5), (1, 1, 8, 12, 20), (2, 3, 2, 4, 40),
          (1, 3, 16, 1, 8), (2, 3, 16, 8, 16), (1, 4, 8, 32, 64),
          (2, 3, 8, 128, 128)]


@pytest.mark.parametrize("matmul", [_fp64, matmul_3xtf32],
                         ids=["fp64", "3xtf32"])
@pytest.mark.parametrize("b,t,f,cin,cout", SHAPES)
def test_implicit_gemm_matches_twin(rng, b, t, f, cin, cout, matmul):
    xc, xm, params = _inputs(rng, b, t, f, cin, cout)
    packed = encoder.pack_encoder_weights(params)
    got = implicit_gemm_level(xc, xm, params, packed, matmul)
    _close(got, encoder._reference(xc, xm, params))


def test_one_tf32_pass_misses_the_tolerance_at_level_5(rng):
    """Why three passes: one TF32 product at K = 2560 is off by ~1e-3."""
    xc, xm, params = _inputs(rng, 2, 3, 8, 128, 128)
    packed = encoder.pack_encoder_weights(params)
    one = lambda a, w: split_big(a) @ split_big(w)
    got = implicit_gemm_level(xc, xm, params, packed, one)
    want = encoder._reference(xc, xm, params)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert err > RTOL * max(float(w.abs().max()) for w in want)


@pytest.mark.parametrize("f", [2, 8, 256])
def test_cuda_core_tile_holds_every_tap(f):
    """encoder_level_cc stages input rows g0 = 2 p0 - F - 2 .. g0 + 2 * 128
    + F + 2 of a chunk of 128 positions at tile rows 0 on; the tap (it, jf)
    of position p0 + tid is tile row 2 tid + it F + jf."""
    chunk, rows = 128, 2 * 128 + f + 3
    for p0 in (0, 128, 1024):
        g0 = 2 * p0 - f - 2
        for tid in range(chunk):
            for it in range(2):
                for jf in range(5):
                    src = 2 * (p0 + tid) + (it - 1) * f + jf - 2
                    row = 2 * tid + it * f + jf
                    assert 0 <= row < rows and g0 + row == src


@pytest.mark.parametrize("cin,cout", [(3, 5), (8, 16), (128, 128)])
def test_pack_is_a_permutation_plus_zeros(rng, cin, cout):
    _, _, params = _inputs(rng, 1, 1, 2, cin, cout)
    wc, wm = encoder.pack_encoder_weights(params)
    coutp = -(-cout // 32) * 32
    cinp_c, cinp_m = -(-2 * cin // 32) * 32, -(-cin // 32) * 32
    assert wc.shape == (2 * coutp, 10 * cinp_c)
    assert wm.shape == (coutp, 10 * cinp_m)
    for w, src in ((wc, params[0]), (wm, params[5])):
        vals = torch.sort(w[w != 0]).values
        want = torch.sort(src[src != 0]).values
        torch.testing.assert_close(vals, want, rtol=0, atol=0)


def test_pack_columns_hold_re_im_m_of_one_channel(rng):
    """Packed column (g8, part, c8): complex re of channel c at row 16 (c //
    8) + c % 8 holds wc[it, jf, :, c] at K tap * Cinp on, im 8 rows on
    holds wc[it, jf, :, Cout + c]; the real m of c at row 8 (c // 8) + c %
    8 holds wm[it, jf, :, c]."""
    cin, cout = 8, 24
    _, _, params = _inputs(rng, 1, 1, 2, cin, cout)
    wc, wm = encoder.pack_encoder_weights(params)
    kc, km = wc.shape[1] // 10, wm.shape[1] // 10
    for c in (0, 7, 9, 23):
        for it in range(2):
            for jf in range(5):
                tap = it * 5 + jf
                kcs = slice(tap * kc, tap * kc + 2 * cin)
                kms = slice(tap * km, tap * km + cin)
                row = 16 * (c // 8) + c % 8
                torch.testing.assert_close(wc[row, kcs], params[0][it, jf, :, c])
                torch.testing.assert_close(wc[row + 8, kcs],
                                           params[0][it, jf, :, cout + c])
                torch.testing.assert_close(wm[8 * (c // 8) + c % 8, kms],
                                           params[5][it, jf, :, c])
                assert not wc[row, tap * kc + 2 * cin:(tap + 1) * kc].any()


@pytest.mark.parametrize("level", range(6))
def test_level_design_of_uformers_levels(level):
    want = "cuda_core" if level == 0 else "tc"
    assert encoder.level_design(KERNELS[level]) == want


def test_uformer_keeps_encoder_weights_until_they_change():
    """Uformer makes a level's 10-tuple (and, on the card, its packed
    weights) once, not once a call: the same objects come back until a
    weight changes in place; under autograd nothing is cached."""
    from se_tpu_torch.models.uformer import Uformer

    model = Uformer(device="cpu")
    with torch.no_grad():
        first, packed = model._encoder_weights(1)
        again, _ = model._encoder_weights(1)
        assert again is first and packed is None  # on the CPU: no packing
        model.encoder_real[1][0].conv.weight.mul_(2.0)
        changed, _ = model._encoder_weights(1)
    assert changed is not first
    torch.testing.assert_close(changed[5], 2.0 * first[5])
    graph, _ = model._encoder_weights(1)
    assert graph is not changed and graph[0].requires_grad
