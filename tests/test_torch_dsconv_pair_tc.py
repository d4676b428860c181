"""The tensor-core design of the conformer's DSConv pair stage
(csrc/dsconv.cu `se_dsconv_pair_tc`: `dsconv_pre_tc`, `dsconv_post_tc`) on
the CPU: the kernels run only on the card (tests/test_torch_cuda.py), so
what they compute is formed here in plain torch exactly as they form it,
and held against the twin `dsconv._pair_reference`, itself held against
se_tpu's `_pair_reference` here and against the Pallas pair kernel in
tests/test_torch_dsconv_pair.py.

- The pre GEMM: each (row, component segment)'s mean and rstd, then the
  A tiles of x as they are, normalised in the fragments ((v - mean) * rstd
  * gamma + beta, gamma and beta zero past Cin), times `pack_pair_weights`'
  w1, bias and PReLU.
- The dilated convs: row p of A is the 9 taps of p at (t + (i - 1) d, f +
  j - 1), zero outside (T, F) and past Cm (the kernel's zero-filled
  copies), times the packed wd; at d = 1 and at d = 128 > T.
- a * sigmoid(g), LN2 per component segment, z * sigmoid(z).
- The output GEMM against the packed ws of both blocks, read back in its
  column order (per 8 channels re, im; then m), + bias + x, the fusion.
In float64 and in the kernel's 3xTF32 (tests/test_torch_lstm_tc.py's
emulation), within 1e-5 * max(1, max|twin|): fp32 sums of up to 576 terms
in another order. One LN case has |mean| >> std: normalising in the load
holds there, folding LN into the weights does not.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from se_tpu.ops import pallas_dsconv as jds
from se_tpu_torch.nn.conv import conv2d_nhwc
from se_tpu_torch.ops import dsconv
from test_torch_lstm_tc import matmul_3xtf32
from torch_kernel_inputs import close, pair_inputs, to_torch

RTOL = 1e-5
EPS = 1e-5


def _fp64(a, w):
    return (a.double() @ w.double()).float()


def _stats(x, nseg):
    """Each (row, segment)'s mean and rstd, two passes, as the twin."""
    xs = x.reshape(x.shape[0], nseg, -1)
    mu = xs.mean(-1)
    var = (xs - mu[..., None]).square().mean(-1)
    return mu, torch.rsqrt(var + EPS)


def pre_emulated(x, pk, nseg, matmul):
    """dsconv_pre_tc's branch: x (rows, Cin) -> y (rows, Cm)."""
    w1p, g1p, b1p, bb1, alpha = pk[:5]
    rows, cin = x.shape
    k1p, tot = w1p.shape[1], bb1.shape[1]
    mu, rs = _stats(x, nseg)
    seg = ((torch.arange(k1p) >= cin // nseg) & (nseg == 2)).long()
    a = F.pad(x, (0, k1p - cin))
    a = (a - mu[:, seg]) * rs[:, seg] * g1p + b1p
    y = matmul(a, w1p.t())[:, :tot] + bb1[0]
    return torch.where(y >= 0, y, alpha[0, 0] * y)


def gather_taps(y, t, f, totp, d):
    """y (B T F, Cm) -> A (B T F, 9 Cmp) as the copies fill it."""
    rows, tot = y.shape
    p = torch.arange(rows)
    ff, tt = p % f, (p // f) % t
    cols = []
    for i in range(3):
        for j in range(3):
            ts, fs = tt + (i - 1) * d, ff + j - 1
            ok = (ts >= 0) & (ts < t) & (fs >= 0) & (fs < f)
            src = (p + (i - 1) * d * f + j - 1).clamp(0, rows - 1)
            tap = torch.where(ok[:, None], y[src], torch.zeros_like(y[:1]))
            cols.append(F.pad(tap, (0, totp - tot)))
    return torch.cat(cols, dim=1)


def gated_emulated(y, pk, t, f, d1, d2, matmul):
    """The two dilated convs of a branch and a * sigmoid(g)."""
    wd1p, bd1, wd2p, bd2 = pk[5:9]
    tot = bd1.shape[1]
    totp = wd1p.shape[1] // 9
    a = matmul(gather_taps(y, t, f, totp, d1), wd1p.t())[:, :tot] + bd1[0]
    g = matmul(gather_taps(y, t, f, totp, d2), wd2p.t())[:, :tot] + bd2[0]
    return a * torch.sigmoid(g)


def ln2_swish(z, g2, b2, nseg):
    mu, rs = _stats(z, nseg)
    seg = torch.arange(z.shape[1]) // (z.shape[1] // nseg)
    zn = (z - mu[:, seg]) * rs[:, seg] * g2[0] + b2[0]
    return zn * torch.sigmoid(zn)


def stage_emulated(xc, xm, packed, d1, d2, matmul):
    """se_dsconv_pair_tc's arithmetic for one stage."""
    b, t, f, cc = xc.shape
    c = xm.shape[-1]
    pc, pm = packed
    xc2, xm2 = xc.reshape(-1, cc), xm.reshape(-1, c)
    zs = []
    for x, pk, nseg in ((xc2, pc, 2), (xm2, pm, 1)):
        y = pre_emulated(x, pk, nseg, matmul)
        z = gated_emulated(y, pk, t, f, d1, d2, matmul)
        zs.append(ln2_swish(z, pk[9], pk[10], nseg))
    zc, zm = zs
    wsc, wsm = pc[11], pm[11]
    cp = wsm.shape[0]
    sc = matmul(F.pad(zc, (0, wsc.shape[1] - zc.shape[1])), wsc.t())
    sc = sc.reshape(-1, cp // 8, 2, 8)  # (row, g8, part, c8)
    re = sc[:, :, 0].reshape(-1, cp)[:, :c] + pc[12][0, :c] + xc2[:, :c]
    im = sc[:, :, 1].reshape(-1, cp)[:, :c] + pc[12][0, c:] + xc2[:, c:]
    m = matmul(F.pad(zm, (0, wsm.shape[1] - zm.shape[1])), wsm.t())[:, :c]
    m = m + pm[12][0] + xm2
    s = torch.sigmoid(m)
    mag = torch.sqrt(torch.clamp(re * re + im * im,
                                 min=float(np.finfo(np.float32).eps)))
    return (torch.cat([re + s, im + s], dim=1).reshape(xc.shape),
            (m + torch.sigmoid(mag)).reshape(xm.shape))


def _inputs(rng, b, t, c, cm, mean=0.0):
    xc, xm, pc, pm = pair_inputs(rng, b, t, 4, c, cm)
    xc, xm = xc + mean, xm + mean
    return (*to_torch((xc, xm)), to_torch(pc), to_torch(pm))


def _close(got, want, rtol=RTOL):
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=rtol * scale)


# (B, T, C, Cm, d1, d2): narrow (Cm 4 per component: Cm padded to 32 and
# to the block's N; C 8 padded to a 32-channel pass), a narrow C 64 (the
# card test's), the conformer's widths (C 128, Cm 32 per component) with
# d = 128 > T, and d = 2, 64
STAGES = [(2, 5, 8, 4, 1, 8), (1, 9, 64, 4, 2, 1), (1, 7, 128, 32, 1, 128),
          (2, 6, 128, 32, 128, 1), (1, 9, 128, 32, 2, 64)]


@pytest.mark.parametrize("matmul", [_fp64, matmul_3xtf32],
                         ids=["fp64", "3xtf32"])
@pytest.mark.parametrize("b,t,c,cm,d1,d2", STAGES)
def test_stage_matches_twin(rng, b, t, c, cm, d1, d2, matmul):
    xc, xm, pc, pm = _inputs(rng, b, t, c, cm)
    packed = dsconv.pack_pair_weights(pc, pm)
    got = stage_emulated(xc, xm, packed, d1, d2, matmul)
    _close(got, dsconv._pair_reference(xc, xm, pc, pm, d1, d2))


@pytest.mark.parametrize("d1,d2,t", [(1, 128, 7), (64, 2, 9)])
def test_pair_twin_matches_jax_at_the_conformers_widths(rng, d1, d2, t):
    """The twin against se_tpu's composed `_pair_reference` at C 128, Cm
    32: 2e-5 absolute on O(1) outputs (tests/test_torch_dsconv_pair.py's)."""
    xc, xm, pc, pm = pair_inputs(rng, 1, t, 4, 128, 32)
    got = dsconv._pair_reference(*to_torch((xc, xm)), to_torch(pc),
                                 to_torch(pm), d1, d2)
    close(got, jds._pair_reference(xc, xm, pc + pm, d1, d2), 2e-5)


def _plain_pre(x, params, nseg):
    """LN1 -> 1x1 conv -> PReLU as the twin composes them."""
    (g1, b1, w1, bb1, alpha) = params[:5]
    xs = x.reshape(x.shape[0], nseg, -1)
    mu = xs.mean(-1, keepdim=True)
    var = (xs - mu).square().mean(-1, keepdim=True)
    xn = ((xs - mu) * torch.rsqrt(var + EPS)).reshape(x.shape)
    y = torch.matmul(xn * g1[0] + b1[0], w1) + bb1[0]
    return torch.where(y >= 0, y, alpha[0, 0] * y)


@pytest.mark.parametrize("mean", [0.0, 100.0])
@pytest.mark.parametrize("nseg,branch", [(2, 0), (1, 1)])
def test_pre_gemm_with_ln_in_the_load(rng, nseg, branch, mean):
    """Including |mean| = 100 >> std = 0.5."""
    xc, xm, pc, pm = _inputs(rng, 2, 6, 128, 32, mean)
    x = (xc, xm)[branch].reshape(-1, (256, 128)[branch])
    params = (pc, pm)[branch]
    pk = dsconv.pack_pair_weights(pc, pm)[branch]
    want = _plain_pre(x, params, nseg)
    _close([pre_emulated(x, pk, nseg, matmul_3xtf32)], [want])


def test_folding_ln_into_the_weights_cancels_where_mean_dominates(rng):
    """Why LN is applied in the load: x . (gamma W) - mean . colsum(gamma
    W), scaled by rstd, loses |mean| / std of precision (here 2e4), while
    the normalised A tile keeps it (test above)."""
    xc, _, pc, pm = _inputs(rng, 2, 6, 128, 32, mean=0.0)
    x = (xc * 0.005 + 100.0).reshape(-1, 256)
    g1, b1, w1, bb1 = pc[0], pc[1], pc[2], pc[3]
    mu, rs = _stats(x, 2)
    seg = torch.arange(256) // 128
    gw = g1[0][:, None] * w1
    colsum = torch.stack([gw[:128].sum(0), gw[128:].sum(0)])  # (seg, Cm)
    folded = sum(rs[:, s:s + 1] * (x[:, seg == s] @ gw[seg == s]
                                   - mu[:, s:s + 1] * colsum[s])
                 for s in range(2)) + b1[0] @ w1 + bb1[0]
    folded = torch.where(folded >= 0, folded, pc[4][0, 0] * folded)
    want = _plain_pre(x, pc, 2)
    err = float((folded - want).abs().max())
    assert err > RTOL * max(1.0, float(want.abs().max()))
    pk = dsconv.pack_pair_weights(pc, pm)[0]
    _close([pre_emulated(x, pk, 2, matmul_3xtf32)], [want])


@pytest.mark.parametrize("d,t", [(1, 9), (128, 7), (4, 9)])
def test_dilated_gather_is_the_dilated_conv(rng, d, t):
    """gather_taps . packed wd is conv2d_nhwc with padding (d, d), (1, 1)
    and dilation (d, 1), at d = 1 and d = 128 > T."""
    _, _, pc, pm = _inputs(rng, 1, t, 128, 32)
    for params, tot, n in ((pc, 64, 64), (pm, 32, 32)):
        y = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (2, t, 4, tot)).astype(np.float32))
        wd1p = dsconv.pack_pair_weights(pc, pm)[n == 32][5]
        got = _fp64(gather_taps(y.reshape(-1, tot), t, 4, wd1p.shape[1] // 9,
                                d), wd1p.t())[:, :tot]
        want = conv2d_nhwc(y, params[5].reshape(3, 3, tot, tot),
                           padding=((d, d), (1, 1)), dilation=(d, 1))
        _close([got], [want.reshape(-1, tot)])


@pytest.mark.parametrize("nseg", [1, 2])
def test_ln2_on_the_accumulators(rng, nseg):
    """LN2 per component segment (32 channels each), then z * sigmoid(z),
    as the twin's `ln` and swish."""
    z = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (40, 32 * nseg)).astype(np.float32) * 3 + 1)
    g2 = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 32 * nseg)).astype(np.float32))
    b2 = g2 * 0.5
    zs = z.reshape(40, nseg, 32)
    mu = zs.mean(-1, keepdim=True)
    var = (zs - mu).square().mean(-1, keepdim=True)
    zn = ((zs - mu) * torch.rsqrt(var + EPS)).reshape(z.shape) * g2[0] + b2[0]
    torch.testing.assert_close(ln2_swish(z, g2, b2, nseg),
                               zn * torch.sigmoid(zn), rtol=0, atol=1e-6)


@pytest.mark.parametrize("c,cm", [(128, 32), (8, 4), (64, 4)])
def test_pack_is_a_permutation_plus_zeros(rng, c, cm):
    _, _, pc, pm = _inputs(rng, 1, 1, c, cm)
    packed = dsconv.pack_pair_weights(pc, pm)
    cp = -(-c // 32) * 32
    for pk, params, cin, tot, n, rows in ((packed[0], pc, 2 * c, 2 * cm, 64,
                                           2 * cp),
                                          (packed[1], pm, c, cm, 32, cp)):
        k1p, totp = -(-cin // 32) * 32, -(-tot // 32) * 32
        assert pk[0].shape == (n, k1p) and pk[1].shape == (k1p,)
        assert pk[5].shape == pk[7].shape == (n, 9 * totp)
        assert pk[11].shape == (rows, -(-tot // 8) * 8)
        for i in (0, 5, 7, 11):
            src = params[{0: 2, 5: 5, 7: 7, 11: 11}[i]]
            vals = torch.sort(pk[i][pk[i] != 0]).values
            torch.testing.assert_close(vals, torch.sort(src[src != 0]).values,
                                       rtol=0, atol=0)
        for i in (3, 4, 6, 8, 9, 10, 12):
            assert pk[i] is params[i]


def test_out_pack_columns_hold_re_im_m_of_one_channel(rng):
    """Packed ws row (g8, part, c8): complex re of fusion channel ch at row
    16 (ch // 8) + ch % 8 holds wsc[:, ch], im 8 rows on wsc[:, C + ch];
    the real row ch holds wsm[:, ch]."""
    c = 40
    _, _, pc, pm = _inputs(rng, 1, 1, c, 4)
    wc, wm = dsconv.pack_pair_weights(pc, pm)[0][11], \
        dsconv.pack_pair_weights(pc, pm)[1][11]
    for ch in (0, 7, 9, 39):
        row = 16 * (ch // 8) + ch % 8
        torch.testing.assert_close(wc[row, :8], pc[11][:, ch])
        torch.testing.assert_close(wc[row + 8, :8], pc[11][:, c + ch])
        torch.testing.assert_close(wm[ch, :4], pm[11][:, ch])
        assert not wm[ch, 4:].any()
    assert not wc[16 * 5:].any()  # channels 40-63: padding


def test_uformer_keeps_stage_weights_until_they_change():
    """The conformer makes a stage's two 13-tuples (and, on the card, their
    packs) once, not once a call: the same objects come back until a
    weight changes in place; under autograd nothing is cached."""
    from se_tpu_torch.models.uformer import Uformer

    conf = Uformer(device="cpu").conformer
    with torch.no_grad():
        first = conf._stage_weights(3)
        again = conf._stage_weights(3)
        assert again is first and first[2] is None  # CPU: no packing
        conf.dsconv_real[3].sconv.conv.weight.mul_(2.0)
        changed = conf._stage_weights(3)
    assert changed is not first
    torch.testing.assert_close(changed[1][11], 2.0 * first[1][11])
    graph = conf._stage_weights(3)
    assert graph is not changed and graph[0][2].requires_grad
