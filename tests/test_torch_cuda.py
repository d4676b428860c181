"""The CUDA kernels of se_tpu_torch against their plain PyTorch twins on the
card. Marked `cuda`; each test skips without an NVIDIA GPU (the kernels
have no CPU mode). Imports no JAX, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance 1e-4 absolute on O(1) outputs: fp32 on both sides, sums in
another order (kernel loops against cuBLAS/cuDNN with TF32 off). The bf16
variants against the bf16 twins: `bf16_close` (one bf16 ulp plus 1e-6 of
the largest output; attention also one P element's rounding flip on at
most 1e-3 of the elements).
"""

import numpy as np
import pytest
import torch

from se_tpu_torch.ops import _build, attention, decoder, dsconv, encoder, lstm
from se_tpu_torch.ops import stft as plain_stft
from se_tpu_torch.ops import stft_fused
from se_tpu_torch.ops._dtype import LSTM_FLOOR
from torch_kernel_inputs import (
    att_flip_slack, att_inputs, bf16_close, close, dec_params, dsconv_params,
    enc_params, lstm_inputs, pair_inputs, rand, to_bf16, to_torch,
)

ATOL = 1e-4
pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    return np.random.default_rng(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _kernel_vs_twin(fn, args, dev):
    """fn on CUDA copies of args (the kernel) against fn on the CPU ones
    (the twin)."""
    def to(x):
        if isinstance(x, tuple):
            return tuple(a.to(dev) for a in x)
        return x.to(dev) if isinstance(x, torch.Tensor) else x

    want = fn(*args)
    got = fn(*[to(a) for a in args])
    torch.cuda.synchronize()
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert all(g.device.type == "cuda" for g in got)
    close(got, want, ATOL)


@pytest.mark.parametrize("l", [1, 4, 65, 401])
def test_attention_kernel_matches_twin(gen, dev, l):
    q, k, v = to_torch(att_inputs(gen, 3, 8, l))
    _kernel_vs_twin(attention.sdp_attention, (q, k, v, 0.25), dev)


@pytest.mark.parametrize("ncomp,d1,d2", [(2, 1, 128), (1, 128, 1)])
def test_dsconv_kernel_matches_twin(gen, dev, ncomp, d1, d2):
    cin = 128 * ncomp
    params = to_torch(dsconv_params(gen, cin, 32, ncomp))
    (x,) = to_torch((rand(gen, 2, 50, 4, cin, scale=0.5),))
    _kernel_vs_twin(lambda x, p: dsconv.dsconv_block(x, p, d1, d2, ncomp),
                    (x, params), dev)


# (N, H, L): a small N H (16: the real T-attention at B = 4) and a large
# one (1604 x 8: the complex F-attention at B = 4) at L = 1 to 1500 (one
# key; within one 64-key tile; one past it; Uformer's 401), and the
# T-attention at B = 32. Each on every design that takes its L.
ATT_LENGTHS = (1, 4, 16, 63, 64, 65, 401, 1500)
ATT_CASES = [(n, h, length, design)
             for n, h in ((16, 1), (1604, 8)) for length in ATT_LENGTHS
             for design in attention.DESIGNS
             if design == "flash_tc" or length <= attention.SMALL_L_MAX]
ATT_CASES += [(128, 8, 401, "flash_tc"), (128, 1, 401, "flash_tc")]


def _att_twin(q, k, v, scale):
    """The twin on the card, N in chunks of at most 2**26 energies."""
    n, h, length, _ = q.shape
    step = max(1, 2 ** 26 // (h * length * length))
    return torch.cat([attention._reference(q[i:i + step], k[i:i + step],
                                           v[i:i + step], scale)
                      for i in range(0, n, step)])


@pytest.mark.parametrize("n,h,length,design", ATT_CASES)
def test_attention_designs_match_twin(dev, n, h, length, design):
    """Tolerance 1e-4 * max(1, max|twin|): 3xTF32 (flash) or fp32 (small
    L) sums in another order; the twin on the card, TF32 off."""
    g = torch.Generator(device=dev).manual_seed(length)
    q, k, v = (torch.randn(n, h, length, 16, generator=g, device=dev) * 0.5
               for _ in range(3))
    want = _att_twin(q, k, v, 0.25)
    before = _build.LAUNCHES[f"attention_{design}"]
    got = attention._launch(q, k, v, 0.25, design)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"attention_{design}"] == before + 1
    close([got], [want], 1e-4 * max(1.0, float(want.abs().max())))


def test_attention_takes_its_design_and_refuses_long_small_l(gen, dev):
    """sdp_attention launches the design att_design names (one count in
    `attention` and one in the design's own); small_l refuses L past
    SMALL_L_MAX."""
    for length in (4, 401):
        q, k, v = to_torch(att_inputs(gen, 2, 8, length), device=dev)
        design = attention.att_design(16, length)
        before = dict(_build.LAUNCHES)
        attention.sdp_attention(q, k, v, 0.25)
        got = {key: _build.LAUNCHES[key] - before.get(key, 0)
               for key in ("attention", "attention_flash_tc",
                           "attention_small_l")}
        assert got["attention"] == got[f"attention_{design}"] == 1
        assert sum(got.values()) == 2
    q, k, v = to_torch(att_inputs(gen, 1, 1, attention.SMALL_L_MAX + 1),
                       device=dev)
    with pytest.raises(ValueError, match="small_l"):
        attention._launch(q, k, v, 0.25, "small_l")


# (B, T, Cin, Cm per component, ncomp): the conformer's widths (complex
# Cin 256, Cm 2 x 32; real Cin 128, Cm 32) at each of its eight dilation
# pairs, at 2 x 50 x 4 = 400 rows (six 64-row tiles and a part of one; d =
# 128 > T); then narrow widths (Cin 8: a part-empty output pass; Cm 2 a
# component and 12: padded a tap) and a T = 1 block
BLOCK_SHAPES = [(2, 50, 128 * ncomp, 32, ncomp, 2 ** i, 2 ** (7 - i))
                for ncomp in (2, 1) for i in range(8)] + [
    (2, 9, 8, 2, 2, 1, 8), (3, 7, 40, 12, 1, 4, 2), (2, 1, 256, 32, 2, 1, 128)]


@pytest.mark.parametrize("b,t,cin,cm,ncomp,d1,d2", BLOCK_SHAPES)
def test_dsconv_block_shapes_match_twin(gen, dev, b, t, cin, cm, ncomp, d1,
                                        d2):
    """Tolerance 1e-4 * max(1, max|twin|): 3xTF32 sums over up to K = 576
    in another order; the packed weights passed as DSConvCplx/Real pass
    them."""
    params = to_torch(dsconv_params(gen, cin, cm, ncomp))
    (x,) = to_torch((rand(gen, b, t, 4, cin, scale=0.5),))
    want = dsconv._reference(x, params, d1, d2, ncomp)
    pd = tuple(p.to(dev) for p in params)
    packed = dsconv.pack_block_weights(pd, ncomp)
    got = dsconv.dsconv_block(x.to(dev), pd, d1, d2, ncomp, packed=packed)
    torch.cuda.synchronize()
    close([got], [want], 1e-4 * max(1.0, float(want.abs().max())))


def test_dsconv_modules_run_the_kernel_with_their_pack(gen, dev):
    """DSConvCplx / DSConvReal on the card: one block launch a forward,
    the pack made once, the output the CPU module's."""
    from se_tpu_torch.models.uformer import DSConvCplx, DSConvReal

    torch.manual_seed(0)
    for cls, cin in ((DSConvCplx, 256), (DSConvReal, 128)):
        blk = cls(cin // cls.ncomp, 32, 4, 32).eval()
        (x,) = to_torch((rand(gen, 2, 40, 4, cin, scale=0.5),))
        with torch.no_grad():
            for prm in blk.parameters():
                prm.normal_(0.0, 0.1)
            want = blk(x)
            card = blk.to(dev)
            before = _build.LAUNCHES["dsconv"]
            got = card(x.to(dev))
            assert card.weights() is card.weights()
            torch.cuda.synchronize()
        assert _build.LAUNCHES["dsconv"] == before + 1
        close([got], [want], 1e-4 * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("cin,cout,f", [(1, 8, 256), (64, 128, 8)])
def test_encoder_kernel_matches_twin(gen, dev, cin, cout, f):
    params = to_torch(enc_params(gen, cin, cout))
    xc, xm = to_torch((rand(gen, 2, 9, f, 2 * cin), rand(gen, 2, 9, f, cin)))
    _kernel_vs_twin(encoder.encoder_level, (xc, xm, params), dev)


# (B, T, F, Cin, Cout): Uformer's six encoder levels (level 0 takes the
# CUDA cores, 1-5 the tensor cores), then a ragged M at level 3's widths
# (3 x 5 x 8 = 120 positions: two 64-row tiles, the second part empty),
# T = 1 at level 5's widths (4 positions), Cout 40 (padded to 64) and Cin
# 12 / 3 (padded to 32; 3: the 4-byte copies) on the tensor cores.
UFORMER_KERNELS = (1, 8, 16, 32, 64, 128, 128)
ENC_SHAPES = [(2, 7, 256 >> i, UFORMER_KERNELS[i], UFORMER_KERNELS[i + 1])
              for i in range(6)] + [
    (3, 5, 16, 32, 64), (1, 1, 8, 128, 128), (2, 3, 8, 12, 40),
    (2, 3, 6, 3, 5)]


def _enc_scale(want):
    return 1e-4 * max(1.0, max(float(w.abs().max()) for w in want))


@pytest.mark.parametrize("b,t,f,cin,cout", ENC_SHAPES)
def test_encoder_levels_match_twin(gen, dev, b, t, f, cin, cout):
    """Tolerance 1e-4 * max(1, max|twin|): 3xTF32 or fp32 sums over up to
    K = 2560 in another order; the packed weights passed as Uformer passes
    them."""
    params = to_torch(enc_params(gen, cin, cout))
    xc, xm = to_torch((rand(gen, b, t, f, 2 * cin), rand(gen, b, t, f, cin)))
    want = encoder._reference(xc, xm, params)
    pd = tuple(p.to(dev) for p in params)
    packed = None
    if encoder.level_design(cin) == "tc":
        packed = encoder.pack_encoder_weights(pd)
    got = encoder.encoder_level(xc.to(dev), xm.to(dev), pd, packed=packed)
    torch.cuda.synchronize()
    close(got, want, _enc_scale(want))


@pytest.mark.parametrize("design", ["tc", "cuda_core"])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_encoder_levels_0_2_on_either_design(gen, dev, level, design):
    """Levels 0-2 run on either design; chip_smoke.py times both."""
    f, cin, cout = 256 >> level, UFORMER_KERNELS[level], \
        UFORMER_KERNELS[level + 1]
    params = to_torch(enc_params(gen, cin, cout))
    xc, xm = to_torch((rand(gen, 2, 5, f, 2 * cin), rand(gen, 2, 5, f, cin)))
    want = encoder._reference(xc, xm, params)
    got = encoder._launch(xc.to(dev), xm.to(dev),
                          tuple(p.to(dev) for p in params), design)
    torch.cuda.synchronize()
    close(got, want, _enc_scale(want))


@pytest.mark.parametrize("has_bn", [True, False])
def test_decoder_kernel_matches_twin(gen, dev, has_bn):
    params = to_torch(dec_params(gen, 32, 8))
    xc, xm = to_torch((rand(gen, 2, 9, 16, 64), rand(gen, 2, 9, 16, 32)))
    _kernel_vs_twin(lambda a, b, p: decoder.decoder_level(a, b, p, has_bn),
                    (xc, xm, params), dev)


# (B, T, F, Cc, Cout): Uformer's six decoder levels (levels 0-4 take the
# tensor cores, 5 the CUDA cores), then a ragged M at level 3's widths
# (120 positions: two 64-row tiles, the second part empty), T = 1 and F = 4
# at level 0's widths (4 positions), Cout 20 (padded to 32) and Cin 24 and
# 12 (padded to 32) on the tensor cores, and a narrow level on the CUDA
# cores.
DEC_SHAPES = [(2, 7, 4 << i, 2 * UFORMER_KERNELS[6 - i],
               UFORMER_KERNELS[5 - i]) for i in range(6)] + [
    (3, 5, 8, 64, 16), (1, 1, 4, 256, 128), (2, 3, 4, 12, 20),
    (1, 3, 4, 6, 3)]


@pytest.mark.parametrize("has_bn", [True, False])
@pytest.mark.parametrize("b,t,f,cc,cout", DEC_SHAPES)
def test_decoder_levels_match_twin(gen, dev, b, t, f, cc, cout, has_bn):
    """Tolerance 1e-4 * max(1, max|twin|): 3xTF32 or fp32 sums over up to
    K = 3072 in another order; the packed weights passed as Uformer passes
    them."""
    params = to_torch(dec_params(gen, cc, cout))
    xc, xm = to_torch((rand(gen, b, t, f, 2 * cc), rand(gen, b, t, f, cc)))
    want = decoder._reference(xc, xm, params, has_bn)
    pd = tuple(p.to(dev) for p in params)
    packed = None
    if decoder.level_design(cc, cout) == "tc":
        packed = decoder.pack_decoder_weights(pd)
    got = decoder.decoder_level(xc.to(dev), xm.to(dev), pd, has_bn,
                                packed=packed)
    torch.cuda.synchronize()
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    close(got, want, 1e-4 * scale)


@pytest.mark.parametrize("design", ["tc", "cuda_core"])
@pytest.mark.parametrize("level", [4, 5])
def test_decoder_levels_4_5_on_either_design(gen, dev, level, design):
    """Levels 4 (Cc 32, Cout 8) and 5 (Cc 16, Cout 1) run on either
    design; chip_smoke.py times both."""
    f, cc = 4 << level, 2 * UFORMER_KERNELS[6 - level]
    params = to_torch(dec_params(gen, cc, UFORMER_KERNELS[5 - level]))
    xc, xm = to_torch((rand(gen, 2, 5, f, 2 * cc), rand(gen, 2, 5, f, cc)))
    want = decoder._reference(xc, xm, params, True)
    got = decoder._launch(xc.to(dev), xm.to(dev),
                          tuple(p.to(dev) for p in params), True, design)
    torch.cuda.synchronize()
    close(got, want, 1e-4 * max(1.0, max(float(w.abs().max())
                                          for w in want)))


@pytest.mark.parametrize("c,cm,d1,d2", [(128, 32, 1, 128), (128, 32, 16, 8),
                                        (64, 4, 2, 1)])
def test_dsconv_pair_kernel_matches_twin(gen, dev, c, cm, d1, d2):
    """The conformer's widths (complex 2 x 128 channels, real 128, Cm 32),
    and a narrow Cm whose outputs do not fit in the tap buffer."""
    xc, xm, pc, pm = pair_inputs(gen, 2, 50, 4, c, cm)
    pc, pm = to_torch(pc), to_torch(pm)
    _kernel_vs_twin(lambda a, b, p, q: dsconv.dsconv_pair_block(a, b, p, q,
                                                                d1, d2),
                    (*to_torch((xc, xm)), pc, pm), dev)


# (B, T, C, Cm, d1, d2): the conformer's widths (complex 2 x 128 channels,
# Cm 2 x 32; real 128, Cm 32) at every dilation pair of its eight stages
# (d = 128 at T = 50: taps past both ends), at a ragged row count (3 x 7 x
# 4 = 84 rows: two 64-row tiles, the second part empty) and T = 1; then
# narrow C and Cm (C 40: a part-empty 32-channel output pass; Cm 4 and 12:
# padded to 32 a tap).
PAIR_SHAPES = [(2, 50, 128, 32, 2 ** i, 2 ** (7 - i)) for i in range(8)] + [
    (3, 7, 128, 32, 4, 32), (2, 1, 128, 32, 1, 128), (2, 9, 40, 4, 2, 1),
    (1, 11, 64, 12, 8, 2)]


@pytest.mark.parametrize("b,t,c,cm,d1,d2", PAIR_SHAPES)
def test_dsconv_pair_stages_match_twin(gen, dev, b, t, c, cm, d1, d2):
    """Tolerance 1e-4 * max(1, max|twin|): 3xTF32 sums over up to K = 576
    in another order; the packed weights passed as Uformer passes them."""
    xc, xm, pc, pm = pair_inputs(gen, b, t, 4, c, cm)
    xc, xm = to_torch((xc, xm))
    pc, pm = to_torch(pc), to_torch(pm)
    want = dsconv._pair_reference(xc, xm, pc, pm, d1, d2)
    pcd, pmd = (tuple(p.to(dev) for p in q) for q in (pc, pm))
    packed = dsconv.pack_pair_weights(pcd, pmd)
    got = dsconv.dsconv_pair_block(xc.to(dev), xm.to(dev), pcd, pmd, d1, d2,
                                   packed=packed)
    torch.cuda.synchronize()
    close(got, want, 1e-4 * max(1.0, max(float(w.abs().max())
                                          for w in want)))


# (Bf, In, H) on 132 SMs. The small fold (the projection kernel, then the
# persistent recurrence): the full band (Bf = B = 4), DCCRN's complex LSTM
# (re and im stacked: Bf = 2B), CRN's LSTM(1024) at B = 4 and 32 (one block
# an SM, two row chunks at 32), a Bf of 319 just below the tensor-core
# threshold (5 x 24 blocks), DPCRN's intra LSTM at B = 4 (Bf = 1604: many
# row chunks a block), H = 20 (4-byte staging) and H = 44 (a zero-filled
# 16-byte chunk). The tensor-core step (one launch a frame): a ragged sub
# band (Bf = 1030, 17 x 24 blocks), a ragged Bf just above the threshold
# (321: 6 x 24 blocks, one row in the last tile), H = 40 (not a multiple of
# the 16-unit tile) at a ragged Bf of 2900, DPCRN's intra LSTM at B = 32
# (Bf = 401 * 32, H = 64), In = 33 (4-byte copies), and LSTMNet's two
# layers at B = 256 (In = 161: 4-byte copies, K = 1185; then K = 2048).
# T_LONG frames, so the small-fold shapes take the small fold (shorter
# sequences take the tensor-core step whatever the fold).
T_LONG = lstm.SHORT_T + 3
LSTM_SHAPES = [(4, 257, 512), (1030, 32, 384), (8, 512, 128),
               (4, 1024, 1024), (321, 32, 384), (319, 32, 384),
               (2900, 32, 40), (12832, 128, 64), (1030, 33, 384),
               (256, 161, 1024), (256, 1024, 1024), (32, 1024, 1024),
               (1604, 128, 64), (30, 12, 20), (19, 33, 44)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bf,in_dim,h", LSTM_SHAPES)
def test_lstm_kernel_matches_twin(gen, dev, reverse, bf, in_dim, h):
    x, wx, wh, b = lstm_inputs(gen, bf, T_LONG, in_dim, h)
    wx, wh = wx * (in_dim + h) ** -0.5 * 5, wh * (in_dim + h) ** -0.5 * 5
    _kernel_vs_twin(lambda *a: _flat(lstm.lstm_layer_kernel(*a, reverse)),
                    to_torch((x, wx, wh, b)), dev)


@pytest.mark.parametrize("bf,in_dim,h", LSTM_SHAPES)
def test_lstm_kernel_carry_matches_twin(gen, dev, bf, in_dim, h):
    """Non-zero h0/c0 in, (h_T, c_T) out."""
    x, wx, wh, b = lstm_inputs(gen, bf, T_LONG, in_dim, h)
    wx, wh = wx * (in_dim + h) ** -0.5 * 5, wh * (in_dim + h) ** -0.5 * 5
    h0, c0 = rand(gen, bf, h, scale=0.5), rand(gen, bf, h, scale=0.5)
    args = to_torch((x, wx, wh, b))
    _kernel_vs_twin(lambda x, wx, wh, b, h0, c0: _flat(
        lstm.lstm_layer_kernel(x, wx, wh, b, False, h0, c0)),
        (*args, *to_torch((h0, c0))), dev)


def _flat(out):
    ys, (h, c) = out
    return ys, h, c


@pytest.mark.parametrize("bf,t,in_dim,h", [(8, 12, 512, 128), (37, 5, 161, 20),
                                           (3, 70, 33, 44)])
def test_lstm_project_kernel_matches_twin(gen, dev, bf, t, in_dim, h):
    """Bf T = 96, 185 and 210 rows: ragged 64-row tiles; In = 161 and 33:
    4-byte copies; 4H = 80 and 176: ragged 64-column tiles."""
    x, wx, _, b = lstm_inputs(gen, bf, t, in_dim, h)
    _kernel_vs_twin(lstm.lstm_project, to_torch((x, wx, b)), dev)


@pytest.mark.parametrize("reverse,carry", [(False, False), (True, False),
                                           (False, True)])
@pytest.mark.parametrize("bf,h", [(8, 128), (4, 1024), (1604, 64), (30, 20)])
def test_lstm_recur_kernel_matches_twin(gen, dev, reverse, carry, bf, h):
    xp = rand(gen, bf, 9, 4 * h)
    wh = rand(gen, h, 4 * h, scale=0.2) * h ** -0.5 * 5
    h0 = c0 = None
    if carry:
        h0, c0 = to_torch((rand(gen, bf, h, scale=0.5),
                           rand(gen, bf, h, scale=0.5)))
    _kernel_vs_twin(lambda xp, wh, h0, c0: _flat(lstm.lstm_recur(
        xp, wh, reverse, h0, c0)), (*to_torch((xp, wh)), h0, c0), dev)


@pytest.mark.parametrize("bf,t,small", [(8, lstm.SHORT_T, True),
                                         (8, lstm.SHORT_T - 1, False),
                                         (1604, 4, False),
                                         (1030, lstm.SHORT_T, False)])
def test_lstm_layer_takes_the_design_of_its_shape(gen, dev, bf, t, small):
    """A small fold over SHORT_T frames or more launches the projection and
    the recurrence once each and no tensor-core step; a shorter sequence
    (DPCRN's intra LSTM at B = 4: Bf 1604, T = 4) or a large fold launches
    the tensor-core step alone. Each wrapper counts only its own launch."""
    x, wx, wh, b = (a.to(dev) for a in
                    to_torch(lstm_inputs(gen, bf, t, 32, 384)))
    before = dict(_build.LAUNCHES)
    lstm.lstm_layer_kernel(x, wx, wh, b)
    got = {k: _build.LAUNCHES[k] - before.get(k, 0)
           for k in ("lstm", "lstm_project", "lstm_recur")}
    assert got == {"lstm": int(not small), "lstm_project": int(small),
                   "lstm_recur": int(small)}


# (H, Bf) of the small-fold layer calls of the seven paths at B = 4, 32
# and 256 (tests/test_torch_lstm_tc.py VARIANTS), and the edges H = 20, 44,
# 1056
RECUR_PLANS = [(512, 4), (512, 32), (512, 256), (128, 8), (128, 64),
               (128, 512), (1024, 4), (1024, 32), (128, 16), (128, 128),
               (128, 1024), (20, 30), (44, 19), (1056, 4)]


@pytest.mark.parametrize("h,bf", RECUR_PLANS)
def test_persistent_plan_is_the_kernels(dev, h, bf):
    """ops/lstm.py's plan of the recurrence (`persistent_smem`,
    PERSIST_BLOCKS_SM) agrees with csrc/lstm.cu: the same shared memory a
    block, and the occupancy API lets the planned blocks share an SM."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = lstm.persistent_plan(bf, h, sms)
    assert plan is not None
    smem, per_sm = lstm.recur_fit(h, plan.chunks, dev)
    assert smem == plan.smem
    assert per_sm >= plan.blocks_sm


def test_wrappers_refuse_other_dtypes_and_layouts(gen, dev):
    q, k, v = (t.to(dev) for t in to_torch(att_inputs(gen, 1, 1, 8)))
    with pytest.raises(TypeError):
        attention.sdp_attention(q.double(), k.double(), v.double(), 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        attention.sdp_attention(q.transpose(2, 3).contiguous()
                                .transpose(2, 3), k, v, 0.25)
    x, wx, wh, b = (t.to(dev) for t in to_torch(lstm_inputs(gen, 2, 3, 4, 5)))
    with pytest.raises(TypeError):
        lstm.lstm_layer_kernel(x.double(), wx, wh, b)
    with pytest.raises(ValueError, match="shape"):
        lstm.lstm_layer_kernel(x, wx, wh, b, h0=torch.zeros(3, 5, device=dev))


STFT_CFGS = {
    "512_128": plain_stft.PRESET_512_128,
    "512_256": plain_stft.PRESET_512_256,
    "320": plain_stft.PRESET_320,
    "pad_end": plain_stft.StftConfig(512, 256, 512, window="hamming",
                                     convention="pad_end"),
    "valid": plain_stft.StftConfig(400, 100, 512, convention="valid"),
    # hop and frame not multiples of 4: the kernel's scalar-load variant
    "valid_hop134": plain_stft.StftConfig(402, 134, 512, convention="valid"),
    # n/2 = 200: radices 4, 2, 5, 5; n = 1024 in the default shared memory
    "400_100": plain_stft.StftConfig(400, 100, 400),
    "1024_256": plain_stft.StftConfig(1024, 256, 1024),
    # generic stages: n/2 = 192 = 4^3 x 3, 129 = 3 x 43; odd n = 321 = 3 x
    # 107, no real split
    "384_128": plain_stft.StftConfig(384, 128, 384),
    "258_129": plain_stft.StftConfig(258, 129, 258),
    "odd_321_107": plain_stft.StftConfig(321, 107, 321),
    # past the default 48 KB: 4 frames a block in 64 KB, then 3 in 192 KB
    "2048_512": plain_stft.StftConfig(2048, 512, 2048),
    "8192_2048": plain_stft.StftConfig(8192, 2048, 8192),
}


@pytest.mark.parametrize("n", [16000, 4321])
@pytest.mark.parametrize("name", sorted(STFT_CFGS))
def test_stft_kernel_matches_twin(gen, dev, name, n):
    """Tolerance 1e-4 * max(1, max|twin|): K-long fp32 sums in another
    order on spectra of O(10)."""
    cfg = STFT_CFGS[name]
    (x,) = to_torch((rand(gen, 3, n),))
    want = stft_fused._reference(x, cfg)
    got = stft_fused.stft_fused(x.to(dev), cfg)
    torch.cuda.synchronize()
    assert all(g.device.type == "cuda" for g in got)
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    close(got, want, 1e-4 * scale)


@pytest.mark.parametrize("name", ["512_128", "512_256", "320"])
def test_stft_kernel_matches_twin_at_b256(gen, dev, name):
    """B = 256 x 4 s, the throughput phase's batch; the twin on the card
    (TF32 off)."""
    cfg = STFT_CFGS[name]
    x = torch.from_numpy(rand(gen, 256, 64000, scale=0.1)).to(dev)
    want = stft_fused._reference(x, cfg)
    got = stft_fused.stft_fused(x, cfg)
    torch.cuda.synchronize()
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    close(got, want, 1e-4 * scale)


def test_stft_auto_takes_the_kernel_on_the_card(gen, dev):
    (x,) = to_torch((rand(gen, 2, 8000),), device=dev)
    before = dict(_build.LAUNCHES)
    stft_fused.stft_auto(x, plain_stft.PRESET_320)
    stft_fused.stft_auto(x, plain_stft.PRESET_UFORMER)  # 512 % 160 != 0
    stft_fused.stft_auto(x, STFT_CFGS["384_128"])  # a generic radix-3 stage
    launched = _build.LAUNCHES["stft"] - before.get("stft", 0)
    assert launched == 2


# ------------------------------------------------ gradients (the Functions)

def _grads_vs_twin(wrapper, twin, args, dev, kernel):
    """`wrapper` on CUDA leaves of `args` (a nest of tuples of CPU tensors)
    that require grad, against `twin`'s own autograd on the same CUDA
    values, with the same upstream gradients on the wrapper's
    differentiable outputs: every input gradient within 1e-4 * max(1,
    max|twin grad|) (the kernel's forward is the twin's to that, and both
    backwards are the twin's VJP); those outputs have a grad_fn, and the
    forward launches `kernel` once."""
    def leaves(nest):
        if isinstance(nest, tuple):
            return tuple(leaves(a) for a in nest)
        if isinstance(nest, torch.Tensor):
            return nest.to(dev).requires_grad_()
        return nest

    def flat(nest):
        if isinstance(nest, tuple):
            return [t for a in nest for t in flat(a)]
        return [nest] if isinstance(nest, torch.Tensor) else []

    runs = []
    for fn in (wrapper, twin):
        ins = leaves(args)
        before = _build.LAUNCHES[kernel]
        outs = flat(fn(*ins))
        runs.append((flat(ins), outs, _build.LAUNCHES[kernel] - before))
    (ins_k, outs_k, launched), (ins_t, outs_t, _) = runs
    diff = [i for i, o in enumerate(outs_k) if o.requires_grad]
    assert diff and launched == 1
    assert all(outs_k[i].grad_fn is not None for i in diff)
    cpu = torch.Generator().manual_seed(0)
    gs = [torch.randn(outs_k[i].shape, generator=cpu).to(dev) for i in diff]
    got = torch.autograd.grad([outs_k[i] for i in diff], ins_k, gs,
                              allow_unused=True)
    want = torch.autograd.grad([outs_t[i] for i in diff], ins_t, gs,
                               allow_unused=True)
    torch.cuda.synchronize()
    for a, w in zip(got, want):  # None: an input the level leaves unused
        assert (a is None) == (w is None)
        if w is not None:
            close([a], [w], 1e-4 * max(1.0, float(w.abs().max())))


@pytest.mark.parametrize("n,h,length", [(3, 8, 4), (3, 8, 65), (16, 1, 401)])
def test_attention_function_grads_match_twin(gen, dev, n, h, length):
    """Both designs (L <= 32: att_small_l; past it: att_flash_tc)."""
    _grads_vs_twin(lambda q, k, v: attention.sdp_attention(q, k, v, 0.25),
                   lambda q, k, v: attention._reference(q, k, v, 0.25),
                   to_torch(att_inputs(gen, n, h, length)), dev, "attention")


# (Bf, T, In, H): the small fold (T_LONG frames, a ragged Bf) and the
# tensor-core step (T = 4, DPCRN's intra LSTM, a ragged Bf)
LSTM_GRAD_SHAPES = [(5, T_LONG, 12, 20), (37, 4, 33, 16)]


@pytest.mark.parametrize("reverse,carry", [(False, False), (True, False),
                                           (False, True)])
@pytest.mark.parametrize("bf,t,in_dim,h", LSTM_GRAD_SHAPES)
def test_lstm_function_grads_match_twin(gen, dev, bf, t, in_dim, h, reverse,
                                        carry):
    """The layer's backward (the chunked twin's VJP) against the plain
    twin's autograd; gradients reach the carry through ys."""
    x, wx, wh, b = lstm_inputs(gen, bf, t, in_dim, h)
    h0 = c0 = None
    if carry:
        h0, c0 = to_torch((rand(gen, bf, h, scale=0.5),
                           rand(gen, bf, h, scale=0.5)))
    kernel = "lstm_recur" if t >= lstm.SHORT_T else "lstm"
    _grads_vs_twin(
        lambda *a: lstm.lstm_layer_kernel(*a[:4], reverse, *a[4:]),
        lambda *a: lstm._reference(*a[:4], reverse, *a[4:]),
        (*to_torch((x, wx, wh, b)), h0, c0), dev, kernel)


@pytest.mark.parametrize("cin,cout,f", [(1, 8, 32), (16, 32, 8)])
def test_encoder_function_grads_match_twin(gen, dev, cin, cout, f):
    """Level 0's CUDA-core design and a tensor-core level."""
    params = to_torch(enc_params(gen, cin, cout))
    xc, xm = to_torch((rand(gen, 2, 5, f, 2 * cin), rand(gen, 2, 5, f, cin)))
    _grads_vs_twin(encoder.encoder_level, encoder._reference,
                   (xc, xm, params), dev, "encoder")


@pytest.mark.parametrize("cc,cout,has_bn", [(32, 8, True), (16, 1, False)])
def test_decoder_function_grads_match_twin(gen, dev, cc, cout, has_bn):
    """A tensor-core level and the last level's CUDA-core design."""
    params = to_torch(dec_params(gen, cc, cout))
    xc, xm = to_torch((rand(gen, 2, 5, 8, 2 * cc), rand(gen, 2, 5, 8, cc)))
    _grads_vs_twin(lambda a, b, p: decoder.decoder_level(a, b, p, has_bn),
                   lambda a, b, p: decoder._reference(a, b, p, has_bn),
                   (xc, xm, params), dev, "decoder")


@pytest.mark.parametrize("ncomp", [1, 2])
def test_dsconv_block_function_grads_match_twin(gen, dev, ncomp):
    cin = 32 * ncomp
    params = to_torch(dsconv_params(gen, cin, 16, ncomp))
    (x,) = to_torch((rand(gen, 2, 12, 4, cin, scale=0.5),))
    _grads_vs_twin(lambda x, p: dsconv.dsconv_block(x, p, 2, 4, ncomp),
                   lambda x, p: dsconv._reference(x, p, 2, 4, ncomp),
                   (x, params), dev, "dsconv")


def test_dsconv_pair_function_grads_match_twin(gen, dev):
    xc, xm, pc, pm = pair_inputs(gen, 2, 12, 4, 32, 16)
    _grads_vs_twin(
        lambda *a: dsconv.dsconv_pair_block(*a, 4, 2),
        lambda *a: dsconv._pair_reference(*a, 4, 2),
        (*to_torch((xc, xm)), to_torch(pc), to_torch(pm)), dev,
        "dsconv_pair")


def test_stft_kernel_refuses_an_input_that_requires_grad(gen, dev):
    (x,) = to_torch((rand(gen, 2, 8000),), device=dev)
    with pytest.raises(ValueError, match="no gradient"):
        stft_fused.stft_fused(x.requires_grad_(), plain_stft.PRESET_320)


# DeepXi at narrow widths: ResNetV2 (torch ops around the STFT kernel) and
# ResLSTM (its layers on the LSTM kernels: small folds at B = 2)
DEEPXI_KWARGS = {"ResNetV2": (("d_model", 64), ("n_blocks", 4), ("d_f", 16)),
                 "ResLSTM": (("d_model", 64), ("n_blocks", 2))}


def _deepxi_pair(network, dev):
    """(the CPU's driver, the card's) with the same weights and a map
    fitted once on the CPU."""
    from se_tpu_torch.models.deepxi_driver import DeepXiDriver

    cpu = DeepXiDriver(network=network, network_kwargs=DEEPXI_KWARGS[network],
                       device="cpu")
    rng = np.random.default_rng(4)
    clean = rand(rng, 2, 16000, scale=0.1)
    cpu.sample_stats(list(clean), list(rand(rng, 2, 16000, scale=0.05)),
                     save=False)
    card = DeepXiDriver(network=network,
                        network_kwargs=DEEPXI_KWARGS[network], device=dev)
    card.model.load_state_dict(cpu.model.state_dict())
    card.xi_map.mu, card.xi_map.sigma = cpu.xi_map.mu, cpu.xi_map.sigma
    return cpu, card


@pytest.mark.parametrize("network", ["ResNetV2", "ResLSTM"])
def test_deepxi_enhance_on_the_card_matches_the_cpu(gen, dev, network):
    """`models.deepxi.enhance` on the card: the STFT kernel once, each
    ResLSTM layer on the LSTM kernels; within 1e-4 * max|cpu|."""
    from se_tpu_torch.models.deepxi import enhance

    cpu, card = _deepxi_pair(network, dev)
    wav = rand(gen, 2, 16000, scale=0.1)
    before = dict(_build.LAUNCHES)
    got = enhance(card.model, wav, card.xi_map, length=16000)
    launched = {k: _build.LAUNCHES[k] - before.get(k, 0)
                for k in ("stft", "lstm", "lstm_project", "lstm_recur")}
    layers = 2 if network == "ResLSTM" else 0
    assert launched["stft"] == 1
    assert launched["lstm"] + launched["lstm_recur"] == layers
    want = enhance(cpu.model, wav, cpu.xi_map, length=16000)
    assert got.device.type == "cuda" and got.shape == (2, 16000)
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("network", ["ResNetV2", "ResLSTM"])
def test_deepxi_train_step_on_the_card_matches_the_cpu(gen, dev, network):
    """One `DeepXiDriver.train_step` at B = 2 x 1 s on each side: the loss
    within 1e-4 relative, each gradient within 1e-3 of its tensor's largest
    entry plus 1e-6 of the step's largest (chip_smoke.py phase 7b's)."""
    from se_tpu_torch.train.trainer import adam_state

    drivers = _deepxi_pair(network, dev)
    clean = rand(gen, 2, 16000, scale=0.1)
    noisy = clean + rand(gen, 2, 16000, scale=0.1)
    out = []
    for drv in drivers:
        s, x, frames = drv._batch(clean, noisy)
        opt = adam_state(dict(drv.model.named_parameters()))
        loss = drv.train_step(s, x, frames, opt).item()
        out.append((loss, {k: p.grad.cpu() for k, p in
                           drv.model.named_parameters()}))
    (loss_cpu, g_cpu), (loss_card, g_card) = out
    assert abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu)
    floor = 1e-6 * max(float(g.abs().max()) for g in g_cpu.values())
    for k, g in g_cpu.items():
        tol = 1e-3 * float(g.abs().max()) + floor
        assert float((g_card[k] - g).abs().max()) <= tol, k


# ------------------------------------------------ bf16 variants

BF16 = torch.bfloat16


def _bf16_counts(before, names):
    return {n: _build.LAUNCHES[n] - before.get(n, 0) for n in names}


# the flash kernel at L = 401 (the T-attention at B = 4 and 32), 65, 1,
# 512 and at a long utterance's 588 and 1100 (two sweeps over K at every
# L), the short-L kernel and the flash kernel at the F-attention's L = 4
@pytest.mark.parametrize("n,h,length,design", [
    (16, 1, 401, "flash_tc"), (16, 8, 401, "flash_tc"),
    (128, 8, 401, "flash_tc"), (16, 1, 65, "flash_tc"),
    (16, 1, 1, "flash_tc"), (12, 1, 512, "flash_tc"),
    (16, 8, 588, "flash_tc"), (3, 1, 588, "flash_tc"),
    (2, 8, 1100, "flash_tc"),
    (1604, 8, 4, "small_l"), (1604, 8, 4, "flash_tc"),
    (200, 1, 32, "small_l")])
def test_attention_bf16_designs_match_twin(dev, n, h, length, design):
    """bf16 q, k, v: each design's bf16 kernel against the bf16 twin on
    the card (`bf16_close` with P's flip slack, tests/
    test_torch_bf16_kernels.py); counted as attention_bf16, not as the
    fp32 kernel."""
    g = torch.Generator(device=dev).manual_seed(length)
    q, k, v = ((torch.randn(n, h, length, 16, generator=g, device=dev) * 0.5)
               .to(BF16) for _ in range(3))
    want = _att_twin(q, k, v, 0.25)
    before = dict(_build.LAUNCHES)
    got = attention._launch(q, k, v, 0.25, design)
    torch.cuda.synchronize()
    assert got.dtype == BF16
    assert _bf16_counts(before, ("attention", "attention_bf16",
                                 f"attention_{design}_bf16")) == {
        "attention": 0, "attention_bf16": 1, f"attention_{design}_bf16": 1}
    bf16_close([got], [want], [att_flip_slack(q, k, v, 0.25)])


def test_attention_bf16_takes_its_design_by_length(dev):
    """sdp_attention in bf16 launches the design att_design names by L:
    the short-L kernel, then the flash kernel."""
    for length in (4, 401, 588):
        g = torch.Generator(device=dev).manual_seed(length)
        q, k, v = ((torch.randn(4, 2, length, 16, generator=g, device=dev)
                    * 0.5).to(BF16) for _ in range(3))
        design = attention.att_design(8, length)
        before = dict(_build.LAUNCHES)
        got = attention.sdp_attention(q, k, v, 0.25)
        torch.cuda.synchronize()
        names = ["attention", "attention_bf16"] + [
            f"attention_{d}_bf16" for d in attention.DESIGNS]
        counts = _bf16_counts(before, names)
        assert counts == {n: int(n in ("attention_bf16",
                                       f"attention_{design}_bf16"))
                          for n in names}
        bf16_close([got], [_att_twin(q, k, v, 0.25)],
                   [att_flip_slack(q, k, v, 0.25)])


@pytest.mark.parametrize("b,t,f,cin,cout", ENC_SHAPES)
def test_encoder_bf16_levels_match_twin(gen, dev, b, t, f, cin, cout):
    """Each shape on the design `level_design` gives it in bf16
    (encoder_level_tc_bf16 where Cin % 8 == 0; Cin 12 the widened route,
    Cin 1 and 3 the CUDA cores), the narrow ones also on the CUDA cores and
    any Cin % 4 == 0 also on the widened route."""
    params = to_bf16(enc_params(gen, cin, cout), device=dev)
    xc, xm = to_bf16((rand(gen, b, t, f, 2 * cin), rand(gen, b, t, f, cin)),
                     device=dev)
    want = encoder._reference(xc, xm, params)
    designs = {encoder.level_design(cin, BF16)}
    designs |= {"cuda_core"} if cin <= 16 else set()
    designs |= {"tc_widened"} if cin % 4 == 0 else set()
    for design in sorted(designs):
        before = dict(_build.LAUNCHES)
        got = encoder._launch(xc, xm, params, design)
        torch.cuda.synchronize()
        assert _bf16_counts(before, ("encoder", "encoder_bf16",
                                     "encoder_bf16_widened")) == {
            "encoder": 0, "encoder_bf16": 1,
            "encoder_bf16_widened": int(design == "tc_widened")}
        bf16_close(got, want)


@pytest.mark.parametrize("level", range(6))
def test_encoder_bf16_ragged_levels_match_twin(gen, dev, level):
    """Uformer's six encoder levels at B = 3, T = 7 (21 x 2^(7 - level)
    positions: the last 64-position tile part empty at levels 2-5), each on
    the design `level_design` gives it (encoder_level_tc_bf16 at 1-5), the
    packs bf16, passed as Uformer passes them."""
    f, cin, cout = 256 >> level, UFORMER_KERNELS[level], \
        UFORMER_KERNELS[level + 1]
    params = to_bf16(enc_params(gen, cin, cout), device=dev)
    xc, xm = to_bf16((rand(gen, 3, 7, f, 2 * cin), rand(gen, 3, 7, f, cin)),
                     device=dev)
    want = encoder._reference(xc, xm, params)
    design = encoder.level_design(cin, BF16)
    assert design == ("cuda_core" if level == 0 else "tc")
    packed = encoder.pack_encoder_weights(params) if design == "tc" \
        else None
    assert packed is None or all(p.dtype == BF16 for p in packed)
    before = dict(_build.LAUNCHES)
    got = encoder.encoder_level(xc, xm, params, packed=packed)
    torch.cuda.synchronize()
    assert _bf16_counts(before, ("encoder", "encoder_bf16",
                                 "encoder_bf16_widened")) == {
        "encoder": 0, "encoder_bf16": 1, "encoder_bf16_widened": 0}
    bf16_close(got, want)


def test_encoder_bf16_tc_refuses_cin_not_a_multiple_of_8(gen, dev):
    """Asked for by name, the bf16 tensor-core design refuses Cin = 12
    before any launch; `level_design` sends it to the widened route."""
    params = to_bf16(enc_params(gen, 12, 16), device=dev)
    xc, xm = to_bf16((rand(gen, 1, 3, 8, 24), rand(gen, 1, 3, 8, 12)),
                     device=dev)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="multiple of 8"):
        encoder._launch(xc, xm, params, "tc")
    assert _bf16_counts(before, ("encoder_bf16",)) == {"encoder_bf16": 0}


@pytest.mark.parametrize("has_bn", [True, False])
@pytest.mark.parametrize("level", range(6))
def test_decoder_bf16_levels_match_twin(gen, dev, level, has_bn):
    """Uformer's six decoder levels at B = 2, T = 5, each on the design
    `level_design` gives it."""
    f, cc, cout = 4 << level, 2 * UFORMER_KERNELS[6 - level], \
        UFORMER_KERNELS[5 - level]
    params = to_bf16(dec_params(gen, cc, cout), device=dev)
    xc, xm = to_bf16((rand(gen, 2, 5, f, 2 * cc), rand(gen, 2, 5, f, cc)),
                     device=dev)
    want = decoder._reference(xc, xm, params, has_bn)
    before = dict(_build.LAUNCHES)
    got = decoder.decoder_level(xc, xm, params, has_bn)
    torch.cuda.synchronize()
    assert _bf16_counts(before, ("decoder", "decoder_bf16")) == {
        "decoder": 0, "decoder_bf16": 1}
    bf16_close(got, want)


@pytest.mark.parametrize("has_bn", [True, False])
@pytest.mark.parametrize("level", range(5))
def test_decoder_bf16_ragged_levels_match_twin(gen, dev, level, has_bn):
    """Levels 0-4 (the bf16 tensor-core design) at B = 3, T = 7: 84 x 2^i
    positions, the last 64-position tile part empty at levels 0-3."""
    f, cc, cout = 4 << level, 2 * UFORMER_KERNELS[6 - level], \
        UFORMER_KERNELS[5 - level]
    params = to_bf16(dec_params(gen, cc, cout), device=dev)
    xc, xm = to_bf16((rand(gen, 3, 7, f, 2 * cc), rand(gen, 3, 7, f, cc)),
                     device=dev)
    want = decoder._reference(xc, xm, params, has_bn)
    packed = decoder.pack_decoder_weights(params)
    assert all(p.dtype == BF16 for p in packed)
    got = decoder.decoder_level(xc, xm, params, has_bn, packed=packed)
    torch.cuda.synchronize()
    bf16_close(got, want)


def test_decoder_bf16_widened_route_matches_twin(gen, dev):
    """Cc = 12, which the bf16 tensor-core design cannot copy 8 channels
    at a time: `level_design` picks the widened route (the fp32 kernel on
    widened inputs, rounded once), within the bf16 rule of the bf16 twin,
    from the caller's fp32 pack of the bf16 weights and without one; the
    caller's bf16 pack is refused, not widened a call; fp32 runs it as
    before."""
    params = dec_params(gen, 12, 16)
    xc, xm = rand(gen, 1, 3, 4, 24), rand(gen, 1, 3, 4, 12)
    assert decoder.level_design(12, 16) == "tc"
    assert decoder.level_design(12, 16, BF16) == "tc_widened"
    p16 = to_bf16(params, device=dev)
    x16 = to_bf16((xc, xm), device=dev)
    want = decoder._reference(*x16, p16, True)
    for packed in (None, decoder.pack_decoder_weights(p16, torch.float32)):
        before = dict(_build.LAUNCHES)
        got = decoder.decoder_level(*x16, p16, True, packed=packed)
        torch.cuda.synchronize()
        assert _bf16_counts(before, ("decoder", "decoder_bf16",
                                     "decoder_bf16_widened")) == {
            "decoder": 0, "decoder_bf16": 1, "decoder_bf16_widened": 1}
        assert all(g.dtype == BF16 for g in got)
        bf16_close(got, want)
    with pytest.raises(TypeError, match="packed wc"):
        decoder.decoder_level(*x16, p16, True,
                              packed=decoder.pack_decoder_weights(p16))
    got = decoder.decoder_level(*to_torch((xc, xm), device=dev),
                                to_torch(params, device=dev), True)
    assert all(g.dtype == torch.float32 for g in got)


def test_pair_bf16_widened_route_matches_twin(gen, dev):
    """C 12 (not a multiple of 8) and Cm 4 + 4 a block (not multiples of
    16): `pair_design` picks the widened route, within the bf16 rule of
    the bf16 twin, from the caller's fp32 pack and without one; the fp32
    stage runs them as before."""
    for c, cm in ((12, 16), (64, 4)):
        xc, xm, pc, pm = pair_inputs(gen, 1, 5, 4, c, cm)
        x16 = to_bf16((xc, xm), device=dev)
        p16 = to_bf16(pc, device=dev), to_bf16(pm, device=dev)
        assert dsconv.pair_design(c, 2 * cm, cm, BF16) == "tc_widened"
        want = dsconv._pair_reference(*x16, *p16, 1, 2)
        for packed in (None, dsconv.pack_pair_weights(*p16, torch.float32)):
            before = dict(_build.LAUNCHES)
            got = dsconv.dsconv_pair_block(*x16, *p16, 1, 2, packed=packed)
            torch.cuda.synchronize()
            assert _bf16_counts(before, (
                "dsconv_pair", "dsconv_pair_bf16",
                "dsconv_pair_bf16_widened")) == {
                "dsconv_pair": 0, "dsconv_pair_bf16": 1,
                "dsconv_pair_bf16_widened": 1}
            assert all(g.dtype == BF16 for g in got)
            bf16_close(got, want)
        got = dsconv.dsconv_pair_block(*to_torch((xc, xm), device=dev),
                                       to_torch(pc, device=dev),
                                       to_torch(pm, device=dev), 1, 2)
        assert all(g.dtype == torch.float32 for g in got)


def test_uformer_bf16_packs_are_bf16_and_made_once(dev):
    """Uformer's bf16 copy packs its encoder levels 1-5, its decoder
    levels 0-4 and its DSConv stages from its bf16 weights, in bf16 (the
    vectors fp32), once: the same objects come back; the fp32 model's
    packs stay fp32."""
    from se_tpu_torch.eval.enhance import bf16_model
    from se_tpu_torch.models import get_model

    model = get_model("uformer").make(device=dev)
    twin = bf16_model(get_model("uformer"), model)
    with torch.no_grad():
        assert twin._encoder_weights(0)[1] is None  # level 0: CUDA cores
        for i in range(1, 6):
            _, packed = twin._encoder_weights(i)
            assert all(p.dtype == BF16 for p in packed)
            assert twin._encoder_weights(i)[1] is packed
            assert all(p.dtype == torch.float32
                       for p in model._encoder_weights(i)[1])
        for i in range(5):
            _, packed = twin._decoder_weights(i)
            assert all(p.dtype == BF16 for p in packed)
            assert twin._decoder_weights(i)[1] is packed
            assert all(p.dtype == torch.float32
                       for p in model._decoder_weights(i)[1])
        for k in range(8):
            packed = twin.conformer._stage_weights(k)[2]
            for pk in packed:
                assert [t.dtype for t in pk] == [
                    BF16 if i in (0, 5, 7, 11) else torch.float32
                    for i in range(13)]
            assert twin.conformer._stage_weights(k)[2] is packed
            assert all(t.dtype == torch.float32 for pk in
                       model.conformer._stage_weights(k)[2] for t in pk)


@pytest.mark.parametrize("d1,d2", [(2 ** i, 2 ** (7 - i)) for i in range(8)])
def test_pair_bf16_stage_matches_twin(gen, dev, d1, d2):
    """The conformer's widths at 2 x 50 x 4 rows, every dilation pair of
    its eight stages; the scratch y fp32."""
    xc, xm, pc, pm = pair_inputs(gen, 2, 50, 4, 128, 32)
    xc, xm = to_bf16((xc, xm), device=dev)
    pc, pm = to_bf16(pc, device=dev), to_bf16(pm, device=dev)
    want = dsconv._pair_reference(xc, xm, pc, pm, d1, d2)
    before = dict(_build.LAUNCHES)
    got = dsconv.dsconv_pair_block(xc, xm, pc, pm, d1, d2)
    torch.cuda.synchronize()
    assert _bf16_counts(before, ("dsconv_pair", "dsconv_pair_bf16")) == {
        "dsconv_pair": 0, "dsconv_pair_bf16": 1}
    bf16_close(got, want)


@pytest.mark.parametrize("b,t", [(3, 7), (32, 401)])
def test_pair_bf16_stage_ragged_and_b32_matches_twin(gen, dev, b, t):
    """84 rows (the second 64-row tile part empty), and a stage at B =
    32 x 4 s (51,328 rows), with the packs passed as Uformer passes
    them."""
    xc, xm, pc, pm = pair_inputs(gen, b, t, 4, 128, 32)
    xc, xm = to_bf16((xc, xm), device=dev)
    pc, pm = to_bf16(pc, device=dev), to_bf16(pm, device=dev)
    want = dsconv._pair_reference(xc, xm, pc, pm, 1, 128)
    got = dsconv.dsconv_pair_block(xc, xm, pc, pm, 1, 128,
                                   packed=dsconv.pack_pair_weights(pc, pm))
    torch.cuda.synchronize()
    bf16_close(got, want)


@pytest.mark.parametrize("ncomp,cin,cm", [(2, 256, 32), (1, 128, 32),
                                           (2, 8, 2)])
@pytest.mark.parametrize("d1,d2", [(1, 128), (4, 2)])
def test_block_bf16_matches_twin(gen, dev, ncomp, cin, cm, d1, d2):
    """The single block in bf16 at 2 x 50 x 4 rows (the conformer's widths,
    and Cin 8 with Cm 2 a component: padded tiles); the scratch y fp32."""
    params = to_bf16(dsconv_params(gen, cin, cm, ncomp), device=dev)
    (x,) = to_bf16((rand(gen, 2, 50, 4, cin, scale=0.5),), device=dev)
    want = dsconv._reference(x, params, d1, d2, ncomp)
    before = dict(_build.LAUNCHES)
    got = dsconv.dsconv_block(x, params, d1, d2, ncomp)
    torch.cuda.synchronize()
    assert _bf16_counts(before, ("dsconv", "dsconv_bf16")) == {
        "dsconv": 0, "dsconv_bf16": 1}
    assert got.dtype == BF16
    bf16_close([got], [want])


def _block_bf16_case(gen, dev, b, t, cin, cm, ncomp, d1, d2, packed=False):
    """The bf16 block on b x t x 4 rows against its bf16 twin, and its
    launch counts: dsconv, dsconv_bf16, dsconv_bf16_widened."""
    params = to_bf16(dsconv_params(gen, cin, cm, ncomp), device=dev)
    (x,) = to_bf16((rand(gen, b, t, 4, cin, scale=0.5),), device=dev)
    want = dsconv._reference(x, params, d1, d2, ncomp)
    pk = dsconv.pack_block_weights(params, ncomp) if packed else None
    before = dict(_build.LAUNCHES)
    got = dsconv.dsconv_block(x, params, d1, d2, ncomp, packed=pk)
    torch.cuda.synchronize()
    assert got.dtype == BF16
    bf16_close([got], [want])
    return _bf16_counts(before, ("dsconv", "dsconv_bf16",
                                 "dsconv_bf16_widened"))


TC_BF16 = {"dsconv": 0, "dsconv_bf16": 1, "dsconv_bf16_widened": 0}


@pytest.mark.parametrize("d1,d2", [(2 ** i, 2 ** (7 - i)) for i in range(8)])
@pytest.mark.parametrize("ncomp,cin", [(2, 256), (1, 128)])
def test_block_bf16_tc_matches_twin(gen, dev, ncomp, cin, d1, d2):
    """The bf16 tensor-core block (`block_design` "tc") at the conformer's
    widths, Cin 256 / Cm 64 and Cin 128 / Cm 32, on 2 x 50 x 4 rows, every
    dilation pair of its eight stages."""
    assert dsconv.block_design(cin, 32 * ncomp, BF16) == "tc"
    assert _block_bf16_case(gen, dev, 2, 50, cin, 32, ncomp, d1,
                            d2) == TC_BF16


@pytest.mark.parametrize("b,t", [(3, 7), (32, 401)])
@pytest.mark.parametrize("ncomp,cin", [(2, 256), (1, 128)])
def test_block_bf16_ragged_and_b32_matches_twin(gen, dev, ncomp, cin, b, t):
    """84 rows (the second 64-row tile part empty), and a block at B =
    32 x 4 s (51,328 rows), with the pack passed as DSConvCplx and
    DSConvReal pass theirs."""
    assert _block_bf16_case(gen, dev, b, t, cin, 32, ncomp, 1, 128,
                            packed=True) == TC_BF16


def test_block_bf16_widened_route_matches_twin(gen, dev):
    """Cin 12 (not a multiple of 8) and Cm 8 (not a multiple of 16):
    `block_design` picks the widened route, within the bf16 rule of the
    bf16 twin, from the caller's fp32 pack and without one; the fp32 block
    runs the width as before."""
    assert dsconv.block_design(12, 8, BF16) == "tc_widened"
    widened = {"dsconv": 0, "dsconv_bf16": 1, "dsconv_bf16_widened": 1}
    for packed in (False, True):
        assert _block_bf16_case(gen, dev, 1, 5, 12, 8, 1, 1, 2,
                                packed) == widened
    params = to_bf16(dsconv_params(gen, 12, 8, 1), device=dev)
    assert all(t.dtype == torch.float32
               for t in dsconv.pack_block_weights(params, 1))
    (x,) = to_torch((rand(gen, 1, 5, 4, 12, scale=0.5),), device=dev)
    got = dsconv.dsconv_block(x, to_torch(dsconv_params(gen, 12, 8, 1),
                                          device=dev), 1, 2, 1)
    assert got.dtype == torch.float32


def test_dsconv_modules_bf16_run_the_kernel_with_their_pack(gen, dev):
    """bf16 DSConvCplx / DSConvReal at the conformer's widths on the card:
    their pack made once from the bf16 weights, in bf16 (the vectors
    fp32), one dsconv_bf16 launch a forward and no widened one, the output
    within the bf16 rule of the bf16 twin."""
    from se_tpu_torch.models.uformer import DSConvCplx, DSConvReal

    torch.manual_seed(0)
    for cls, cin in ((DSConvCplx, 256), (DSConvReal, 128)):
        blk = cls(cin // cls.ncomp, 32, 4, 32).eval()
        with torch.no_grad():
            for prm in blk.parameters():
                prm.normal_(0.0, 0.1)
        card = blk.to(dev).to(BF16)
        (x,) = to_bf16((rand(gen, 2, 40, 4, cin, scale=0.5),), device=dev)
        with torch.no_grad():
            params, packed = card.weights()
            assert [t.dtype for t in packed] == [
                BF16 if i in (0, 5, 7, 11) else torch.float32
                for i in range(13)]
            before = dict(_build.LAUNCHES)
            got = card(x)
            torch.cuda.synchronize()
            assert card.weights()[1] is packed
            want = dsconv._reference(x, params, 4, 32, cls.ncomp)
        assert _bf16_counts(before, ("dsconv", "dsconv_bf16",
                                     "dsconv_bf16_widened")) == TC_BF16
        bf16_close([got], [want])


@pytest.mark.parametrize("cfg", [
    plain_stft.PRESET_512_128, plain_stft.PRESET_320,
    plain_stft.StftConfig(512, 256, 512, window="hamming",
                          convention="pad_end"),
    plain_stft.StftConfig(400, 100, 512, convention="valid")],
    ids=["center-512-128", "center-320", "pad_end", "valid"])
@pytest.mark.parametrize("n", [4000, 4001])
def test_stft_bf16_matches_twin(gen, dev, cfg, n):
    """The bf16 basis product (bf16 tensor cores) on a waveform whose
    frames the kernel copies 16 bytes at a time where they lie inside it
    (n = 4000; hop a multiple of 8) and sample by sample (n = 4001, and
    the valid preset's hop 100): fp32 out, sums in another order than the
    twin's matmul, 1e-5 of the largest |twin| (the fp32 kernels' rule on
    O(1) spectra is 1e-4)."""
    (x,) = to_bf16((rand(gen, 3, n, scale=0.1),), device=dev)
    want = stft_fused._reference(x, cfg)
    before = dict(_build.LAUNCHES)
    got = stft_fused.stft_auto(x, cfg)
    torch.cuda.synchronize()
    assert _bf16_counts(before, ("stft", "stft_bf16")) == {
        "stft": 0, "stft_bf16": 1}
    assert all(g.dtype == torch.float32 for g in got)
    close(got, want, 1e-5 * max(float(w.abs().max()) for w in want))


# The bf16 LSTM entries (bf16 weights; x fp32 or bf16; XP, h, c and y
# fp32). Each side rounds its own h to bf16 a frame, so the kernel is held
# to the twin stepped along the kernel's own y (`h_in`: no h rounds to
# another bf16 value on the two sides) at ATOL, and, free-running, within
# bf16_close with one bf16 ulp of the largest output as its floor
# (ops/_dtype.py LSTM_FLOOR).
BF16_LSTM_SHAPES = [(4, 257, 512), (1030, 32, 384), (8, 512, 128),
                    (4, 1024, 1024), (2900, 32, 40), (12832, 128, 64),
                    (1030, 33, 384), (256, 161, 1024), (19, 33, 44),
                    (2900, 161, 44)]


def _bf16_lstm_args(gen, bf, t, in_dim, h, x_dtype, dev):
    x, wx, wh, b = lstm_inputs(gen, bf, t, in_dim, h)
    wx, wh = wx * (in_dim + h) ** -0.5 * 5, wh * (in_dim + h) ** -0.5 * 5
    x, wx, wh, b = to_torch((x, wx, wh, b), device=dev)
    return x.to(x_dtype), wx.to(BF16), wh.to(BF16), b.to(BF16)


def _lstm_bf16_counts(before):
    return _bf16_counts(before, ("lstm", "lstm_project", "lstm_recur",
                                 "lstm_bf16", "lstm_project_bf16",
                                 "lstm_recur_bf16"))


@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bf,in_dim,h", BF16_LSTM_SHAPES)
def test_lstm_bf16_kernel_matches_twin(gen, dev, x_dtype, reverse, bf,
                                       in_dim, h):
    x, wx, wh, b = _bf16_lstm_args(gen, bf, T_LONG, in_dim, h, x_dtype, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    small = lstm.step_variant(bf, T_LONG, h, sms, BF16) == "persistent"
    before = dict(_build.LAUNCHES)
    ys, (hn, cn) = lstm.lstm_layer_kernel(x, wx, wh, b, reverse)
    torch.cuda.synchronize()
    assert ys.dtype == hn.dtype == cn.dtype == torch.float32
    assert _lstm_bf16_counts(before) == {
        "lstm": 0, "lstm_project": 0, "lstm_recur": 0,
        "lstm_bf16": int(not small), "lstm_project_bf16": int(small),
        "lstm_recur_bf16": int(small)}
    stepped = lstm._reference(x, wx, wh, b, reverse, h_in=ys)
    close([ys], [stepped[0]], ATOL)
    free = lstm._reference(x, wx, wh, b, reverse)
    bf16_close([ys, hn, cn], [free[0], *free[1]], floor=LSTM_FLOOR)


@pytest.mark.parametrize("bf,in_dim,h,x_dtype",
                         [(1030, 32, 384, torch.float32),
                          (8, 512, 128, torch.float32),
                          (2900, 161, 44, BF16)])
def test_lstm_bf16_kernel_carry_matches_twin(gen, dev, bf, in_dim, h,
                                             x_dtype):
    x, wx, wh, b = _bf16_lstm_args(gen, bf, T_LONG, in_dim, h, x_dtype,
                                   dev)
    h0, c0 = to_torch((rand(gen, bf, h, scale=0.5),
                       rand(gen, bf, h, scale=0.5)), device=dev)
    ys, (hn, cn) = lstm.lstm_layer_kernel(x, wx, wh, b, False, h0, c0)
    torch.cuda.synchronize()
    stepped = lstm._reference(x, wx, wh, b, False, h0, c0, h_in=ys)
    close([ys], [stepped[0]], ATOL)
    free = lstm._reference(x, wx, wh, b, False, h0, c0)
    bf16_close([ys, hn, cn], [free[0], *free[1]], floor=LSTM_FLOOR)


# The bf16 step alone (`lstm_step`: the large-fold design at any shape):
# In = 161 (the wrapper's padded copy of x), x at an address off 16 bytes
# (`offset` elements into its storage: copied too), ragged Bf, H not a
# multiple of the 16-unit tile, with and without a carry.
@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("bf,in_dim,h,offset", [(67, 161, 44, 0),
                                                (130, 161, 20, 0),
                                                (70, 32, 40, 1),
                                                (1030, 32, 384, 0)])
def test_lstm_bf16_step_matches_twin(gen, dev, x_dtype, carry, bf, in_dim,
                                     h, offset):
    x, wx, wh, b = _bf16_lstm_args(gen, bf, T_LONG, in_dim, h, x_dtype, dev)
    if offset:
        store = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
        x = store[offset:].view(x.shape).copy_(x)
        assert x.data_ptr() % 16 != 0
    h0 = c0 = None
    if carry:
        h0, c0 = to_torch((rand(gen, bf, h, scale=0.5),
                           rand(gen, bf, h, scale=0.5)), device=dev)
    before = dict(_build.LAUNCHES)
    ys, (hn, cn) = lstm.lstm_step(x, wx, wh, b, False, h0, c0)
    torch.cuda.synchronize()
    assert _lstm_bf16_counts(before) == {
        "lstm": 0, "lstm_project": 0, "lstm_recur": 0, "lstm_bf16": 1,
        "lstm_project_bf16": 0, "lstm_recur_bf16": 0}
    stepped = lstm._reference(x, wx, wh, b, False, h0, c0, h_in=ys)
    close([ys], [stepped[0]], ATOL)
    free = lstm._reference(x, wx, wh, b, False, h0, c0)
    bf16_close([ys, hn, cn], [free[0], *free[1]], floor=LSTM_FLOOR)


@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("bf,in_dim,h", [(1030, 32, 384), (1030, 384, 384),
                                         (70, 161, 44)])
def test_lstm_bf16_step_designs_agree(gen, dev, x_dtype, bf, in_dim, h):
    """The bf16 step's four designs (one or two m16 tiles a warp, plain or
    programmatic launches: lstm.bf16_step_design picks one) sum every
    output in the same order: the same y bit for bit, and the picked one
    within the twin's stepped tolerance."""
    x, wx, wh, b = _bf16_lstm_args(gen, bf, T_LONG, in_dim, h, x_dtype, dev)
    ys = [lstm._step_launch(x, wx, wh, b, False, None, None,
                            design=(mt, pdl))[0]
          for mt in (1, 2) for pdl in (False, True)]
    torch.cuda.synchronize()
    for y in ys[1:]:
        assert torch.equal(y, ys[0])
    stepped = lstm._reference(x, wx, wh, b, h_in=ys[0])
    close([ys[0]], [stepped[0]], ATOL)


# Bf T = 96 to 210 rows: ragged 64-row tiles; In = 161 and 33 (x padded
# to 168 and 40 by the wrapper), 100; 4H = 48, 80, 176, 400: ragged
# 64-column tiles
@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("bf,t,in_dim,h", [(8, 12, 512, 128),
                                           (37, 5, 161, 20),
                                           (3, 70, 33, 44),
                                           (5, 33, 161, 12),
                                           (37, 4, 100, 100)])
def test_lstm_project_bf16_kernel_matches_twin(gen, dev, x_dtype, bf, t,
                                               in_dim, h):
    x, wx, _, b = _bf16_lstm_args(gen, bf, t, in_dim, h, x_dtype, dev)
    before = dict(_build.LAUNCHES)
    got = lstm.lstm_project(x, wx, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _lstm_bf16_counts(before)["lstm_project_bf16"] == 1
    # fp32 out, exact products: the fp32 projection's rule
    close([got], [lstm._project_reference(x, wx, b)], ATOL)


# H = 20, 12 and 100: K padded to 32 and 128, the unit tiles ragged
@pytest.mark.parametrize("reverse,carry", [(False, False), (True, False),
                                           (False, True)])
@pytest.mark.parametrize("bf,h", [(8, 128), (4, 1024), (1604, 64), (30, 20),
                                  (5, 12), (37, 100)])
def test_lstm_recur_bf16_kernel_matches_twin(gen, dev, reverse, carry, bf,
                                             h):
    xp = torch.from_numpy(rand(gen, bf, 9, 4 * h)).to(dev)
    wh = (torch.from_numpy(rand(gen, h, 4 * h, scale=0.2)) * h ** -0.5 * 5
          ).to(dev).to(BF16)
    h0 = c0 = None
    if carry:
        h0, c0 = to_torch((rand(gen, bf, h, scale=0.5),
                           rand(gen, bf, h, scale=0.5)), device=dev)
    before = dict(_build.LAUNCHES)
    ys, (hn, cn) = lstm.lstm_recur(xp, wh, reverse, h0, c0)
    torch.cuda.synchronize()
    assert _lstm_bf16_counts(before)["lstm_recur_bf16"] == 1
    stepped = lstm._recur_reference(xp, wh, reverse, h0, c0, h_in=ys)
    close([ys], [stepped[0]], ATOL)
    free = lstm._recur_reference(xp, wh, reverse, h0, c0)
    bf16_close([ys, hn, cn], [free[0], *free[1]], floor=LSTM_FLOOR)


@pytest.mark.parametrize("h,bf", RECUR_PLANS)
def test_persistent_plan_is_the_bf16_kernels(dev, h, bf):
    """The bf16 recurrence's own plan (its bf16 Wh slice, the units and
    warps it picks of `recur_bf16_designs`) agrees with lstm_recur_bf16:
    the same shared memory a block, and the occupancy API lets the planned
    blocks share an SM."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = lstm.persistent_plan(bf, h, sms, BF16)
    assert plan is not None
    smem, per_sm = lstm.recur_fit(h, plan.chunks, dev, BF16, plan.tile,
                                  plan.warps)
    assert smem == plan.smem
    assert per_sm >= plan.blocks_sm


def _recur_bf16_resources(h, plan):
    import ctypes

    out = (ctypes.c_int * 4)()
    lib = _build.library()
    assert lib.se_lstm_recur_bf16_resources(
        -(-h // lstm.K_TILE) * lstm.K_TILE, plan.chunks, plan.tile,
        plan.warps, out) == 0
    return list(out)


@pytest.mark.parametrize("tile,warps", lstm.BF16_DESIGNS)
@pytest.mark.parametrize("h,bf", RECUR_PLANS)
def test_lstm_recur_bf16_resources(dev, tile, warps, h, bf):
    """Every design of lstm_recur_bf16 at every planned shape: no register
    spills, at most 128 registers a thread (its __launch_bounds__), and
    where shared memory sets the plan's blocks an SM (below the design's
    register cap of 16 / warps) the occupancy API's count is the plan's."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = lstm.persistent_plan(bf, h, sms, BF16, (tile, warps, 16 // warps))
    if plan is None:
        pytest.skip(f"no plan of {tile} units, {warps} warps fits H = {h}")
    regs, spill, smem, per_sm = _recur_bf16_resources(h, plan)
    assert spill == 0 and regs <= 128
    assert smem == plan.smem
    assert per_sm >= plan.blocks_sm
    if plan.blocks_sm < 16 // warps:
        assert per_sm == plan.blocks_sm


@pytest.mark.parametrize("tile,warps", lstm.BF16_DESIGNS)
@pytest.mark.parametrize("bf,h", [(4, 1024), (37, 100), (64, 512)])
def test_lstm_recur_bf16_designs_match_twin(gen, dev, tile, warps, bf, h):
    """Each design the plan may pick (units and warps a block) within the
    twin's stepped tolerance: the warps split K in other places, so the
    designs differ by fp32 round-off, never by more."""
    xp = torch.from_numpy(rand(gen, bf, 9, 4 * h)).to(dev)
    wh = (torch.from_numpy(rand(gen, h, 4 * h, scale=0.2)) * h ** -0.5 * 5
          ).to(dev).to(BF16)
    ys, _ = lstm._recur_launch(xp, wh, True, None, None,
                               design=(tile, warps, 16 // warps))
    torch.cuda.synchronize()
    stepped = lstm._recur_reference(xp, wh, True, h_in=ys)
    close([ys], [stepped[0]], ATOL)


# ------------------------------------------------ training on the card

def test_fullsubnet_fp32_train_step_runs_the_step(dev):
    """One fp32 train step of FullSubNet at B = 4 x 2 s: drop_band hands
    its sub band 128 B = 512 rows, past the SMs' worth of tensor-core
    blocks, so the layer takes the step kernel under autograd; every
    gradient finite."""
    from se_tpu_torch.train.trainer import TrainConfig, make_train_step

    model, init_fn, step_fn, _ = make_train_step(
        TrainConfig(model="fullsubnet"), device=dev)
    state = init_fn(0)
    g = torch.Generator(device=dev).manual_seed(1)
    clean = torch.randn(4, 32000, generator=g, device=dev) * 0.1
    batch = {"mix": clean + 0.05 * torch.randn(4, 32000, generator=g,
                                               device=dev),
             "clean": clean,
             "frames": torch.full((4,), 126, dtype=torch.int64, device=dev)}
    before = dict(_build.LAUNCHES)
    state, loss = step_fn(state, batch)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["lstm"] - before.get("lstm", 0) > 0
    assert bool(torch.isfinite(loss))
    for k, p in model.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), k


def _bf16_grad_case(fn, twin, args, floor):
    """fn's Function (kernel forward, the twin's VJP) against the twin's
    own autograd on the same CUDA leaves and upstream gradient: each
    input's gradient in its dtype, within bf16_close with `floor`."""
    runs = []
    for f in (fn, twin):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        out = f(*leaves)
        out = out[0] if isinstance(out, tuple) else out
        runs.append((leaves, out))
    (lk, ok), (lt, ot) = runs
    assert ok.grad_fn is not None
    up = torch.randn(ok.shape, generator=torch.Generator(
        device=ok.device).manual_seed(7), device=ok.device).to(ok.dtype)
    got = torch.autograd.grad(ok, lk, up)
    want = torch.autograd.grad(ot, lt, up)
    torch.cuda.synchronize()
    for a, w, x in zip(got, want, lk):
        assert a.dtype == x.dtype
    bf16_close(got, want, floor=floor)


@pytest.mark.parametrize("length", [4, 65])  # small_l, flash_tc
def test_attention_bf16_function_gradients_match_twin(dev, length):
    g = torch.Generator(device=dev).manual_seed(length)
    q, k, v = ((torch.randn(64, 2, length, 16, generator=g, device=dev)
                * 0.5).to(BF16) for _ in range(3))
    _bf16_grad_case(lambda *a: attention.sdp_attention(*a, 0.25),
                    lambda *a: attention._reference(*a, 0.25), (q, k, v),
                    1e-6)


@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("bf,t", [(1030, 5), (8, 40)])  # step, small fold
def test_lstm_bf16_function_gradients_match_twin(gen, dev, x_dtype, bf, t):
    args = _bf16_lstm_args(gen, bf, t, 33, 44, x_dtype, dev)
    _bf16_grad_case(lstm.lstm_layer_kernel, lstm._reference, args,
                    LSTM_FLOOR)


def test_lstm_project_and_recur_bf16_function_gradients_match_twin(gen,
                                                                   dev):
    x, wx, wh, b = _bf16_lstm_args(gen, 8, 40, 33, 44, torch.float32, dev)
    _bf16_grad_case(lstm.lstm_project, lstm._project_reference, (x, wx, b),
                    1e-6)
    xp = torch.randn(8, 40, 176, device=dev)
    _bf16_grad_case(lambda a, w: lstm.lstm_recur(a, w),
                    lambda a, w: lstm._recur_reference(a, w), (xp, wh),
                    LSTM_FLOOR)
