"""The bf16 variants of Uformer's four kernels on the CPU: their plain
twins against se_tpu's Pallas kernels, and their arithmetic emulated.

- Each twin in bf16 (`attention._reference`, `encoder._reference`,
  `decoder._reference`, `dsconv._pair_reference`) against se_tpu's Pallas
  kernel run with interpret=True on the same bf16 inputs and parameters
  (as tests/test_pallas_*.py run them): attention at L = 4 and 70, the
  encoder level, the decoder level with and without BN, the DSConv pair
  stage. Tolerance elementwise |got - want| <= 2^-7 |want| + 1e-6
  max|want| (`bf16_close`): one bf16 ulp where two fp32 sums in another
  order round to neighbours. Attention also rounds P to bf16 inside, and
  two fp32 softmaxes that sum in another order put an element of P on
  either side of a rounding boundary now and then; where the output
  cancels, that one P ulp passes the bound above. So for attention at
  most 1e-3 of the elements may pass it, each by no more than one P
  element's flip (`att_flip_slack`: 2^-7 x the row's largest P x the
  column's largest |v|). Each test records the share of elements that
  differ at all (`share_differing` in the junit XML).
- The CUDA designs' arithmetic in plain torch, as
  tests/test_torch_{attention,encoder,decoder,dsconv_pair}_tc.py emulate
  the fp32 ones: a product of two bf16 values is exact in one TF32 pass
  (the 3xTF32 split of a bf16 value has a zero small part), so the
  encoder's implicit GEMM runs one pass, also at K = 2560 where one pass
  of fp32 operands misses (test_torch_encoder_tc.py); the attention
  kernels' sweeps: the bf16 flash kernel (`flash_bf16_two_sweeps`: sweep
  1 the row max and sum, sweep 2 P normalised, rounded and multiplied by
  V on k16), beside the design it replaced (`flash_bf16_emulated`); its
  bf16 fragments (ldmatrix of K, ldmatrix.trans of V through the
  `kv_off` swizzle, P's A fragment from two accumulator tiles) lane by
  lane, and their bank groups. The encoder and decoder levels and the
  DSConv pair stage run on bf16 `mma.m16n8k16` from bf16 packs: the
  levels' bf16 products exact, summed a fresh fp32 fragment a K stage of
  32 (`k16_stages`, at Uformer's encoder levels 1-5, K up to 2560, and
  decoder levels 0-4, K up to 3072); the pair's fp32 operands in three
  bf16 pieces (`three_pieces`: tests/test_torch_lstm_tc.py's
  `split_bf16x3`, the pieces' sum the operand bit for bit), each product
  exact. Beside them the designs they replaced (one TF32 pass; two
  passes, equal to 3xTF32 bit for bit) on the same packs, widened. Before
  the output rounding within 1e-5 * max(1, max|twin|) of the fp32 twin on
  the widened inputs (the fp32 tests' tolerance), after it within the
  bf16 tolerance of the bf16 twin; each bf16 pack is the fp32 pack of the
  same values, in bf16.
- The design pickers by dtype and width (the widened route where a bf16
  tensor-core design cannot copy a level's or a stage's widths; attention
  picks by L in either dtype, tests/test_torch_attention_tc.py), and `_dtype.widened_launch`'s rounding and counts
  with the fp32 twin standing in for the fp32 kernel.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from se_tpu.ops import pallas_attention as jatt
from se_tpu.ops import pallas_decoder as jdec
from se_tpu.ops import pallas_dsconv as jds
from se_tpu.ops import pallas_encoder as jenc
from se_tpu_torch.ops import _build, attention, decoder, dsconv, encoder
from se_tpu_torch.ops._dtype import to_float, widened_launch
from test_torch_decoder_tc import implicit_gemm_level as decoder_gemm
from test_torch_decoder_tc import split_big
from test_torch_dsconv_pair_tc import stage_emulated
from test_torch_encoder_tc import implicit_gemm_level as encoder_gemm
from test_torch_lstm_tc import matmul_3xtf32, split, split_bf16x3
from torch_kernel_inputs import (
    att_flip_slack, att_inputs, bf16_close, dec_params, enc_params,
    pair_inputs, rand, to_bf16,
)

RTOL = 1e-5
STAGE_K = 32  # K a stage of the bf16 ring (tc_common.cuh bfr::BK)
LOG2E = math.log2(math.e)
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads would only contend with the
    other test workers' processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_jax(tensors):
    """bf16 tensors -> bf16 JAX arrays of the same values."""
    return tuple(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                 for t in tensors)


def one_pass(a, w):
    """One TF32 product a pair, fp32 accumulation."""
    return split_big(a) @ split_big(w)


def two_pass(a, w):
    """An fp32 A split, a B exact in TF32: small.B + big.B."""
    big, small = split(a)
    return small @ w + big @ w


def k16_stages(a, w):
    """decoder_level_tc_bf16's sums of a . w: a bf16-valued, w bf16, each
    product exact in fp32, a fresh fp32 sum a K stage of 32, the stages'
    sums added in order."""
    assert torch.equal(a, a.to(BF16).float()) and w.dtype == BF16
    w = w.float()
    acc = torch.zeros(a.shape[0], w.shape[1])
    for k0 in range(0, a.shape[1], STAGE_K):
        acc = acc + a[:, k0:k0 + STAGE_K] @ w[k0:k0 + STAGE_K]
    return acc


def three_pieces(a, w):
    """The bf16 pair stage's sums of a . w: an fp32 a in three bf16 pieces
    (`split_bf16x3`, whose sum is a bit for bit), each against the bf16 w
    (exact products), a fresh fp32 sum a K stage of 32, lo first."""
    hi, mid, lo = split_bf16x3(a)
    assert torch.equal(hi.double() + mid.double() + lo.double(), a.double())
    assert w.dtype == BF16
    w = w.float()
    acc = torch.zeros(a.shape[0], w.shape[1])
    for k0 in range(0, a.shape[1], STAGE_K):
        ks = slice(k0, k0 + STAGE_K)
        acc = acc + (lo[:, ks] @ w[ks] + mid[:, ks] @ w[ks]
                     + hi[:, ks] @ w[ks])
    return acc


def _close32(got, want):
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=RTOL * scale)


# ------------------------------------------------ twins against Pallas

@pytest.mark.parametrize("h", [8, 1])
@pytest.mark.parametrize("length", [4, 70])
def test_attention_twin_matches_pallas(rng, record_property, length, h):
    """L = 4 (the F-attention; se_tpu's einsum below _MIN_L, its kernel
    here) and 70 (past _MIN_L)."""
    q, k, v = to_bf16(att_inputs(rng, 3, h, length))
    got = attention._reference(q, k, v, 0.25)
    want = jatt._pallas_attention(*to_jax((q, k, v)), 0.25, True)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    slack = att_flip_slack(q, k, v, 0.25)
    record_property("share_differing",
                    bf16_close([got], [want], [slack]))


@pytest.mark.parametrize("b,t,f,cin,cout", [(2, 5, 16, 1, 8),
                                            (1, 4, 8, 8, 16)])
def test_encoder_twin_matches_pallas(rng, record_property, b, t, f, cin,
                                     cout):
    """Uformer's level 0 (Cin 1) and a tensor-core level's widths."""
    params = to_bf16(enc_params(rng, cin, cout))
    xc, xm = to_bf16((rand(rng, b, t, f, 2 * cin), rand(rng, b, t, f, cin)))
    got = encoder._reference(xc, xm, params)
    want = jenc._pallas_level(*to_jax((xc, xm)), to_jax(params), True)
    assert all(g.dtype == BF16 for g in got)
    record_property("share_differing", bf16_close(got, want))


@pytest.mark.parametrize("has_bn", [True, False])
@pytest.mark.parametrize("b,t,f,cc,cout", [(2, 5, 4, 8, 4),
                                           (1, 3, 8, 32, 16)])
def test_decoder_twin_matches_pallas(rng, record_property, b, t, f, cc,
                                     cout, has_bn):
    params = to_bf16(dec_params(rng, cc, cout))
    xc, xm = to_bf16((rand(rng, b, t, f, 2 * cc), rand(rng, b, t, f, cc)))
    got = decoder._reference(xc, xm, params, has_bn)
    want = jdec._pallas_level(*to_jax((xc, xm)), to_jax(params), has_bn,
                              True)
    assert all(g.dtype == BF16 for g in got)
    record_property("share_differing", bf16_close(got, want))


@pytest.mark.parametrize("d1,d2", [(1, 4), (2, 1)])
def test_pair_twin_matches_pallas(rng, record_property, d1, d2):
    """The stage at C 8, Cm 4 a component: se_tpu's `_pair_reference`
    rounds each block's output to bf16 before the fusion; its kernel and
    the twin do not."""
    xc, xm, pc, pm = pair_inputs(rng, 2, 9, 4, 8, 4)
    xc, xm = to_bf16((xc, xm))
    pc, pm = to_bf16(pc), to_bf16(pm)
    got = dsconv._pair_reference(xc, xm, pc, pm, d1, d2)
    want = jds._pallas_pair(*to_jax((xc, xm)), to_jax(pc + pm), d1, d2, True)
    assert all(g.dtype == BF16 for g in got)
    record_property("share_differing", bf16_close(got, want))


# ------------------------------------------ the designs' arithmetic

def test_one_tf32_pass_is_exact_on_bf16_operands(rng):
    """A bf16 value is its own TF32 rounding (its 3xTF32 small part is 0),
    so each product is exact in fp32 and three passes sum to one pass's
    result bit for bit."""
    a, w = (t.float() for t in to_bf16((rand(rng, 64, 96),
                                        rand(rng, 96, 40))))
    assert torch.equal(split_big(a), a) and torch.equal(split_big(w), w)
    assert torch.equal(split(a)[1], torch.zeros_like(a))
    prod = (a[:, :, None] * w[None]).double()
    assert torch.equal(prod, a.double()[:, :, None] * w.double()[None])
    assert torch.equal(matmul_3xtf32(a, w), one_pass(a, w))


def test_two_passes_are_3xtf32_on_a_bf16_weight(rng):
    """The pair stage's products: an fp32 operand and a bf16 weight."""
    a = torch.from_numpy(rand(rng, 64, 96))
    w = to_bf16((rand(rng, 96, 40),))[0].float()
    assert torch.equal(matmul_3xtf32(a, w), two_pass(a, w))


# (B, T, F, Cin, Cout) as test_torch_encoder_tc.py's, level 5's K = 2560
@pytest.mark.parametrize("b,t,f,cin,cout", [(2, 5, 6, 3, 5), (1, 3, 16, 1, 8),
                                            (2, 3, 8, 128, 128)])
def test_encoder_gemm_one_pass(rng, b, t, f, cin, cout):
    """The design test_encoder_gemm_bf16_k16 replaced: one TF32 pass on
    the bf16 pack widened, each product exact as there."""
    params = to_bf16(enc_params(rng, cin, cout))
    xc, xm = to_bf16((rand(rng, b, t, f, 2 * cin), rand(rng, b, t, f, cin)))
    packed = encoder.pack_encoder_weights(params)
    assert all(p.dtype == BF16 for p in packed)
    packed = to_float(packed)
    got = encoder_gemm(xc.float(), xm.float(), to_float(params), packed,
                       one_pass)
    _close32(got, encoder._reference.__wrapped__(
        xc.float(), xm.float(), to_float(params)))
    bf16_close([g.to(BF16) for g in got], encoder._reference(xc, xm, params))


# (B, T, F, Cin, Cout): Uformer's encoder levels 1-5 (level 5's K = 10 x 256
# = 2560 complex) at small B, T, F, then a narrow level (Cout padded to 32)
ENC_LEVELS = [(2, 3, 16, 8, 16), (2, 3, 16, 16, 32), (1, 3, 8, 32, 64),
              (1, 3, 8, 64, 128), (2, 3, 8, 128, 128), (2, 5, 6, 8, 12)]


@pytest.mark.parametrize("b,t,f,cin,cout", ENC_LEVELS)
def test_encoder_gemm_bf16_k16(rng, b, t, f, cin, cout):
    """encoder_level_tc_bf16's arithmetic on the bf16 pack: each product
    exact, a fresh fp32 sum a K stage of 32 joined by fp32 adds."""
    params = to_bf16(enc_params(rng, cin, cout))
    xc, xm = to_bf16((rand(rng, b, t, f, 2 * cin), rand(rng, b, t, f, cin)))
    packed = encoder.pack_encoder_weights(params)
    got = encoder_gemm(xc.float(), xm.float(), to_float(params), packed,
                       k16_stages)
    _close32(got, encoder._reference.__wrapped__(
        xc.float(), xm.float(), to_float(params)))
    bf16_close([g.to(BF16) for g in got], encoder._reference(xc, xm, params))


@pytest.mark.parametrize("cin,cout", [(128, 128), (8, 16), (12, 40)])
def test_encoder_bf16_pack_is_the_fp32_pack_in_bf16(rng, cin, cout):
    """A permutation of the bf16 kernels plus zeros, in bf16: the fp32
    pack of the same values, bit for bit."""
    params = to_bf16(enc_params(rng, cin, cout))
    packed = encoder.pack_encoder_weights(params)
    want = encoder.pack_encoder_weights(to_float(params))
    for got, ref, w in zip(packed, want, (params[0], params[5])):
        assert got.dtype == BF16 and ref.dtype == torch.float32
        assert torch.equal(got.float(), ref)
        vals = torch.sort(got[got != 0].float()).values
        src = w.flatten().float()
        torch.testing.assert_close(vals, torch.sort(src[src != 0]).values,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("has_bn", [True, False])
@pytest.mark.parametrize("b,t,f,cc,cout", [(2, 5, 4, 6, 3),
                                           (1, 3, 4, 256, 128)])
def test_decoder_gemm_one_pass(rng, b, t, f, cc, cout, has_bn):
    """The design test_decoder_gemm_bf16_k16 replaced: one TF32 pass on
    the bf16 pack widened, each product exact as there."""
    params = to_bf16(dec_params(rng, cc, cout))
    xc, xm = to_bf16((rand(rng, b, t, f, 2 * cc), rand(rng, b, t, f, cc)))
    packed = to_float(decoder.pack_decoder_weights(params))
    got = decoder_gemm(xc.float(), xm.float(), to_float(params), has_bn,
                       packed, one_pass)
    _close32(got, decoder._reference.__wrapped__(
        xc.float(), xm.float(), to_float(params), has_bn))
    bf16_close([g.to(BF16) for g in got],
               decoder._reference(xc, xm, params, has_bn))


# (B, T, F, Cc, Cout): Uformer's decoder levels 0-4 (level 0's K = 6 x 512
# = 3072), then a narrow level (Cout padded to 16)
DEC_LEVELS = [(1, 3, 4, 256, 128), (1, 3, 4, 256, 64), (2, 3, 4, 128, 32),
              (2, 3, 8, 64, 16), (2, 5, 4, 32, 8), (2, 5, 4, 8, 12)]


@pytest.mark.parametrize("has_bn", [True, False])
@pytest.mark.parametrize("b,t,f,cc,cout", DEC_LEVELS)
def test_decoder_gemm_bf16_k16(rng, b, t, f, cc, cout, has_bn):
    """decoder_level_tc_bf16's arithmetic on the bf16 pack."""
    params = to_bf16(dec_params(rng, cc, cout))
    xc, xm = to_bf16((rand(rng, b, t, f, 2 * cc), rand(rng, b, t, f, cc)))
    packed = decoder.pack_decoder_weights(params)
    got = decoder_gemm(xc.float(), xm.float(), to_float(params), has_bn,
                       packed, k16_stages)
    _close32(got, decoder._reference.__wrapped__(
        xc.float(), xm.float(), to_float(params), has_bn))
    bf16_close([g.to(BF16) for g in got],
               decoder._reference(xc, xm, params, has_bn))


@pytest.mark.parametrize("cc,cout", [(256, 128), (32, 8), (6, 3)])
def test_decoder_bf16_pack_is_the_fp32_pack_in_bf16(rng, cc, cout):
    """A permutation of the bf16 phase weights plus zeros, in bf16: the
    fp32 pack of the same values, bit for bit."""
    params = to_bf16(dec_params(rng, cc, cout))
    packed = decoder.pack_decoder_weights(params)
    want = decoder.pack_decoder_weights(to_float(params))
    for got, ref, (we, wo) in zip(packed, want, (params[0:2],
                                                 params[6:8])):
        assert got.dtype == BF16 and ref.dtype == torch.float32
        assert torch.equal(got.float(), ref)
        vals = torch.sort(got[got != 0].float()).values
        src = torch.cat([we.flatten(), wo.flatten()]).float()
        torch.testing.assert_close(vals, torch.sort(src[src != 0]).values,
                                   rtol=0, atol=0)


def flash_bf16_emulated(q, k, v, scale):
    """att_flash_tc<.., bf16> on (NH, L, 16) widened: sweep 1 takes the row
    max and sum over 64-key tiles (online, log2 units), sweep 2 forms P =
    round_bf16(exp2(s - m) / l) a tile and sums P . V (one pass: both
    bf16) into fresh tile sums."""
    nh, length, d = q.shape
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    keys = attention.FLASH_KEYS

    def tiles():
        for k0 in range(0, length, keys):
            pad = max(0, k0 + keys - length)
            kt = F.pad(k[:, k0:k0 + keys], (0, 0, 0, pad))
            vt = F.pad(v[:, k0:k0 + keys], (0, 0, 0, pad))
            s = one_pass(q, kt.transpose(1, 2)) * c
            s = torch.where(k0 + torch.arange(keys) < length, s, -math.inf)
            yield s, vt

    m = torch.full((nh, length), -math.inf)
    lsum = torch.zeros(nh, length)
    for s, _ in tiles():
        mnew = torch.maximum(m, s.amax(-1))
        lsum = lsum * torch.exp2(m - mnew) + torch.exp2(
            s - mnew[..., None]).sum(-1)
        m = mnew
    acc = torch.zeros(nh, length, d)
    for s, vt in tiles():
        p = (torch.exp2(s - m[..., None]) / lsum[..., None]).to(BF16).float()
        acc = acc + one_pass(p, vt)
    return acc


def small_l_bf16_emulated(q, k, v, scale):
    """att_small_l's bf16 thread: fp32 dot products, exp2 against the row
    max, the row sum, then round_bf16(p / l) times each v row."""
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    s = torch.zeros(q.shape[:-1] + (k.shape[1],))
    for ch in range(q.shape[-1]):
        s = s + q[..., ch:ch + 1] * k[:, None, :, ch]
    p = torch.exp2(s * c - (s * c).amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).to(BF16).float()
    acc = torch.zeros_like(q)
    for j in range(k.shape[1]):
        acc = acc + p[..., j:j + 1] * v[:, j:j + 1]
    return acc


@pytest.mark.parametrize("length", [1, 4, 65, 401])
def test_attention_bf16_designs_match_twin(rng, length):
    q, k, v = to_bf16(att_inputs(rng, 6, 1, length))
    want = attention._reference(q, k, v, 0.25)[:, 0]
    slack = [att_flip_slack(q, k, v, 0.25)[:, 0]]
    qf, kf, vf = (t.float()[:, 0] for t in (q, k, v))
    bf16_close([flash_bf16_emulated(qf, kf, vf, 0.25).to(BF16)], [want],
               slack)
    if length <= attention.SMALL_L_MAX:
        bf16_close([small_l_bf16_emulated(qf, kf, vf, 0.25).to(BF16)],
                   [want], slack)


def _k_tiles(q, k, scale):
    """The scaled, masked scores of each 64-key tile of K (exact bf16
    products, fp32 sums), log2 units."""
    length = k.shape[1]
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    keys = attention.FLASH_KEYS
    for k0 in range(0, length, keys):
        kt = F.pad(k[:, k0:k0 + keys], (0, 0, 0, max(0, k0 + keys - length)))
        s = (q @ kt.transpose(1, 2)) * c
        yield k0, torch.where(k0 + torch.arange(keys) < length, s, -math.inf)


def _pv_k16(p, v, k0):
    """P (fp32, rounded to bf16 here) . V over one 64-key tile, k16 steps
    (exact products) summed into a fresh tile sum."""
    keys = attention.FLASH_KEYS
    vt = F.pad(v[:, k0:k0 + keys], (0, 0, 0, max(0, k0 + keys - v.shape[1])))
    p = p.to(BF16).float()
    part = torch.zeros(p.shape[:-1] + (v.shape[-1],))
    for j in range(0, keys, 16):
        part = part + p[..., j:j + 16] @ vt[:, j:j + 16]
    return part


def flash_bf16_two_sweeps(q, k, v, scale):
    """att_flash_bf16 on (NH, L, 16) widened: sweep 1 the row max and sum
    over the K tiles of 64 keys, sweep 2 the scores again, P = exp2(s - m)
    x (1 / l) rounded to bf16, P . V on k16 (both bf16: exact products)
    into fresh tile sums."""
    nh, length, d = q.shape
    m = torch.full((nh, length), -math.inf)
    lsum = torch.zeros(nh, length)
    for _, s in _k_tiles(q, k, scale):
        mnew = torch.maximum(m, s.amax(-1))
        lsum = lsum * torch.exp2(m - mnew) + torch.exp2(
            s - mnew[..., None]).sum(-1)
        m = mnew
    inv = 1.0 / lsum
    acc = torch.zeros(nh, length, d)
    for k0, s in _k_tiles(q, k, scale):
        acc = acc + _pv_k16(torch.exp2(s - m[..., None]) * inv[..., None],
                            v, k0)
    return acc


@pytest.mark.parametrize("length", [1, 4, 65, 401, 588])
def test_attention_bf16_two_sweeps_matches_twin(rng, length):
    """The flash kernel's design at Uformer's L = 401, at one key, one
    tile and one past it, and at a long utterance's 588."""
    q, k, v = to_bf16(att_inputs(rng, 6 if length <= 401 else 3, 1, length))
    want = attention._reference(q, k, v, 0.25)[:, 0]
    qf, kf, vf = (t.float()[:, 0] for t in (q, k, v))
    bf16_close([flash_bf16_two_sweeps(qf, kf, vf, 0.25).to(BF16)], [want],
               [att_flip_slack(q, k, v, 0.25)[:, 0]])


# mma.sync.m16n8k16 .bf16 fragments and ldmatrix (PTX ISA): lane = 4 gid +
# tq; a 32-bit register holds two bf16, half h = 0 the lower index
def a16_coords(lane, i, h):
    """A register i, half h: (row, k) of the 16 x 16 tile."""
    gid, tq = divmod(lane, 4)
    return gid + 8 * (i & 1), 2 * tq + h + 8 * (i >> 1)


def b16_coords(lane, i, h):
    """B register i, half h: (k, col) of the 16 x 8 tile."""
    gid, tq = divmod(lane, 4)
    return 2 * tq + h + 8 * i, gid


def c16_coords(lane, i):
    """Accumulator register i: (row, col) of the 16 x 8 tile."""
    gid, tq = divmod(lane, 4)
    return gid + 8 * (i >> 1), 2 * tq + (i & 1)


def kv_off(r, c):
    """csrc/attention.cu `kv_off`: element offset of chunk c of key row r."""
    return r * 16 + ((c ^ ((r >> 2) & 1)) << 3)


def ldmatrix_x4(smem, addr, trans):
    """regs[lane][i][h] of ldmatrix.x4 (.trans) over the 1-D bf16 array
    smem, lane l giving element offset addr(l) of row l % 8 of matrix l /
    8; asserts that each matrix's 8 rows fall in 8 distinct 16-byte bank
    groups."""
    regs = [[[None, None] for _ in range(4)] for _ in range(32)]
    for i in range(4):
        rows = [addr(8 * i + r) for r in range(8)]
        assert all(r % 8 == 0 for r in rows)  # 16-byte aligned
        assert len({(2 * r // 16) % 8 for r in rows}) == 8
        for lane in range(32):
            gid, tq = divmod(lane, 4)
            for h in range(2):
                regs[lane][i][h] = (smem[rows[2 * tq + h] + gid] if trans
                                    else smem[rows[gid] + 2 * tq + h])
    return regs


def test_attention_bf16_fragments_lane_by_lane():
    """The bf16 flash kernel's fragments as csrc/attention.cu forms them:
    K's B fragments of n8 tiles g, g + 1 from one ldmatrix.x4 (rows keys
    8 g + (lane & 7) + 8 (lane >> 4), chunk (lane >> 3) & 1), V's of d
    tiles 0, 1 for k16 step j from one ldmatrix.x4.trans (rows 16 j +
    (lane & 7) + 8 ((lane >> 3) & 1), chunk lane >> 4), both through the
    `kv_off` swizzle, conflict-free; P's A fragment of step j is the
    accumulators of n8 tiles 2 j and 2 j + 1 (a[2 h + hh] = registers 2 hh,
    2 hh + 1 of tile 2 j + h)."""
    keys = attention.FLASH_KEYS
    kmat = [[1000 * key + d for d in range(16)] for key in range(keys)]
    smem = [None] * (keys * 16)
    for key in range(keys):
        for c in range(2):
            for e in range(8):
                smem[kv_off(key, c) + e] = kmat[key][8 * c + e]
    for g in range(0, 8, 2):
        regs = ldmatrix_x4(
            smem, lambda l: kv_off(8 * g + (l & 7) + ((l >> 4) << 3),
                                   (l >> 3) & 1), trans=False)
        for lane in range(32):
            for t in range(2):  # n8 tile g + t: registers 2 t, 2 t + 1
                for i in range(2):
                    for h in range(2):
                        kk, n = b16_coords(lane, i, h)
                        assert regs[lane][2 * t + i][h] == \
                            kmat[8 * (g + t) + n][kk]
    for j in range(4):
        regs = ldmatrix_x4(
            smem, lambda l: kv_off(16 * j + (l & 7) + (((l >> 3) & 1) << 3),
                                   l >> 4), trans=True)
        for lane in range(32):
            for dn in range(2):  # d tile dn: registers 2 dn, 2 dn + 1
                for i in range(2):
                    for h in range(2):
                        kk, n = b16_coords(lane, i, h)
                        assert regs[lane][2 * dn + i][h] == \
                            kmat[16 * j + kk][8 * dn + n]
        for lane in range(32):
            for h in range(2):
                for hh in range(2):
                    for e in range(2):
                        row, col = c16_coords(lane, 2 * hh + e)
                        assert a16_coords(lane, 2 * h + hh, e) == \
                            (row, 8 * h + col)
    # Q's A fragment: register j at row gid + 8 (j & 1), d 2 tq + 8 (j >> 1)
    for lane in range(32):
        gid, tq = divmod(lane, 4)
        for j in range(4):
            for h in range(2):
                assert a16_coords(lane, j, h) == (gid + 8 * (j & 1),
                                                  2 * tq + 8 * (j >> 1) + h)


BF16 = torch.bfloat16


@pytest.mark.parametrize("cin,fp32,bf16", [
    (1, "cuda_core", "cuda_core"), (3, "cuda_core", "cuda_core"),
    (4, "tc", "tc_widened"), (12, "tc", "tc_widened"), (8, "tc", "tc"),
    (128, "tc", "tc")])
def test_encoder_design_by_dtype_and_width(cin, fp32, bf16):
    """bf16 copies 8 channels at a time: Cin % 4 == 0 but Cin % 8 != 0
    takes the fp32 tensor-core kernel on widened inputs."""
    assert encoder.level_design(cin) == fp32
    assert encoder.level_design(cin, BF16) == bf16


@pytest.mark.parametrize("cc,cout,fp32,bf16", [
    (12, 16, "tc", "tc_widened"), (20, 8, "tc", "tc_widened"),
    (256, 128, "tc", "tc"), (32, 8, "tc", "tc"),
    (6, 16, "cuda_core", "cuda_core"), (16, 1, "cuda_core", "cuda_core")])
def test_decoder_design_by_dtype_and_width(cc, cout, fp32, bf16):
    """As the encoder's; Cc % 4 != 0 and Cout < 8 keep the CUDA cores,
    which have a bf16 variant."""
    assert decoder.level_design(cc, cout) == fp32
    assert decoder.level_design(cc, cout, BF16) == bf16


@pytest.mark.parametrize("c,totc,totm,bf16", [
    (128, 64, 32, "tc"), (12, 32, 16, "tc_widened"),
    (64, 8, 4, "tc_widened"), (64, 64, 8, "tc_widened"),
    (40, 32, 16, "tc")])
def test_pair_design_by_dtype_and_width(c, totc, totm, bf16):
    """The bf16 stage copies 8 channels of C and steps both blocks' widths
    by k16; fp32 runs every width its checks take."""
    assert dsconv.pair_design(c, totc, totm) == "tc"
    assert dsconv.pair_design(c, totc, totm, BF16) == bf16


def test_widened_launch_rounds_once_and_counts(rng):
    """`_dtype.widened_launch` with the fp32 twin standing in for the fp32
    kernel: the bf16 twin's result bit for bit (widened, fp32, rounded
    once), an fp32 pack made from the bf16 weights where the caller keeps
    none (the bf16 pack widened, bit for bit) and the caller's fp32 pack
    as it is, counted as decoder_bf16 and decoder_bf16_widened; fp32
    activations and fp32 weights refused."""
    params = to_bf16(dec_params(rng, 12, 16))
    xc, xm = to_bf16((rand(rng, 1, 3, 4, 24), rand(rng, 1, 3, 4, 12)))
    seen = []

    def run(xc, xm, params, packed):
        seen.append([p.dtype for p in (xc, xm, *params, *packed)])
        return decoder._reference(xc, xm, params, True)

    before = dict(_build.LAUNCHES)
    got = widened_launch("decoder", run, xc, xm, params, (0, 1, 6, 7), None,
                         decoder.pack_decoder_weights)
    assert set(seen[0]) == {torch.float32}
    for g, w in zip(got, decoder._reference(xc, xm, params, True)):
        assert g.dtype == BF16 and torch.equal(g, w)
    assert {n: _build.LAUNCHES[n] - before.get(n, 0) for n in (
        "decoder", "decoder_bf16", "decoder_bf16_widened")} == {
            "decoder": 0, "decoder_bf16": 1, "decoder_bf16_widened": 1}
    fp32_pack = decoder.pack_decoder_weights(params, torch.float32)
    for got_w, want_w in zip(fp32_pack,
                             to_float(decoder.pack_decoder_weights(params))):
        assert got_w.dtype == torch.float32 and torch.equal(got_w, want_w)
    kept = []
    widened_launch("decoder", lambda *a: kept.append(a[3]) or run(*a), xc,
                   xm, params, (0, 1, 6, 7), fp32_pack, None)
    assert set(seen[1]) == {torch.float32}
    assert all(a is b for a, b in zip(kept[0], fp32_pack))
    with pytest.raises(ValueError, match="bf16 activations"):
        widened_launch("decoder", run, xc.float(), xm.float(), params,
                       (0, 1, 6, 7), None, decoder.pack_decoder_weights)
    with pytest.raises(TypeError, match="bf16 conv weights"):
        widened_launch("decoder", run, xc, xm, to_float(params),
                       (0, 1, 6, 7), None, decoder.pack_decoder_weights)


@pytest.mark.parametrize("d1,d2", [(1, 128), (4, 2)])
def test_pair_stage_two_passes_match_twin(rng, d1, d2):
    """The design test_pair_stage_three_pieces_match_twin replaced, at the
    conformer's widths (C 128, Cm 32 a component), T = 9: two TF32 passes
    against the bf16 pack widened."""
    xc, xm, pc, pm = pair_inputs(rng, 1, 9, 4, 128, 32)
    xc, xm = to_bf16((xc, xm))
    pc, pm = to_bf16(pc), to_bf16(pm)
    packed = to_float(dsconv.pack_pair_weights(pc, pm))
    got = stage_emulated(xc.float(), xm.float(), packed, d1, d2, two_pass)
    _close32(got, dsconv._pair_reference.__wrapped__(
        xc.float(), xm.float(), to_float(pc), to_float(pm), d1, d2))
    bf16_close([g.to(BF16) for g in got],
               dsconv._pair_reference(xc, xm, pc, pm, d1, d2))


PAIR_WEIGHTS = (0, 5, 7, 11)  # w1, wd1, wd2, ws in a packed tuple


@pytest.mark.parametrize("d1,d2", [(2 ** i, 2 ** (7 - i)) for i in range(8)])
def test_pair_stage_three_pieces_match_twin(rng, d1, d2):
    """se_dsconv_pair_tc_bf16's arithmetic on the bf16 pack, at the
    conformer's widths and every dilation pair of its eight stages (T = 9:
    d >= 16 reaches past both ends)."""
    xc, xm, pc, pm = pair_inputs(rng, 1, 9, 4, 128, 32)
    xc, xm = to_bf16((xc, xm))
    pc, pm = to_bf16(pc), to_bf16(pm)
    packed = dsconv.pack_pair_weights(pc, pm)
    got = stage_emulated(xc.float(), xm.float(), packed, d1, d2,
                         three_pieces)
    _close32(got, dsconv._pair_reference.__wrapped__(
        xc.float(), xm.float(), to_float(pc), to_float(pm), d1, d2))
    bf16_close([g.to(BF16) for g in got],
               dsconv._pair_reference(xc, xm, pc, pm, d1, d2))


@pytest.mark.parametrize("c,cm", [(128, 32), (40, 16)])
def test_pair_bf16_pack_is_the_fp32_pack_in_bf16(rng, c, cm):
    """The weights a permutation of the bf16 weights plus zeros, in bf16
    (the fp32 pack of the same values, bit for bit); the vectors fp32."""
    _, _, pc, pm = pair_inputs(rng, 1, 1, 4, c, cm)
    pc, pm = to_bf16(pc), to_bf16(pm)
    packed = dsconv.pack_pair_weights(pc, pm)
    want = dsconv.pack_pair_weights(to_float(pc), to_float(pm))
    for pk, ref, params in zip(packed, want, (pc, pm)):
        for i, (got, r) in enumerate(zip(pk, ref)):
            assert got.dtype == (BF16 if i in PAIR_WEIGHTS
                                 else torch.float32)
            assert torch.equal(got.float(), r)
        for i in PAIR_WEIGHTS:
            vals = torch.sort(pk[i][pk[i] != 0].float()).values
            src = params[{0: 2, 5: 5, 7: 7, 11: 11}[i]].float()
            torch.testing.assert_close(
                vals, torch.sort(src[src != 0]).values, rtol=0, atol=0)


def test_twins_widen_and_round_once(rng):
    """A bf16 twin is the fp32 twin on the widened inputs, rounded once."""
    params = to_bf16(enc_params(rng, 4, 8))
    xc, xm = to_bf16((rand(rng, 1, 3, 8, 8), rand(rng, 1, 3, 8, 4)))
    got = encoder._reference(xc, xm, params)
    want = encoder._reference(xc.float(), xm.float(), to_float(params))
    for g, w in zip(got, want):
        assert g.dtype == BF16 and torch.equal(g, w.to(BF16))
