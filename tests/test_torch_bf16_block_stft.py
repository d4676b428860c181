"""Two bf16 kernel variants on the CPU: the single DSConv block
(csrc/dsconv.cu `se_dsconv_block_tc_bf16`) and the STFT's basis product
(csrc/stft.cu `se_stft_basis_bf16`). The kernels run only on the card
(tests/test_torch_cuda.py); here their plain twins are held to se_tpu and
their arithmetic is formed in plain torch.

- The block's twin in bf16 (`dsconv._reference`, widened: fp32 inside, the
  output rounded once) against se_tpu's Pallas block kernel run with
  interpret=True on the same bf16 x and parameters, complex and real, two
  dilation pairs each, within the bf16 rule (`bf16_close`: one bf16 ulp
  plus 1e-6 of the largest output). DSConvCplx / DSConvReal in eval on a
  bf16 input with bf16 parameters against se_tpu's modules from the same
  weights (the same rule). The bf16 design's arithmetic: the fp32 block's
  emulation (tests/test_torch_dsconv_block_tc.py) on the bf16 packs, each
  fp32 operand in three bf16 pieces (`three_pieces`), at the conformer's
  widths and all eight dilation pairs; the widened route's on fp32 packs
  of the bf16 weights, each product two TF32 passes (the fp32 kernel's
  3xTF32, bit for bit). Each within 1e-5 * max(1, max|twin|) of the fp32
  twin on the widened inputs before the output rounding and within the
  bf16 rule of the bf16 twin (the three pieces also of se_tpu's Pallas
  block) after it. `block_design` by dtype and width, the bf16 pack the
  fp32 pack in bf16 (fp32 on the widened route), and `widened_launch`
  with the block's one activation.
- The STFT's twin (`stft_fused._reference`: the frames times the window x
  DFT basis rounded to bf16, the products summed in fp32, the spectrum
  fp32) against se_tpu's `stft_pallas` in interpret mode (pallas_call
  patched as tests/test_pallas_stft.py patches it) on a bf16 waveform, in
  the three conventions, within 1e-5 of the largest |output| (both sum
  exact bf16 products in fp32; measured at most 5.2e-7 of it, three seeds a
  convention). The dtype split that is se_tpu's own: `stft_pallas`
  returns fp32 on a bf16 waveform, its jnp `stft` bf16; the port's
  `stft_fused` / `stft_auto` follow the first, its `ops.stft.stft` the
  second, which is held to se_tpu's jnp `stft` in bf16 within the bf16
  rule.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import se_tpu.models.uformer as juformer
from se_tpu.ops import pallas_dsconv as jds
from se_tpu.ops import pallas_stft as jps
from se_tpu.ops.stft import StftConfig as JStftConfig
from se_tpu.ops.stft import stft as jnp_stft
from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.models import uformer
from se_tpu_torch.ops import _build, dsconv, stft_fused
from se_tpu_torch.ops._dtype import to_float, widened_launch
from se_tpu_torch.ops.stft import (
    PRESET_512_128, PRESET_UFORMER, StftConfig, stft,
)
from test_torch_bf16_kernels import three_pieces, to_jax, two_pass
from test_torch_dsconv_block_tc import block_emulated
from test_torch_lstm_tc import matmul_3xtf32
from torch_kernel_inputs import (
    bf16_close, dsconv_params, fill_tree, rand, to_bf16,
)

BF16 = torch.bfloat16
BLOCK_WEIGHTS = (0, 5, 7, 11)  # w1, wd1, wd2, ws in a packed tuple
RTOL = 1e-5
STFT_RTOL = 1e-5
CONVENTIONS = {
    "center": PRESET_512_128,
    "pad_end": StftConfig(512, 256, 512, window="hamming",
                          convention="pad_end"),
    "valid": StftConfig(400, 100, 512, convention="valid"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads would only contend with the
    other test workers' processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close32(got, want):
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=RTOL * scale)


# ------------------------------------------------- 4c: the single block

@pytest.mark.parametrize("d1,d2", [(1, 128), (4, 2)])
@pytest.mark.parametrize("ncomp", [2, 1])
def test_block_twin_matches_pallas(rng, record_property, ncomp, d1, d2):
    """Cin 16 a component, Cm 8, d = 128 > T and d = 4, 2."""
    cin = 16 * ncomp
    params = to_bf16(dsconv_params(rng, cin, 8, ncomp))
    (x,) = to_bf16((rand(rng, 2, 10, 4, cin, scale=0.5),))
    got = dsconv.dsconv_block(x, params, d1, d2, ncomp)
    want = jds.dsconv_block(*to_jax((x,)), to_jax(params), d1, d2, ncomp,
                            interpret=True)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    record_property("share_differing", bf16_close([got], [want]))


def test_block_twin_widens_and_rounds_once(rng):
    """The bf16 twin is the fp32 twin on the widened inputs, rounded once."""
    params = to_bf16(dsconv_params(rng, 16, 4, 2))
    (x,) = to_bf16((rand(rng, 1, 6, 4, 16),))
    got = dsconv._reference(x, params, 2, 1, 2)
    want = dsconv._reference(x.float(), to_float(params), 2, 1, 2)
    assert got.dtype == BF16 and torch.equal(got, want.to(BF16))


@pytest.mark.parametrize("ncomp,cin", [(2, 256), (1, 128)])
def test_block_two_passes_match_twin(rng, ncomp, cin):
    """The widened route's arithmetic ("tc_widened": the fp32 block on the
    widened inputs) at the conformer's widths (Cm 32 a component), T = 9,
    from the fp32 packs of the bf16 parameters it takes: every product an
    fp32 operand (LN1's output, y's taps, z) against a bf16-valued weight,
    where the fp32 kernel's 3xTF32 is two TF32 passes bit for bit."""
    params = to_bf16(dsconv_params(rng, cin, 32, ncomp))
    (x,) = to_bf16((rand(rng, 1, 9, 4, cin, scale=0.5),))
    pk = dsconv.pack_block_weights(params, ncomp, torch.float32)
    assert all(t.dtype == torch.float32 for t in pk)
    got = block_emulated(x.float(), pk, ncomp, 128, 1, two_pass)
    assert torch.equal(got, block_emulated(x.float(), pk, ncomp, 128, 1,
                                           matmul_3xtf32))
    _close32(got, dsconv._reference.__wrapped__(
        x.float(), to_float(params), 128, 1, ncomp))
    bf16_close([got.to(BF16)], [dsconv._reference(x, params, 128, 1,
                                                   ncomp)])


@pytest.mark.parametrize("cin,tot,bf16", [
    (256, 64, "tc"), (128, 32, "tc"), (24, 16, "tc"),
    (12, 8, "tc_widened"), (12, 16, "tc_widened"), (16, 8, "tc_widened"),
    (64, 36, "tc_widened")])
def test_block_design_by_dtype_and_width(cin, tot, bf16):
    """The bf16 block copies 8 channels of x at a time and steps the
    output GEMM by k16; fp32 runs every width its checks take."""
    assert dsconv.block_design(cin, tot) == "tc"
    assert dsconv.block_design(cin, tot, BF16) == bf16


@pytest.mark.parametrize("cin,cm,ncomp,design", [
    (256, 32, 2, "tc"), (128, 32, 1, "tc"), (24, 8, 2, "tc"),
    (12, 8, 1, "tc_widened"), (16, 4, 2, "tc_widened")])
def test_block_bf16_pack_is_the_fp32_pack_in_bf16(rng, cin, cm, ncomp,
                                                 design):
    """From bf16 weights the block packs for its design: on "tc" the
    weights w1, wd1, wd2 and ws in bf16 (the fp32 pack of the same values,
    bit for bit), on the widened route in fp32 (the same pack widened);
    the vectors fp32 either way."""
    params = to_bf16(dsconv_params(rng, cin, cm, ncomp))
    assert dsconv.block_design(cin, cm * ncomp, BF16) == design
    packed = dsconv.pack_block_weights(params, ncomp)
    want = dsconv.pack_block_weights(to_float(params), ncomp)
    weights = BF16 if design == "tc" else torch.float32
    for i, (got, ref) in enumerate(zip(packed, want)):
        assert got.dtype == (weights if i in BLOCK_WEIGHTS
                             else torch.float32)
        assert torch.equal(got.float(), ref)
    assert [t.dtype for t in dsconv.pack_block_weights(
        params, ncomp, torch.float32)] == [torch.float32] * 13


@pytest.mark.parametrize("d1,d2", [(2 ** i, 2 ** (7 - i)) for i in range(8)])
@pytest.mark.parametrize("ncomp,cin", [(2, 256), (1, 128)])
def test_block_three_pieces_match_twin(rng, ncomp, cin, d1, d2):
    """se_dsconv_block_tc_bf16's arithmetic on the bf16 pack, at the
    conformer's widths (Cm 32 a component) and every dilation pair of its
    eight stages, T = 9 (d >= 16 reaches past both ends): each fp32
    operand (LN1's output, y's taps, z) in three bf16 pieces against the
    bf16 weights (`three_pieces`). Before the output rounding within 1e-5
    * max(1, max|twin|) of the fp32 twin on the widened inputs, after it
    within the bf16 rule of the bf16 twin and of se_tpu's Pallas block in
    interpret mode on the same bf16 x and parameters."""
    params = to_bf16(dsconv_params(rng, cin, 32, ncomp))
    (x,) = to_bf16((rand(rng, 1, 9, 4, cin, scale=0.5),))
    pk = dsconv.pack_block_weights(params, ncomp)
    assert [t.dtype for t in pk] == [
        BF16 if i in BLOCK_WEIGHTS else torch.float32 for i in range(13)]
    got = block_emulated(x.float(), pk, ncomp, d1, d2, three_pieces)
    _close32(got, dsconv._reference.__wrapped__(
        x.float(), to_float(params), d1, d2, ncomp))
    bf16_close([got.to(BF16)], [dsconv._reference(x, params, d1, d2,
                                                   ncomp)])
    bf16_close([got.to(BF16)], [jds.dsconv_block(
        *to_jax((x,)), to_jax(params), d1, d2, ncomp, interpret=True)])


def test_block_widened_launch_rounds_once_and_counts(rng):
    """`_dtype.widened_launch` with one activation, the block's fp32 twin
    standing in for the fp32 kernel: the bf16 twin bit for bit, from an
    fp32 pack made of the bf16 weights, counted as dsconv_bf16 and
    dsconv_bf16_widened."""
    params = to_bf16(dsconv_params(rng, 12, 8, 1))
    (x,) = to_bf16((rand(rng, 1, 5, 4, 12, scale=0.5),))
    seen = []

    def run(x, params, packed):
        seen.append({t.dtype for t in (x, *params, *packed)})
        return dsconv._reference(x, params, 2, 1, 1)

    before = dict(_build.LAUNCHES)
    got = widened_launch("dsconv", run, x, params, dsconv.PAIR_WEIGHTS,
                         None, lambda p, dtype: dsconv.pack_block_weights(
                             p, 1, dtype))
    assert seen == [{torch.float32}]
    assert got.dtype == BF16
    assert torch.equal(got, dsconv._reference(x, params, 2, 1, 1))
    assert {n: _build.LAUNCHES[n] - before.get(n, 0) for n in (
        "dsconv", "dsconv_bf16", "dsconv_bf16_widened")} == {
            "dsconv": 0, "dsconv_bf16": 1, "dsconv_bf16_widened": 1}


def _module_pair(kind: str, cin: int, seed: int):
    """se_tpu's DSConv module and its variables, and the port's module
    holding the same weights (the names `uformer.from_jax_variables`
    gives a conformer block)."""
    jcls = juformer.DSConvCplx if kind == "cplx" else juformer.DSConvReal
    jblk = jcls(conv_channels=8, dilation1=2, dilation2=1)
    args = (np.zeros((1, 3, 4, cin), np.float32),) * (2 if kind == "cplx"
                                                      else 1)
    variables = fill_tree(jax.eval_shape(jblk.init, jax.random.PRNGKey(0),
                                         *args), seed)
    t = variables["params"]
    sd: dict = {}
    jt.put_layernorm(sd, "b.layernorm_conv1", t["ln1"])
    jt.put_layernorm(sd, "b.layernorm_conv2", t["ln2"])
    uformer._put_prelu(sd, "b.prelu", t["prelu"])
    for conv in ("conv1x1", "dconv1", "dconv2", "sconv"):
        if kind == "cplx":
            uformer._put_cconv(sd, f"b.{conv}", t[conv])
        else:
            uformer._put_conv(sd, f"b.{conv}.conv", t[conv]["conv"])
    pcls = uformer.DSConvCplx if kind == "cplx" else uformer.DSConvReal
    blk = pcls(cin, 8, 2, 1)
    blk.load_state_dict({k[2:]: v for k, v in sd.items()})
    return jblk, variables, blk.eval()


@pytest.mark.parametrize("kind", ["cplx", "real"])
def test_dsconv_modules_bf16_match_se_tpu(rng, record_property, kind):
    """DSConvCplx / DSConvReal in eval, the module and its input bf16 (its
    forward: `dsconv_block` on its 13-tuple), against se_tpu's module with
    its variables cast to bf16 (its eval: `dsconv_block` on the CPU, whose
    `_reference` widens x too), C = 16 a component, Cm 8."""
    jblk, variables, blk = _module_pair(kind, 16, seed=5)
    blk = blk.to(BF16)
    jvars = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                         variables)
    if kind == "cplx":
        re, im = to_bf16((rand(rng, 2, 9, 4, 16), rand(rng, 2, 9, 4, 16)))
        got = blk(torch.cat([re, im], -1))
        want = jnp.concatenate(jblk.apply(jvars, *to_jax((re, im))), -1)
    else:
        (x,) = to_bf16((rand(rng, 2, 9, 4, 16),))
        got = blk(x)
        want = jblk.apply(jvars, *to_jax((x,)))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    record_property("share_differing", bf16_close([got], [want]))


# ------------------------------------------------- 4d: the STFT

def _stft_pallas(x, cfg):
    """se_tpu's Pallas STFT in interpret mode (tests/test_pallas_stft.py)."""
    orig = pl.pallas_call
    with mock.patch.object(jps.pl, "pallas_call",
                           functools.partial(orig, interpret=True)):
        return jps.stft_pallas.__wrapped__(x, cfg)


def _jax_cfg(cfg: StftConfig) -> JStftConfig:
    return JStftConfig(**{f: getattr(cfg, f) for f in (
        "win_length", "hop", "n_fft", "window", "convention", "periodic",
        "synthesis_norm")})


def _wave(rng, n=4001):
    (x,) = to_bf16((rand(rng, 2, n, scale=0.1),))
    return x


@pytest.mark.parametrize("convention", sorted(CONVENTIONS))
def test_stft_twin_matches_pallas(rng, convention):
    """A ragged waveform (n % hop != 0), bf16: the twin and se_tpu's
    kernel, both fp32 out."""
    cfg = CONVENTIONS[convention]
    x = _wave(rng)
    got = stft_fused._reference(x, cfg)
    jcfg = _jax_cfg(cfg)
    want = _stft_pallas(*to_jax((x,)), jcfg)
    assert all(g.dtype == torch.float32 for g in got)
    assert all(w.dtype == jnp.float32 for w in want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=STFT_RTOL * scale)


@pytest.mark.parametrize("convention", sorted(CONVENTIONS))
def test_cpu_stft_follows_jnp_stft_in_bf16(rng, record_property,
                                           convention):
    """The port's plain `stft` on a bf16 waveform against se_tpu's jnp
    `stft`: both round the spectrum to bf16."""
    cfg = CONVENTIONS[convention]
    x = _wave(rng)
    got = stft(x, cfg)
    jcfg = _jax_cfg(cfg)
    want = jnp_stft(*to_jax((x,)), jcfg)
    assert all(g.dtype == BF16 for g in got)
    assert all(w.dtype == jnp.bfloat16 for w in want)
    record_property("share_differing", bf16_close(got, want))


def test_stft_dtype_split(rng):
    """se_tpu's own split on a bf16 waveform, and where the port stands:
    `stft_pallas` fp32 and jnp `stft` bf16; the port's `stft_fused` and
    `stft_auto` (the kernel's twin on the CPU) fp32, its `ops.stft.stft`
    bf16, the spectrum the same up to that one rounding. `stft_auto`
    sends a 2-D waveform to the kernel's path and a 3-D one, or Uformer's
    512/160, to `stft`. The twin on fp32 is `stft` exactly, and the bf16
    kernel refuses a waveform that requires grad, as the fp32 one."""
    x = _wave(rng)
    jx = to_jax((x,))[0]
    jcfg = _jax_cfg(PRESET_512_128)
    assert _stft_pallas(jx, jcfg)[0].dtype == jnp.float32
    assert jnp_stft(jx, jcfg)[0].dtype == jnp.bfloat16
    fused = stft_fused.stft_fused(x, PRESET_512_128)
    auto = stft_fused.stft_auto(x, PRESET_512_128)
    plain = stft(x, PRESET_512_128)
    for f, a, p in zip(fused, auto, plain):
        assert f.dtype == a.dtype == torch.float32 and p.dtype == BF16
        assert torch.equal(f, a) and torch.equal(f.to(BF16), p)
    assert stft_fused.stft_auto(x[None], PRESET_512_128)[0].dtype == BF16
    assert stft_fused.stft_auto(x, PRESET_UFORMER)[0].dtype == BF16
    x32 = x.float()
    for f, p in zip(stft_fused._reference(x32, PRESET_512_128),
                    stft(x32, PRESET_512_128)):
        assert torch.equal(f, p)
    with pytest.raises(ValueError, match="no gradient"):
        stft_fused.stft_fused(x.clone().requires_grad_(), PRESET_512_128)
