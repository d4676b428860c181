"""DeepXi's building blocks in se_tpu_torch against se_tpu's on the CPU:
flax's LayerNorm as DeepXi uses it (scale and bias each on or off; its
one-pass variance, also at an input whose mean is ~300 std), DeepXi's
frame, sequence and sequence-causal norms on a ragged batch, the 1-D conv
with flax's "SAME" padding, every statistical gain (MMSE-STSA across the
threshold where its Bessel terms overflow fp32), every XiMap type (the
fitted statistics, map, inverse, the round trip; the inverse near its
1e-7 clip) and the STDCT and its inverse. The same numpy inputs and
weights through both; tolerance 1e-4 absolute and relative, the absolute
one scaled to outputs below 1, unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as spsp
import torch
from flax import linen as fnn

from se_tpu.eval import gains as jgains
from se_tpu.models.deepxi import XiMap as JXiMap
from se_tpu.nn import norms as jnorms
from se_tpu.ops import stdct as jstdct
from se_tpu_torch.eval import gains
from se_tpu_torch.models.deepxi import XiMap
from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.nn import (
    Conv1d, FrameLayerNorm, OnePassLayerNorm, SeqCausalLayerNorm,
    SeqLayerNorm, deepxi_normalisation,
)
from se_tpu_torch.ops import stdct


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads would only contend with the
    other test workers' processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_close(got, want, tol=1e-4):
    want = np.asarray(want)
    scale = min(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale)


def _r(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


# --------------------------------------------------------------- the norms

def _layernorm_pair(rng, c, scale, bias):
    tree = {}
    if scale:
        tree["scale"] = _r(rng, c, scale=0.1, shift=1.0)
    if bias:
        tree["bias"] = _r(rng, c, scale=0.1)
    port = OnePassLayerNorm(c, scale=scale, bias=bias)
    sd = {}
    jt.put_flax_layernorm(sd, "n", tree)
    port.load_state_dict({k[2:]: v for k, v in sd.items()})
    jmod = fnn.LayerNorm(epsilon=1e-6, use_scale=scale, use_bias=bias)
    return jmod, tree, port


@pytest.mark.parametrize("scale,bias", [(True, True), (True, False),
                                        (False, False)])
def test_layernorm_matches_flax(rng, scale, bias):
    """MHANet / ResNet V1 (both), ResNetV2's first layer (scale only), the
    block units (neither): forward and input gradient."""
    jmod, tree, port = _layernorm_pair(rng, 24, scale, bias)
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, on in (("weight", scale), ("bias", bias)) if on]
    x = _r(rng, 2, 7, 24, scale=2.0, shift=0.5)
    ct = _r(rng, 2, 7, 24)
    want, vjp = jax.vjp(lambda v: jmod.apply({"params": tree}, v), x)
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    (got * torch.from_numpy(ct)).sum().backward()
    assert_close(got.detach().numpy(), want)
    assert_close(xt.grad.numpy(), vjp(ct)[0])


@pytest.mark.parametrize("scale,bias", [(True, True), (False, False)])
def test_layernorm_one_pass_variance_at_an_offset_input(rng, scale, bias):
    """Mean ~300 std: flax's E[x^2] - E[x]^2 cancels ~5 of fp32's 7 digits,
    so each package's fp32 output strays from the formula's fp64 value by
    its own summation order. What holds: in fp64 the port is flax's
    formula (1e-10), and the port's fp32 output lies no further from that
    fp64 value than twice flax's own fp32 distance plus 1e-4."""
    jmod, tree, port = _layernorm_pair(rng, 64, scale, bias)
    x = _r(rng, 3, 5, 64, shift=300.0)
    want = np.asarray(jmod.apply({"params": tree}, x))
    with jax.enable_x64(True):
        tree64 = jax.tree.map(lambda a: np.asarray(a, np.float64), tree)
        want64 = np.asarray(jmod.apply({"params": tree64},
                                       x.astype(np.float64)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        got64 = port.double()(torch.from_numpy(x).double()).numpy()
    np.testing.assert_allclose(got64, want64, rtol=1e-10, atol=1e-10)
    theirs = float(np.abs(want - want64).max())
    mine = float(np.abs(got - want64).max())
    assert theirs > 1e-5  # the cancellation is real at this offset
    assert mine <= 2 * theirs + 1e-4, (mine, theirs)


def _seq_norm_inputs(rng):
    x = _r(rng, 3, 11, 7, scale=1.5, shift=0.3)
    seq_len = np.array([11, 7, 4], np.int32)
    return x, seq_len


@pytest.mark.parametrize("kind", ["SeqCausalLayerNorm", "SeqLayerNorm",
                                  "FrameLayerNorm"])
@pytest.mark.parametrize("centre,scale", [(True, True), (False, False)])
def test_deepxi_norms_match_se_tpu(rng, kind, centre, scale):
    """On a ragged batch (seq_len 11, 7, 4: the outputs past it zero),
    gamma and beta off their defaults where they exist."""
    x, seq_len = _seq_norm_inputs(rng)
    f = x.shape[-1]
    jmod = jnorms.deepxi_normalisation(kind, centre=centre, scale=scale)
    port = deepxi_normalisation(kind, f, centre=centre, scale=scale)
    tree = {}
    if scale:
        tree["gamma"] = _r(rng, f, scale=0.1, shift=1.0)
    if centre:
        tree["beta"] = _r(rng, f, scale=0.1)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()})
    args = (x,) if kind == "FrameLayerNorm" else (x, seq_len)
    want = np.asarray(jmod.apply({"params": tree}, *args))
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args)).numpy()
    assert_close(got, want)
    if kind != "FrameLayerNorm":
        assert not got[1, 7:].any() and not got[2, 4:].any()


def test_seq_causal_norm_is_causal(rng):
    """Frame t's output reads frames up to t only."""
    x, seq_len = _seq_norm_inputs(rng)
    port = SeqCausalLayerNorm(x.shape[-1])
    y = x.copy()
    y[:, 6:] += 50.0
    with torch.no_grad():
        a = port(torch.from_numpy(x), torch.from_numpy(seq_len))
        b = port(torch.from_numpy(y), torch.from_numpy(seq_len))
    torch.testing.assert_close(a[:, :6], b[:, :6], rtol=0, atol=0)


def test_normalisation_dispatcher():
    assert isinstance(deepxi_normalisation("SeqLayerNorm", 4), SeqLayerNorm)
    assert isinstance(deepxi_normalisation("FrameLayerNorm", 4),
                      FrameLayerNorm)
    for bad in ("unnormalised", "NoSuchNorm"):
        with pytest.raises(ValueError):
            deepxi_normalisation(bad, 4)


@pytest.mark.parametrize("k,dilation", [(1, 1), (3, 1), (3, 4), (7, 8)])
def test_conv1d_same_padding_matches_flax(rng, k, dilation):
    """RDLNet's non-causal units: flax nn.Conv(padding="SAME") with a
    kernel dilation."""
    cin, cout = 6, 5
    tree = {"kernel": _r(rng, k, cin, cout, scale=(k * cin) ** -0.5),
            "bias": _r(rng, cout, scale=0.1)}
    jmod = fnn.Conv(cout, (k,), kernel_dilation=(dilation,), padding="SAME")
    port = Conv1d(cin, cout, k, dilation, padding="same")
    sd = {}
    jt.put_conv1d(sd, "c", tree)
    port.load_state_dict({key[2:]: v for key, v in sd.items()})
    x = _r(rng, 2, 21, cin)
    want = np.asarray(jmod.apply({"params": tree}, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert_close(got, want)
    with pytest.raises(ValueError, match="padding"):
        Conv1d(cin, cout, k, padding="valid")


# --------------------------------------------------------------- the gains

def _xi_gamma(rng, n=2000):
    xi = np.abs(rng.standard_normal(n)).astype(np.float32) * 5 + 1e-3
    gamma = (xi + np.abs(rng.standard_normal(n)) * 2).astype(np.float32)
    return xi, gamma


@pytest.mark.parametrize("gtype", ["mmse-lsa", "mmse-stsa", "wf", "srwf",
                                   "cwf", "irm", "ibm", "deepmmse", "dgwf"])
def test_gains_match_se_tpu(rng, gtype):
    xi, gamma = _xi_gamma(rng)
    cdm = rng.random(xi.shape) > 0.5
    want = np.asarray(jgains.gfunc(jnp.asarray(xi), jnp.asarray(gamma),
                                   gtype, cdm=jnp.asarray(cdm)))
    got = gains.gfunc(torch.from_numpy(xi), torch.from_numpy(gamma), gtype,
                      cdm=torch.from_numpy(cdm)).numpy()
    assert got.dtype == np.float32
    assert_close(got, want)
    with pytest.raises(ValueError, match="gain"):
        gains.gfunc(torch.from_numpy(xi), None, "no-such-gain")


def test_exp1_is_se_tpus_approximation():
    """se_tpu's A&S E1, copied: equal to it to fp32 round-off, and within
    its published error of scipy's exact E1 (2e-7 absolute below 1, 5e-5
    relative above)."""
    x = np.concatenate([np.geomspace(1e-6, 1.0, 300),
                        np.linspace(1.0, 60.0, 300)]).astype(np.float32)
    got = gains.exp1(torch.from_numpy(x)).numpy()
    assert_close(got, jgains.exp1(jnp.asarray(x)), tol=1e-6)
    exact = spsp.exp1(x.astype(np.float64))
    small = x <= 1.0
    assert np.abs(got[small] - exact[small]).max() < 2e-6
    assert (np.abs(got[~small] - exact[~small]) / exact[~small]).max() < 6e-5


def test_mmse_stsa_across_the_bessel_overflow():
    """nu from 120 to 200 (gamma = xi + 1, so nu = xi). i0 / i1 overflow
    fp32 at nu / 2 = 88.72 in both packages, and both fall back to the
    Wiener gain from the same nu (172.05, where the product turns
    inf or NaN). Below it they agree to 1e-4, but in a band of nu ~
    169.3-172.05: there se_tpu's leading product sqrt(pi) / 2 sqrt(nu) /
    gamma exp(-nu / 2) falls below fp32's smallest normal and XLA's CPU
    flushes it to zero, so its gain is 0; torch keeps the subnormal and
    its gain is the Bessel form's, within 0.2% of scipy's in float64 and
    of the Wiener gain."""
    xi = np.linspace(120.0, 200.0, 80001).astype(np.float32)
    gamma = xi + 1.0
    want = np.asarray(jgains.mmse_stsa(jnp.asarray(xi), jnp.asarray(gamma)))
    got = gains.mmse_stsa(torch.from_numpy(xi), torch.from_numpy(gamma))
    got = got.numpy()
    wiener = xi / (1.0 + xi)
    assert np.isfinite(got).all()
    fell_back = got == wiener
    np.testing.assert_array_equal(fell_back, want == wiener)
    assert 172.0 < xi[fell_back].min() < 172.1
    flushed = want == 0.0
    assert 169.2 < xi[flushed].min() and xi[flushed].max() < 172.1
    agree = ~flushed
    assert_close(got[agree], want[agree])
    nu = xi[flushed].astype(np.float64)
    exact = (np.sqrt(np.pi) / 2 * np.sqrt(nu) / (nu + 1) * np.exp(-nu / 2)
             * ((1 + nu) * spsp.i0(nu / 2) + nu * spsp.i1(nu / 2)))
    np.testing.assert_allclose(got[flushed], exact, rtol=2e-3)
    np.testing.assert_allclose(got[flushed], wiener[flushed], rtol=2e-3)


# --------------------------------------------------------------- the maps

MAPS = [
    ("DBNormalCDF", None), ("NormalCDF", None), ("SquareDBNormalCDF", None),
    ("Standardise", None), ("DBStandardise", None),
    ("MinMaxScaling", None), ("DBMinMaxScaling", None),
    ("DBTruncatedLaplaceCDF", (0.0, -40.0, 40.0)),
    ("DBLaplaceCDF", 0.0), ("UniformCDF", (0.0, 20.0)),
    ("Logistic", (0.5, 2.0)), ("DBLogistic", (0.2, 5.0)),
    ("Clip", (0.01, 30.0)), ("DBClip", (0.01, 30.0)),
    ("Square", None), ("DB", None), ("Linear", None),
]


def _xi_sample(rng, n=400, f=33):
    db = rng.standard_normal((n, f)) * 10.0 + 3.0
    return np.power(10.0, db / 10.0).astype(np.float32)


@pytest.mark.parametrize("map_type,params", MAPS,
                         ids=[m for m, _ in MAPS])
def test_xi_map_matches_se_tpu(rng, map_type, params):
    """The fitted statistics (numpy in both), `map` and `inverse` against
    se_tpu's on the same values, and the port's round trip where the map
    does not saturate in fp32 (2e-3 relative; 1e-5 of the sample's
    largest value absolute, where a CDF of the linear xi resolves small
    values coarsely)."""
    sample = _xi_sample(rng)
    jm, pm = JXiMap(map_type, params=params), XiMap(map_type, params=params)
    jm.fit(sample)
    pm.fit(sample)
    for key in ("mu", "sigma", "vmin", "vmax", "b"):
        a, b = getattr(pm, key), getattr(jm, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    x = sample[:32]
    got = pm.map(torch.from_numpy(x))
    assert_close(got.numpy(), jm.map(jnp.asarray(x)))
    x_bar = got.numpy()
    back = pm.inverse(torch.from_numpy(x_bar)).numpy()
    assert_close(back, jm.inverse(jnp.asarray(x_bar)))
    if "CDF" in map_type or "Logistic" in map_type:
        inner = (x_bar > 0.02) & (x_bar < 0.98)
    elif "Clip" in map_type or "MinMax" in map_type:
        inner = (x > params[0] * 1.01) & (x < params[1] * 0.99) \
            if params else (x_bar > 0.0) & (x_bar < 1.0)
    else:
        inner = np.ones_like(x, bool)
    assert inner.mean() > 0.3
    np.testing.assert_allclose(back[inner], x[inner], rtol=2e-3,
                               atol=1e-5 * float(np.abs(x).max()))


def test_xi_map_inverse_near_the_clip():
    """DBNormalCDF's inverse at x_bar 0 and 1 (a saturated sigmoid), at
    and around the 1e-7 clip: finite, and se_tpu's to 1e-4 relative."""
    sample = _xi_sample(np.random.default_rng(3), f=8)
    jm, pm = JXiMap("DBNormalCDF"), XiMap("DBNormalCDF")
    jm.fit(sample)
    pm.fit(sample)
    col = np.array([0.0, 1e-9, 5e-8, 1e-7, 1.5e-7, 3e-7, 1e-3, 0.5,
                    1 - 3e-7, 1 - 1e-7, 1 - 5e-8, 1.0], np.float32)
    x_bar = np.repeat(col[:, None], 8, axis=1)
    got = pm.inverse(torch.from_numpy(x_bar)).numpy()
    want = np.asarray(jm.inverse(jnp.asarray(x_bar)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_array_equal(got[0], got[3])  # clipped alike
    np.testing.assert_array_equal(got[-1], got[-3])


def test_xi_map_rejects_unknown_types():
    with pytest.raises(ValueError, match="map_type"):
        XiMap("NoSuchMap").map(torch.ones(2))
    with pytest.raises(ValueError, match="map_type"):
        XiMap("NoSuchMap").inverse(torch.ones(2))


# --------------------------------------------------------------- the STDCT

@pytest.mark.parametrize("window,pad_end,k", [
    ("hann", False, None), ("hamming", True, 512), ("hamming", True, 640),
    (None, False, None)])
def test_stdct_matches_se_tpu(rng, window, pad_end, k):
    x = _r(rng, 2, 4000, scale=0.3)
    want = np.asarray(jstdct.stdct(jnp.asarray(x), 512, 256, k,
                                   window=window, pad_end=pad_end))
    got = stdct.stdct(torch.from_numpy(x), 512, 256, k, window=window,
                      pad_end=pad_end).numpy()
    assert got.shape == want.shape
    assert_close(got, want)
    c = _r(rng, *want.shape, scale=2.0)
    want_inv = np.asarray(jstdct.inverse_stdct(jnp.asarray(c), 512, 256, k,
                                               window=window, length=3900))
    got_inv = stdct.inverse_stdct(torch.from_numpy(c), 512, 256, k,
                                  window=window, length=3900).numpy()
    assert got_inv.shape == want_inv.shape  # at most `length`
    assert want_inv.shape[1] == (3900 if pad_end else 3840)
    assert_close(got_inv, want_inv)


def test_stdct_round_trip():
    """scipy's norm=None pair: idct(dct(x)) = 2N x a frame; a rectangular
    window at hop = N (no overlap) gives the waveform back times 2N."""
    x = np.random.default_rng(5).standard_normal((1, 2048)).astype(
        np.float32)
    c = stdct.stdct(torch.from_numpy(x), 256, 256, window=None)
    back = stdct.inverse_stdct(c, 256, 256, window=None).numpy()
    np.testing.assert_allclose(back / 512.0, x, rtol=1e-4, atol=1e-5)
