"""The TCM families' layers in se_tpu_torch.nn against their se_tpu (Flax)
counterparts on the CPU: per-channel PReLU, the instance norms, the
cumulative layer norms (also at an input whose mean is ~30 std, where the
one-pass variance cancels), the 1x1 and causal dilated 1-D convs and
ShareSepConv; the same numpy weights and inputs through both, the weights
carried by the port's jax_tree helpers. Tolerance 1e-4 absolute and
relative, the absolute one scaled to outputs below 1 (as the family
tests); the forward and the input gradient both. The cumulative norms at
the offset input are held to the fp64 value of se_tpu's formula instead
(see that test)."""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from se_tpu.nn.activations import PReLU as JPReLU
from se_tpu.nn.conv import CausalConv1d as JCausalConv1d
from se_tpu.nn.conv import ShareSepConv as JShareSepConv
from se_tpu.nn.norms import CumulativeLayerNorm1d as JCLN1d
from se_tpu.nn.norms import CumulativeLayerNorm2d as JCLN2d
from se_tpu.nn.norms import InstanceNorm1d as JIN1d
from se_tpu.nn.norms import InstanceNorm2d as JIN2d
from se_tpu.nn import norms as j_norms
from se_tpu.nn.norms import _cumulative_stats as j_cumulative_stats
from se_tpu_torch.models import get_model
from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.nn import (
    Conv1d, CumulativeLayerNorm1d, CumulativeLayerNorm2d, InstanceNorm1d,
    InstanceNorm2d, PReLU, ShareSepConv,
)
from se_tpu_torch.nn.norms import cumulative_stats
from se_tpu_torch.train.trainer import TrainConfig, make_train_step
from test_torch_train import _batch, _jax_step, _jax_variables

j_stft = importlib.import_module("se_tpu.ops.stft")  # the package exports
# a function of that name


def assert_close(got, want):
    want = np.asarray(want)
    scale = min(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def _r(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _both(jmod, params, port, x):
    """(port out, se_tpu out, port dx, se_tpu dx) for the sum of
    out * a fixed random cotangent."""
    ct = _r(np.random.default_rng(7), *np.asarray(
        jmod.apply({"params": params}, x)).shape)

    def jloss(v):
        return (jmod.apply({"params": params}, v) * ct).sum()

    want, jgrad = jmod.apply({"params": params}, x), jax.grad(jloss)(x)
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    (got * torch.from_numpy(ct)).sum().backward()
    return got.detach().numpy(), np.asarray(want), xt.grad.numpy(), \
        np.asarray(jgrad)


def _check(jmod, params, port, x):
    got, want, dx, jdx = _both(jmod, params, port, x)
    assert got.shape == want.shape
    assert_close(got, want)
    assert_close(dx, jdx)


def test_prelu_per_channel(rng):
    a = _r(rng, 12, scale=0.1, shift=0.25)
    act = PReLU(12)
    assert act.weight.shape == (12,)
    sd = {}
    jt.put_channel_prelu(sd, "p", {"weight": a})
    act.load_state_dict({"weight": sd["p.weight"]})
    _check(JPReLU(12), {"weight": a}, act, _r(rng, 2, 5, 12))


def test_prelu_scalar_keeps_its_shape():
    assert PReLU().weight.shape == (1,)
    assert float(PReLU().weight.detach()) == 0.25


def _norm_pair(kind, c, rng):
    """(se_tpu module, its tree, the port's module with that tree, the
    reference's trailing axes)."""
    w, b = _r(rng, c, scale=0.1, shift=1.0), _r(rng, c, scale=0.1)
    trailing = 2 if kind.endswith("2d") else 1
    if kind.startswith("in"):
        jmod = (JIN2d if trailing == 2 else JIN1d)(affine=True)
        tree = {"scale": w, "bias": b}
        port = (InstanceNorm2d if trailing == 2 else InstanceNorm1d)(c)
    else:
        jmod = (JCLN2d if trailing == 2 else JCLN1d)(affine=True)
        tree = {"gain": w, "bias": b}
        port = (CumulativeLayerNorm2d if trailing == 2
                else CumulativeLayerNorm1d)(c)
    sd = {}
    jt.put_tcm_norm(sd, "n", tree, trailing)
    port.load_state_dict({k[2:]: v for k, v in sd.items()})
    return jmod, tree, port, trailing


def _norm_input(kind, rng, shift):
    shape = (2, 9, 7, 16) if kind.endswith("2d") else (2, 9, 16)
    return _r(rng, *shape, shift=shift)


@pytest.mark.parametrize("kind", ["in2d", "in1d", "cln2d", "cln1d"])
def test_norms_match_se_tpu(rng, kind):
    jmod, tree, port, _ = _norm_pair(kind, 16, rng)
    _check(jmod, tree, port, _norm_input(kind, rng, 0.0))


@pytest.mark.parametrize("kind", ["in2d", "in1d"])
def test_instance_norms_at_an_offset_input(rng, kind):
    """Mean ~30 std: the instance norms' two-pass variance keeps 1e-4."""
    jmod, tree, port, _ = _norm_pair(kind, 16, rng)
    _check(jmod, tree, port, _norm_input(kind, rng, 30.0))


@pytest.mark.parametrize("kind", ["cln2d", "cln1d"])
def test_cumulative_norms_at_an_offset_input(rng, kind):
    """Mean ~30 std, where se_tpu's one-pass variance (cum_pow - 2 cum_mean
    cum_sum) / cnt + cum_mean^2 cancels ~3 of fp32's 7 digits: the two
    packages' fp32 outputs stray ~3e-4 (of outputs ~3) from the formula's
    fp64 value, each by its own summation order, so they cannot agree to
    1e-4 with each other. What holds: the port's statistics are se_tpu's
    formula (both in fp64, to 1e-10 relative), and the port's fp32 output
    and input gradient lie no further from that fp64 value than twice
    se_tpu's own fp32 distance plus the 1e-4 tolerance."""
    jmod, tree, port, _ = _norm_pair(kind, 16, rng)
    x = _norm_input(kind, rng, 30.0)
    axes = tuple(range(2, x.ndim))
    with jax.enable_x64(True):
        jm, js = j_cumulative_stats(jax.numpy.asarray(x, np.float64), axes,
                                    1, 1e-5)
        jm, js = np.asarray(jm), np.asarray(js)
    pm, ps = cumulative_stats(torch.from_numpy(x).double(), 1e-5)
    np.testing.assert_allclose(pm.numpy(), jm, rtol=1e-10)
    np.testing.assert_allclose(ps.numpy(), js, rtol=1e-10)

    got, want, dx, jdx = _both(jmod, tree, port, x)
    xt = torch.from_numpy(x).double().requires_grad_()
    exact = port.double()(xt)
    ct = _r(np.random.default_rng(7), *got.shape).astype(np.float64)
    (exact * torch.from_numpy(ct)).sum().backward()
    for mine, theirs, ref in ((got, want, exact.detach().numpy()),
                              (dx, jdx, xt.grad.numpy())):
        tol = 1e-4 * min(1.0, float(np.abs(ref).max()))
        assert np.abs(mine - ref).max() <= 2 * np.abs(theirs - ref).max() \
            + tol


def test_cumulative_norm_parameter_shapes():
    assert CumulativeLayerNorm2d(8).gain.shape == (1, 8, 1, 1)
    assert CumulativeLayerNorm1d(8).bias.shape == (1, 8, 1)
    assert InstanceNorm2d(8).weight.shape == (8,)
    assert not list(CumulativeLayerNorm2d(8).buffers())


def test_cumulative_stats_are_causal(rng):
    """Frame t's statistics read frames up to t only."""
    x = torch.from_numpy(_r(rng, 2, 10, 6, 4))
    mean, std = cumulative_stats(x, 1e-5)
    y = x.clone()
    y[:, 6:] += 100.0
    mean2, std2 = cumulative_stats(y, 1e-5)
    torch.testing.assert_close(mean[:, :6], mean2[:, :6], rtol=0, atol=0)
    torch.testing.assert_close(std[:, :6], std2[:, :6], rtol=0, atol=0)
    assert not torch.allclose(mean[:, 6:], mean2[:, 6:])


@pytest.mark.parametrize("k,dilation,left_pad,bias", [
    (1, 1, None, False), (1, 1, None, True), (5, 4, 16, False),
    (3, 9, None, True), (3, 2, 4, False)])
def test_conv1d_matches_se_tpu(rng, k, dilation, left_pad, bias):
    """k = 1: se_tpu's nn.Dense (with or without bias); otherwise its
    CausalConv1d, with the left pad CTSNet (4d) or G2Net (2d) passes it
    where one is given: (k - 1) d, the port's only pad."""
    cin, cout = 12, 10
    kernel = _r(rng, k, cin, cout, scale=(k * cin) ** -0.5)
    tree = {"kernel": kernel[0] if k == 1 else kernel}
    if bias:
        tree["bias"] = _r(rng, cout, scale=0.1)
    if k == 1:
        jmod = fnn.Dense(cout, use_bias=bias)
    else:
        jmod = JCausalConv1d(cout, k, dilation=dilation, left_pad=left_pad,
                             use_bias=bias)
    port = Conv1d(cin, cout, k, dilation=dilation, bias=bias)
    sd = {}
    jt.put_conv1d(sd, "c", tree)
    assert sd["c.weight"].shape == (cout, cin, k)
    port.load_state_dict({k_[2:]: v for k_, v in sd.items()})
    _check(jmod, tree, port, _r(rng, 2, 23, cin))


@pytest.mark.parametrize("k", [1, 3, 9, 63])
def test_share_sep_conv_matches_se_tpu(rng, k):
    """CTSNet's 2d - 1 at d = 1, 2, 5 and 32: one kernel for every channel,
    causal. Its init is a one at (k - 1) // 2 as se_tpu's."""
    port = ShareSepConv(k)
    init = np.zeros(k, np.float32)
    init[(k - 1) // 2] = 1.0
    np.testing.assert_array_equal(port.weight.detach().numpy()[0, 0], init)
    tree = {"weight": _r(rng, k, scale=0.3)}
    sd = {}
    jt.put_share_sep(sd, "s", tree)
    port.load_state_dict({"weight": sd["s.weight"]})
    _check(JShareSepConv(k), tree, port, _r(rng, 2, 70, 8))


# ------------------------------------ shared with the TCM family tests

class _Fp64Numpy:
    """jax.numpy, but `float32` is float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def se_tpu_fp64(monkeypatch):
    """se_tpu in fp64 throughout: jax's x64 mode, and `jnp.float32` read as
    float64, for the duration only, by the two modules that ask for fp32
    whatever their input: the norms (their statistics) and the STFT (its
    matmuls' accumulation). Feed it fp64 arrays (`to64`)."""
    with monkeypatch.context() as mp, jax.enable_x64(True):
        for module in (j_norms, j_stft):
            mp.setattr(module, "jnp", _Fp64Numpy())
        yield


def to64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def assert_as_se_tpu(got, want, fp64, tol=1e-4):
    """The port's fp32 result `got` against se_tpu's fp32 `want` within
    `tol` absolute and relative (the absolute one scaled to outputs below
    1). Where that fails, `fp64()` gives (se_tpu's fp64 result, the port's
    or None): where se_tpu's own fp32 evaluation strays from its fp64
    value (deep nets amplify round-off; the one-pass variance cancels),
    the port's may stray twice as far plus `tol`, no more; the port's
    fp64 result must equal se_tpu's to 1e-9 of the output's scale."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = min(1.0, float(np.abs(want).max()))
    if np.all(np.abs(got - want) <= tol * scale + tol * np.abs(want)):
        return
    want64, got64 = fp64()
    if got64 is not None:
        np.testing.assert_allclose(got64, want64, rtol=1e-9,
                                   atol=1e-9 * scale)
    theirs = float(np.abs(want - want64).max())
    mine = float(np.abs(got - want64).max())
    assert mine <= 2 * theirs + tol * scale, (mine, theirs)


def _port_keyed(name: str, grads: dict) -> dict:
    """se_tpu's gradient tree (fp32 or fp64) -> float64 numpy by the port's
    parameter names. from_jax_variables rounds to fp32, so an fp64 tree
    goes through it as two fp32 parts, hi + lo (its maps move and reshape
    entries, never add them)."""
    put = get_model(name).from_jax_variables
    hi = jax.tree.map(lambda a: np.asarray(a, np.float32), grads)
    lo = jax.tree.map(lambda a, h: np.asarray(np.asarray(a, np.float64) - h,
                                              np.float32), grads, hi)
    hi, lo = put({"params": hi}), put({"params": lo})
    return {k: hi[k].double().numpy() + lo[k].double().numpy() for k in hi}


def _port_step_in(name: str, variables: dict, batch, dtype):
    model, init_fn, step_fn, _ = make_train_step(TrainConfig(model=name),
                                                 device="cpu")
    model.to(dtype)
    state = init_fn(0)
    model.load_state_dict(get_model(name).from_jax_variables(variables))
    mix, clean, frames = batch
    state, loss = step_fn(state, {
        "mix": torch.from_numpy(mix).to(dtype),
        "clean": torch.from_numpy(clean).to(dtype),
        "frames": torch.from_numpy(frames.astype(np.int64))})
    return loss.item(), {k: p.grad.double().numpy()
                         for k, p in model.named_parameters()}


def check_train_step(monkeypatch, name: str, seed: int) -> None:
    """One train step of family `name` at its published widths, on the
    batch of tests/test_torch_train.py (B = 2, 16 frames), from se_tpu's
    variables drawn by fill_tree: the loss within 1e-5 relative and every
    gradient within 1e-5 of the step's largest entry of se_tpu's. Where a
    gradient fails that, both steps run again in fp64: the losses within
    1e-9 relative and every gradient within 1e-9 of the step's largest
    (the same function), and the port's fp32 gradient no further from the
    fp64 one than twice se_tpu's plus 1e-5 of the largest."""
    variables = _jax_variables(name, {}, seed)
    batch = _batch()
    jloss, jgrads, _ = _jax_step(monkeypatch, name, {}, variables, batch)
    want = _port_keyed(name, jgrads)
    loss, grads = _port_step_in(name, variables, batch, torch.float32)
    assert grads.keys() == want.keys()
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    gmax = max(float(np.abs(v).max()) for v in want.values())
    tol = 1e-5 * gmax
    strays = [k for k, g in grads.items()
              if float(np.abs(g - want[k]).max()) > tol]
    if not strays:
        return
    mix, clean, frames = batch
    with se_tpu_fp64(monkeypatch):
        jloss64, jgrads64, _ = _jax_step(monkeypatch, name, {},
                                         to64(variables),
                                         (to64(mix), to64(clean), frames))
    want64 = _port_keyed(name, jgrads64)
    loss64, grads64 = _port_step_in(name, variables, batch, torch.float64)
    np.testing.assert_allclose(loss64, jloss64, rtol=1e-9)
    for key, g64 in grads64.items():
        np.testing.assert_allclose(g64, want64[key], rtol=0,
                                   atol=1e-9 * gmax, err_msg=key)
    for key in strays:
        theirs = float(np.abs(want[key] - want64[key]).max())
        mine = float(np.abs(grads[key] - want64[key]).max())
        assert mine <= 2 * theirs + tol, (key, mine, theirs, tol)
