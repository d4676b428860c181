"""se_tpu_torch's DCCRN and its complex_map decode branch against se_tpu's
on the CPU.

JAX variables at narrow widths (kernel_num 8-16, rnn_units 16; all 257
bins, six levels) are drawn from a numpy seed with every BN statistic and
affine off its default, carried into the port by `from_jax_variables`, and
the same inputs go through both: masking modes E, C and R, DCCRN_SNR's
crop, and the non-clstm branch. The port's state_dict also goes back
through se_tpu's reference loader. Tolerance 1e-4 absolute and relative
(the absolute one scaled to outputs below 1): the same fp32 math with sums
in another order.
"""

import jax
import numpy as np
import pytest
import torch

from se_tpu.eval.enhance import enhance_waveform as j_enhance_waveform
from se_tpu.models import dccrn as jdc
from se_tpu_torch.eval.enhance import enhance_waveform
from se_tpu_torch.models import dccrn as dc
from se_tpu_torch.models import get_model
from torch_kernel_inputs import fill_tree


def assert_close(got, want):
    """1e-4 relative, and 1e-4 absolute scaled down to the output's size
    where that is below 1 (random weights can give enhanced waveforms of
    ~1e-4, which a plain 1e-4 absolute would not test)."""
    want = np.asarray(want)
    scale = min(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


NARROW = dict(kernel_num=(8, 8, 16, 16, 16, 16), rnn_units=16)
CONFIGS = {"E": {}, "C": dict(masking_mode="C"), "R": dict(masking_mode="R"),
           "snr": dict(snr_variant=True), "no_clstm": dict(use_clstm=False)}


def _kw(config: str) -> dict:
    return {**NARROW, **CONFIGS[config]}


@pytest.fixture(scope="module")
def weights():
    """JAX variables of the clstm tree (shared by E, C, R and snr) and of
    the non-clstm tree, each with the port's state_dict."""
    out = {}
    for use_clstm in (True, False):
        shapes = jax.eval_shape(
            jdc.DCCRN(**NARROW, use_clstm=use_clstm).init,
            jax.random.PRNGKey(0), np.zeros((1, 4, 257, 2), np.float32))
        variables = fill_tree(shapes, seed=1 + use_clstm)
        out[use_clstm] = variables, dc.from_jax_variables(variables)
    return out


@pytest.fixture(scope="module")
def applies():
    """One jitted se_tpu apply per configuration, made once."""
    return {name: jax.jit(jdc.DCCRN(**_kw(name)).apply) for name in CONFIGS}


def _port(config: str, state_dict) -> dc.DCCRN:
    model = dc.DCCRN(**_kw(config), device="cpu")
    model.load_state_dict(state_dict)
    return model.eval()


def _variables(weights, config):
    return weights[CONFIGS[config].get("use_clstm", True)]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_dccrn_matches_jax(weights, applies, config):
    variables, sd = _variables(weights, config)
    spec = np.random.default_rng(7).standard_normal(
        (2, 13, 257, 2)).astype(np.float32)
    want = applies[config](variables, spec)
    with torch.no_grad():
        got = _port(config, sd)(torch.from_numpy(spec))
    assert got.shape == (2, 13, 257, 2)
    assert_close(got.numpy(), want)


def test_reference_state_dict_round_trip(weights, applies):
    """se_tpu's loader of reference checkpoints reads the port's
    state_dict into the tree it came from, and that tree gives the port's
    output."""
    variables, sd = weights[True]
    model = _port("E", sd)
    back = jdc.from_reference_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    want = dict(jax.tree_util.tree_leaves_with_path(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))
    spec = np.random.default_rng(8).standard_normal(
        (1, 9, 257, 2)).astype(np.float32)
    with torch.no_grad():
        mine = model(torch.from_numpy(spec)).numpy()
    assert_close(mine, np.asarray(applies["E"](back, spec)))


@pytest.mark.parametrize("compressed", [True, False])
def test_enhance_waveform_matches_jax(weights, compressed):
    """The complex_map branch: compressed complex spectrum in, the
    estimate's magnitude decompressed, iSTFT."""
    variables, sd = weights[True]
    wav = (np.random.default_rng(3).standard_normal((2, 2400))
           * 0.05).astype(np.float32)
    want = j_enhance_waveform("dccrn", variables, wav, compressed=compressed,
                              model=jdc.DCCRN(**NARROW))
    got = enhance_waveform("dccrn", _port("E", sd), wav,
                           compressed=compressed, device="cpu")
    assert got.shape == wav.shape and got.dtype == np.float32
    assert_close(got, want)


def test_registry_entry():
    entry = get_model("dccrn")
    assert entry.make is dc.DCCRN and entry.io_kind == "complex_map"
    assert (entry.stft.win_length, entry.stft.hop) == (512, 128)
    assert entry.from_jax_variables is dc.from_jax_variables
    assert entry.variants == ("snr",)


def test_unknown_masking_mode_raises():
    with pytest.raises(ValueError, match="masking"):
        dc.DCCRN(**NARROW, masking_mode="X", device="cpu")
