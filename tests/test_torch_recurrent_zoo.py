"""se_tpu_torch's LSTM, CRN, GCRN and DPCRN and the mag_mask, complex_map
and complex_mask decode branches against se_tpu's on the CPU.

CRN, GCRN and DPCRN have fixed widths and run at their published widths
on short inputs; LSTMNet runs at hidden 48. JAX variables are drawn from a
numpy seed with every BN statistic and affine off its default, carried into
the port by `from_jax_variables`, and the same inputs go through both; the
port's state_dict also goes back through se_tpu's reference loader.
Tolerance 1e-4 absolute and relative (the absolute one scaled to outputs
below 1): the same fp32 math with sums in another order.
"""

import jax
import numpy as np
import pytest
import torch

from se_tpu.eval.enhance import enhance_waveform as j_enhance_waveform
from se_tpu.models import crn as jcrn
from se_tpu.models import dpcrn as jdpcrn
from se_tpu.models import gcrn as jgcrn
from se_tpu.models import lstm as jlstm
from se_tpu_torch.eval.enhance import enhance_waveform
from se_tpu_torch.models import crn, dpcrn, gcrn, get_model, lstm
from torch_kernel_inputs import fill_tree


def assert_close(got, want):
    """1e-4 relative, and 1e-4 absolute scaled down to the output's size
    where that is below 1 (random weights can give enhanced waveforms of
    ~1e-4, which a plain 1e-4 absolute would not test)."""
    want = np.asarray(want)
    scale = min(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


# name: (se_tpu module, its class, port module, port class, kwargs, complex
# input)
FAMILIES = {
    "lstm": (jlstm, jlstm.LSTMNet, lstm, lstm.LSTMNet, dict(hidden=48),
             False),
    "crn": (jcrn, jcrn.CRN, crn, crn.CRN, {}, False),
    "gcrn": (jgcrn, jgcrn.GCRN, gcrn, gcrn.GCRN, {}, True),
    "dpcrn": (jdpcrn, jdpcrn.DPCRN, dpcrn, dpcrn.DPCRN, {}, True),
}
IO_KINDS = {"lstm": "mag_mask", "crn": "mag_mask", "gcrn": "complex_map",
            "dpcrn": "complex_mask"}


def _input(name: str, b: int, t: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if FAMILIES[name][5]:
        return rng.standard_normal((b, t, 161, 2)).astype(np.float32)
    return np.abs(rng.standard_normal((b, t, 161))).astype(np.float32)


@pytest.fixture(scope="module")
def zoo():
    """name -> (JAX variables, port state_dict, jitted se_tpu apply)."""
    out = {}
    for seed, (name, (_, jcls, port, _, kw, _)) in enumerate(
            sorted(FAMILIES.items())):
        shapes = jax.eval_shape(jcls(**kw).init, jax.random.PRNGKey(0),
                                _input(name, 1, 4, 0))
        variables = fill_tree(shapes, seed)
        out[name] = (variables, port.from_jax_variables(variables),
                     jax.jit(jcls(**kw).apply))
    return out


def _port(name: str, state_dict):
    _, _, _, pcls, kw, _ = FAMILIES[name]
    model = pcls(**kw, device="cpu")
    model.load_state_dict(state_dict)
    return model.eval()


@pytest.mark.parametrize("b,t", [(1, 16), (2, 7)])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_forward_matches_jax(zoo, name, b, t):
    variables, sd, apply = zoo[name]
    x = _input(name, b, t, seed=10 + t)
    want = np.asarray(apply(variables, x))
    with torch.no_grad():
        got = _port(name, sd)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert_close(got, want)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_reference_state_dict_round_trip(zoo, name):
    """se_tpu's loader of reference checkpoints reads the port's
    state_dict into the tree it came from, and that tree gives the port's
    output."""
    variables, sd, apply = zoo[name]
    model = _port(name, sd)
    back = FAMILIES[name][0].from_reference_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    want = dict(jax.tree_util.tree_leaves_with_path(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))
    x = _input(name, 1, 6, seed=3)
    with torch.no_grad():
        mine = model(torch.from_numpy(x)).numpy()
    assert_close(mine, np.asarray(apply(back, x)))


@pytest.mark.parametrize("compressed", [True, False])
@pytest.mark.parametrize("name", ["lstm", "gcrn", "dpcrn"])
def test_enhance_waveform_matches_jax(zoo, name, compressed):
    """mag_mask (LSTMNet), complex_map (GCRN), complex_mask (DPCRN)."""
    variables, sd, _ = zoo[name]
    _, jcls, _, _, kw, _ = FAMILIES[name]
    wav = (np.random.default_rng(4).standard_normal((2, 2000))
           * 0.05).astype(np.float32)
    want = j_enhance_waveform(name, variables, wav, compressed=compressed,
                              model=jcls(**kw))
    got = enhance_waveform(name, _port(name, sd), wav, compressed=compressed,
                           device="cpu")
    assert got.shape == wav.shape and got.dtype == np.float32
    assert_close(got, want)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_registry_entry(name):
    entry = get_model(name)
    port = FAMILIES[name][2]
    assert entry.make is FAMILIES[name][3]
    assert entry.io_kind == IO_KINDS[name]
    assert (entry.stft.win_length, entry.stft.hop) == (320, 160)
    assert entry.from_jax_variables is port.from_jax_variables
