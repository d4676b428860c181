"""se_tpu_torch's CTSNet against se_tpu's on the CPU, at its published widths
on T = 9-16 frames (F = 161: the heads are Linear(161)).

JAX variables are drawn from a numpy seed (`fill_tree`: every norm's gain
or scale, every bias and PReLU slope off its default), carried into the
port by `from_jax_variables`; the same inputs go through both. Forward in
both norm variants ("cln", "in"); `enhance_waveform` compressed and not;
the port's state_dict split at `step1.` / `step2.` back through se_tpu's
`from_reference_state_dicts` to the same tree; one train step (cln) against
se_tpu's `make_train_step`. The model recomputes the magnitude and phase
(sqrt, atan2) of its input, whose gradients are undefined at a zero
magnitude: the train step's spectra come from random normal waveforms.

Tolerances (`assert_as_se_tpu`, `check_train_step` in
test_torch_tcm_layers.py): the forward in fp64 on both sides equal to 1e-9
(se_tpu's norms' statistics and STFT moved to fp64 for it); in fp32 1e-4
absolute and relative, the absolute one scaled to outputs below 1, or,
where se_tpu's own fp32 output strays past that from its fp64 one, no
further from fp64 than twice se_tpu. The same for `enhance_waveform`
against se_tpu's with its network in fp64, and for the train step at 1e-5
of its largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_tpu.eval.enhance import enhance_waveform as j_enhance_waveform
from se_tpu.models import ctsnet as jctsnet
from se_tpu_torch.eval.enhance import enhance_waveform
from se_tpu_torch.models import ctsnet, get_model
from test_torch_tcm_layers import (
    assert_as_se_tpu, check_train_step, se_tpu_fp64, to64,
)
from torch_kernel_inputs import fill_tree

NAME, JMODULE, PORT = "ctsnet", jctsnet, ctsnet
JCLS, PCLS = jctsnet.CTSNet, ctsnet.CTSNet
VARIANTS = ("cln", "in")
SEED = 20


def _out_shape(b, t):
    return (b, t, 161, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads would only contend with the
    other test workers' processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(b: int, t: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, t, 161, 2)).astype(np.float32)


def _setup(seed: int, **kw):
    """(JAX variables, port state_dict, jitted se_tpu apply)."""
    model = JCLS(**kw)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            _spec(1, 4, 0))
    variables = fill_tree(shapes, seed)
    return variables, PORT.from_jax_variables(variables), jax.jit(model.apply)


@pytest.fixture(scope="module")
def variants():
    """norm -> _setup's triple, once a variant."""
    return {norm: _setup(SEED + i, norm=norm)
            for i, norm in enumerate(VARIANTS)}


def _port(state_dict, **kw):
    model = PCLS(**kw, device="cpu")
    model.load_state_dict(state_dict)
    return model


def _fp64(monkeypatch, setup, x, **kw):
    """(se_tpu's output in fp64, the port's)."""
    variables, sd, apply = setup
    with se_tpu_fp64(monkeypatch):
        want64 = np.asarray(apply(to64(variables), x.astype(np.float64)))
    with torch.no_grad():
        got64 = _port(sd, **kw).double()(torch.from_numpy(x).double())
    return want64, got64.numpy()


def _forward_check(monkeypatch, setup, x, **kw):
    variables, sd, apply = setup
    want = np.asarray(apply(variables, x))
    with torch.no_grad():
        got = _port(sd, **kw)(torch.from_numpy(x)).numpy()
    assert_as_se_tpu(got, want, lambda: _fp64(monkeypatch, setup, x, **kw))
    return got


@pytest.mark.parametrize("b,t", [(1, 16), (2, 9)])
@pytest.mark.parametrize("norm", VARIANTS)
def test_forward_matches_jax(monkeypatch, variants, norm, b, t):
    got = _forward_check(monkeypatch, variants[norm], _spec(b, t, seed=t),
                         norm=norm)
    assert got.shape == _out_shape(b, t)


@pytest.mark.parametrize("norm", VARIANTS)
def test_forward_in_fp64_is_se_tpus(monkeypatch, variants, norm):
    """Both in fp64 (se_tpu's norms' statistics too): the same function,
    to 1e-9 of the output's scale."""
    want64, got64 = _fp64(monkeypatch, variants[norm], _spec(2, 9, seed=9),
                          norm=norm)
    scale = min(1.0, float(np.abs(want64).max()))
    np.testing.assert_allclose(got64, want64, rtol=1e-9, atol=1e-9 * scale)


@pytest.mark.parametrize("norm", VARIANTS)
def test_reference_state_dicts_round_trip(variants, norm):
    """The port's one state_dict, split at `step1.` / `step2.`, goes through
    se_tpu's `from_reference_state_dicts` to the tree it came from."""
    variables, sd, _ = variants[norm]
    halves = ({}, {})
    for key, val in _port(sd, norm=norm).state_dict().items():
        stage, rest = key.split(".", 1)
        halves[stage == "step2"][rest] = val.numpy()
    assert halves[0] and halves[1]
    back = JMODULE.from_reference_state_dicts(*halves)
    want = dict(jax.tree_util.tree_leaves_with_path(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))


@pytest.mark.parametrize("compressed", [True, False])
def test_enhance_waveform_matches_jax(monkeypatch, variants, compressed):
    variables, sd, _ = variants["cln"]
    rng = np.random.default_rng(4)
    wav = (rng.standard_normal((2, 2000)) * np.array([[0.05], [0.3]])
           ).astype(np.float32)
    want = j_enhance_waveform(NAME, variables, wav, compressed=compressed,
                              model=JCLS())

    def fp64_network():  # se_tpu's decode, its network in fp64, DSP fp32
        with se_tpu_fp64(monkeypatch):
            return j_enhance_waveform(NAME, to64(variables), wav,
                                      compressed=compressed, model=JCLS(),
                                      dtype=jnp.float64)

    got = enhance_waveform(NAME, _port(sd), wav, compressed=compressed,
                           device="cpu")
    assert got.shape == wav.shape and got.dtype == np.float32
    assert_as_se_tpu(got, want, lambda: (fp64_network(), None))


def test_train_step_matches_se_tpu(monkeypatch):
    check_train_step(monkeypatch, NAME, seed=5)


def test_registry_entry():
    entry = get_model(NAME)
    assert entry.make is PCLS and entry.io_kind == "complex_map"
    assert (entry.stft.win_length, entry.stft.hop) == (320, 160)
    assert entry.from_jax_variables is PORT.from_jax_variables
    assert entry.variants == VARIANTS
    with pytest.raises(ValueError, match="norm"):
        PCLS(norm="bn", device="cpu")


def test_constructor_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(NAME).make()
