"""Uformer's bf16 enhance against se_tpu's on the CPU.

The same seeded fp32 variables (tests/test_torch_uformer.py's) go to
se_tpu's `enhance_waveform("uformer", ..., dtype=jnp.bfloat16)` and to the
port's `enhance_waveform(..., dtype=torch.bfloat16, device="cpu")`; each
side rounds them to bf16 on its own. With e_jax se_tpu bf16's distance
from se_tpu fp32 and e_port the port bf16's, each measured as max |err| /
max |ref| and as mean |err| / mean |ref|: e_port <= 2 e_jax + 1e-6 (the
two round at other places: se_tpu's CPU path runs its einsum attention
and composed convs in bf16, the port's kernels keep fp32 inside), e_jax >
1e-4 (bf16 really ran), and the mean relative error < 0.1
(tests/test_data_enhance.py's bound). Spies on the four kernel wrappers'
plain twins show each received bf16 tensors, as often as a forward
launches its kernel on the card (attention 4, pair 8, encoder 6, decoder
6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_tpu.eval.enhance import enhance_waveform as j_enhance_waveform
from se_tpu.models.uformer import Uformer as JUformer
from se_tpu_torch.eval.enhance import enhance_waveform
from se_tpu_torch.models.uformer import from_jax_variables
from se_tpu_torch.ops import attention, decoder, dsconv, encoder
from test_torch_uformer import _port, jax_variables

# wrapper module: (its plain twin's name, calls a forward)
TWINS = {attention: ("_reference", 4), dsconv: ("_pair_reference", 8),
         encoder: ("_reference", 6), decoder: ("_reference", 6)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    variables = jax_variables(0)
    return variables, from_jax_variables(variables)


def distances(got, ref):
    """(max |err| / max |ref|, mean |err| / mean |ref|)."""
    err = np.abs(got - ref)
    return (float(err.max() / np.abs(ref).max()),
            float(err.mean() / np.abs(ref).mean()))


def assert_tracks(got, want_bf16, want_fp32):
    """The port's bf16 output against se_tpu's bf16 and fp32 ones."""
    assert got.dtype == np.float32 and np.isfinite(got).all()
    e_jax, e_port = distances(want_bf16, want_fp32), distances(got, want_fp32)
    for ej, ep in zip(e_jax, e_port):
        assert ej > 1e-4, e_jax
        assert ep <= 2 * ej + 1e-6, (e_port, e_jax)
    assert e_port[1] < 0.1, e_port
    return e_jax, e_port


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("n", [4000, 10400])
def test_uformer_bf16_enhance_tracks_se_tpu(monkeypatch, record_property,
                                            weights, n, compressed):
    variables, sd = weights
    wav = (np.random.default_rng(n).standard_normal((1, n)) * 0.1
           ).astype(np.float32)
    jmodel = JUformer(compressed=compressed)
    want = j_enhance_waveform("uformer", variables, wav, model=jmodel)
    want_bf16 = j_enhance_waveform("uformer", variables, wav, model=jmodel,
                                   dtype=jnp.bfloat16)
    seen = {mod: [] for mod in TWINS}
    for mod, (name, _) in TWINS.items():
        twin = getattr(mod, name)

        def spy(*args, _twin=twin, _seen=seen[mod]):
            _seen.append(tuple(a.dtype for a in args
                               if isinstance(a, torch.Tensor)))
            return _twin(*args)

        monkeypatch.setattr(mod, name, spy)
    got = enhance_waveform("uformer", _port(sd, compressed), wav,
                           device="cpu", dtype=torch.bfloat16)
    for mod, (_, calls) in TWINS.items():
        assert len(seen[mod]) == calls, mod.__name__
        assert all(d == (torch.bfloat16,) * len(d) for d in seen[mod])
    e_jax, e_port = assert_tracks(got, want_bf16, want)
    record_property("e_jax", e_jax)
    record_property("e_port", e_port)
