"""The TCM families' bf16 enhance against se_tpu's on the CPU: CTSNet and
TaylorSENet here, G2Net (its inverted RMS gain) in
tests/test_torch_bf16_g2net.py, each in both norm variants.

Seeded fp32 variables (`fill_tree`) go to se_tpu's `enhance_waveform(...,
dtype=jnp.bfloat16)` and to the port's `enhance_waveform(...,
dtype=torch.bfloat16, device="cpu")`, with tests/test_torch_bf16_uformer.py's
criterion against se_tpu's fp32 output (`assert_tracks`). se_tpu's
spectral branch rounds the magnitude to bf16 and keeps the phase fp32, so
the complex spectrum and every layer after it promote to fp32 around the
bf16-rounded weights: the port does the same and lands within ~1e-4 of
se_tpu's own bf16 distance. Two utterances of 1 s (101 frames): the
instance norms amplify round-off over a few frames (G2Net "in" over 26
frames parts bf16 from fp32 by 10% in se_tpu itself).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_tpu.eval.enhance import enhance_waveform as j_enhance_waveform
from se_tpu.models import ctsnet as jctsnet
from se_tpu.models import g2net as jg2net
from se_tpu.models import taylorsenet as jtaylorsenet
from se_tpu_torch.eval.enhance import enhance_waveform
from se_tpu_torch.models import ctsnet, g2net, taylorsenet
from test_torch_bf16_uformer import assert_tracks
from torch_kernel_inputs import fill_tree

# name: (se_tpu's class, the port's module, its class, seed)
FAMILIES = {
    "ctsnet": (jctsnet.CTSNet, ctsnet, ctsnet.CTSNet, 20),
    "taylorsenet": (jtaylorsenet.TaylorSENet, taylorsenet,
                    taylorsenet.TaylorSENet, 30),
    "g2net": (jg2net.G2Net, g2net, g2net.G2Net, 40),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def check_family(name: str, norm: str, record_property) -> None:
    jcls, module, pcls, seed = FAMILIES[name]
    jmodel = jcls(norm=norm)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            np.zeros((1, 4, 161, 2), np.float32))
    variables = fill_tree(shapes, seed)
    port = pcls(norm=norm, device="cpu")
    port.load_state_dict(module.from_jax_variables(variables))
    wav = (np.random.default_rng(4).standard_normal((2, 16000))
           * np.array([[0.05], [0.3]])).astype(np.float32)
    want = j_enhance_waveform(name, variables, wav, model=jmodel)
    want_bf16 = j_enhance_waveform(name, variables, wav, model=jmodel,
                                   dtype=jnp.bfloat16)
    got = enhance_waveform(name, port, wav, device="cpu",
                           dtype=torch.bfloat16)
    assert got.shape == wav.shape
    e_jax, e_port = assert_tracks(got, want_bf16, want)
    record_property("e_jax", e_jax)
    record_property("e_port", e_port)


@pytest.mark.parametrize("norm", ["cln", "in"])
@pytest.mark.parametrize("name", ["ctsnet", "taylorsenet"])
def test_bf16_enhance_tracks_se_tpu(record_property, name, norm):
    check_family(name, norm, record_property)
