"""The six LSTM families' bf16 enhance against se_tpu's on the CPU: LSTMNet,
CRN, GCRN, DCCRN, DPCRN and FullSubNet.

Seeded fp32 variables (`fill_tree`) go to se_tpu's `enhance_waveform(...,
dtype=jnp.bfloat16)` and, through `from_jax_variables`, to the port's
`enhance_waveform(..., dtype=torch.bfloat16, device="cpu")`, with
tests/test_torch_bf16_uformer.py's criterion against se_tpu's fp32 output
(`assert_tracks`: e_port <= 2 e_jax + 1e-6, max and mean relative, e_jax
> 1e-4, mean relative < 0.1). CRN, GCRN and DPCRN run at their published
widths, LSTMNet at hidden 48, DCCRN at kernel_num 8-16 / rnn_units 16,
FullSubNet at fb_hidden 32 / sb_hidden 24; two utterances of 0.7 s (70
frames at hop 160).

The dtype flow of se_tpu's bf16 decode, traced with `jax.make_jaxpr`
(every LSTM's weights bf16; x bf16 only where the layer's input is the
bf16 magnitude's; the scan's y fp32): a spy on the LSTM layer records
(x, Wx, Wh, b, y) of every layer call of a bf16 forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_tpu.eval.enhance import enhance_waveform as j_enhance_waveform
from se_tpu.models import crn as jcrn
from se_tpu.models import dccrn as jdccrn
from se_tpu.models import dpcrn as jdpcrn
from se_tpu.models import fullsubnet as jfullsubnet
from se_tpu.models import gcrn as jgcrn
from se_tpu.models import lstm as jlstm
from se_tpu_torch.eval import enhance as drv
from se_tpu_torch.models import crn, dccrn, dpcrn, fullsubnet, gcrn, lstm
from se_tpu_torch.nn import recurrent
from test_torch_bf16_uformer import assert_tracks
from torch_kernel_inputs import fill_tree

BF16, F32 = torch.bfloat16, torch.float32
# name: (se_tpu's class, the port's module, its class, widths, input shape
# of one frame, seed)
FAMILIES = {
    "lstm": (jlstm.LSTMNet, lstm, lstm.LSTMNet, dict(hidden=48), (161,), 50),
    "crn": (jcrn.CRN, crn, crn.CRN, {}, (161,), 51),
    "gcrn": (jgcrn.GCRN, gcrn, gcrn.GCRN, {}, (161, 2), 52),
    "dccrn": (jdccrn.DCCRN, dccrn, dccrn.DCCRN,
              dict(kernel_num=(8, 8, 16, 16, 16, 16), rnn_units=16),
              (257, 2), 53),
    "dpcrn": (jdpcrn.DPCRN, dpcrn, dpcrn.DPCRN, {}, (161, 2), 54),
    "fullsubnet": (jfullsubnet.FullSubNet, fullsubnet,
                   fullsubnet.FullSubNet, dict(fb_hidden=32, sb_hidden=24),
                   (257,), 55),
}
# name: x's dtype at each LSTM layer call of a forward, in call order
# (LSTMNet lstm1, lstm2 x 2; CRN's 2 layers; GCRN 2 groups x 2 stages;
# DCCRN 2 complex layers x (real, imag); DPCRN 2 passes x (intra 2 layers x
# 2 directions + inter 2 layers); FullSubNet full band x 2, sub band x 2)
X_DTYPES = {
    "lstm": [BF16, F32, F32],
    "crn": [BF16, F32],
    "gcrn": [F32] * 4,
    "dccrn": [F32] * 4,
    "dpcrn": [F32] * 12,
    "fullsubnet": [BF16, F32, F32, F32],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(name: str):
    """se_tpu's model and seeded variables, and the port's model with the
    same weights."""
    jcls, module, pcls, kw, frame, seed = FAMILIES[name]
    jmodel = jcls(**kw)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            np.zeros((1, 4, *frame), np.float32))
    variables = fill_tree(shapes, seed)
    port = pcls(**kw, device="cpu")
    port.load_state_dict(module.from_jax_variables(variables))
    return jmodel, variables, port


def _wav(b: int, n: int) -> np.ndarray:
    return (np.random.default_rng(4).standard_normal((b, n))
            * np.linspace(0.05, 0.3, b)[:, None]).astype(np.float32)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_bf16_enhance_tracks_se_tpu(record_property, name):
    jmodel, variables, port = _pair(name)
    wav = _wav(2, 11200)
    want = j_enhance_waveform(name, variables, wav, model=jmodel)
    want_bf16 = j_enhance_waveform(name, variables, wav, model=jmodel,
                                   dtype=jnp.bfloat16)
    got = drv.enhance_waveform(name, port, wav, device="cpu", dtype=BF16)
    assert got.shape == wav.shape
    e_jax, e_port = assert_tracks(got, want_bf16, want)
    record_property("e_jax", e_jax)
    record_property("e_port", e_port)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_lstm_dtype_flow_is_se_tpus(monkeypatch, name):
    """Every LSTM layer call of a bf16 forward: bf16 weights and bias, x
    bf16 exactly where se_tpu's is (the first LSTM after the bf16
    magnitude), y fp32; the caller's module keeps fp32 weights."""
    _, _, port = _pair(name)
    calls = []
    kernel = recurrent.lstm_layer_kernel

    def spy(x, wx, wh, b, *rest):
        out = kernel(x, wx, wh, b, *rest)
        calls.append((x.dtype, wx.dtype, wh.dtype, b.dtype, out[0].dtype))
        return out

    monkeypatch.setattr(recurrent, "lstm_layer_kernel", spy)
    drv.enhance_waveform(name, port, _wav(1, 3200), device="cpu", dtype=BF16)
    assert [c[0] for c in calls] == X_DTYPES[name]
    assert all(c[1:] == (BF16, BF16, BF16, F32) for c in calls)
    assert all(p.dtype == F32 for p in port.parameters())
    twin = port.__dict__["_bf16_copy"][1]
    lstms = [m for m in twin.modules() if isinstance(m, recurrent.LSTM)]
    assert lstms and all(p.dtype == BF16 for m in lstms
                         for p in m.parameters())


@pytest.mark.parametrize("name", ["lstm", "uformer"])
def test_bf16_windowed_tracks_se_tpu(record_property, name):
    """`enhance_windowed(dtype=torch.bfloat16)` against se_tpu's windowed
    decode with its `dtype` (se_tpu/eval/streaming.py:41,78), by the
    family rule: three windows of 0.1 s + 0.05 s context, two a batch."""
    from se_tpu.eval.streaming import enhance_windowed as j_windowed
    from se_tpu_torch.eval.streaming import enhance_windowed
    from test_torch_streaming import _pair as stream_pair

    jmodel, variables, port = (stream_pair(name, seed=11) if name == "uformer"
                               else _pair(name))
    wav = _wav(1, 4000)[0]
    kw = dict(chunk_seconds=0.1, context_seconds=0.05, max_batch=2)
    want = j_windowed(name, variables, wav, model=jmodel, **kw)
    want_bf16 = j_windowed(name, variables, wav, model=jmodel,
                           dtype=jnp.bfloat16, **kw)
    got = enhance_windowed(name, port, wav, device="cpu", dtype=BF16, **kw)
    assert got.shape == wav.shape
    e_jax, e_port = assert_tracks(got, want_bf16, want)
    record_property("e_jax", e_jax)
    record_property("e_port", e_port)
