"""se_tpu_torch's streaming decode against se_tpu's, on the CPU.

- `nn.recurrent.lstm_split` against se_tpu's at split 0, 6, T and T + 3
  from a non-zero carry: outputs and carries within 1e-5.
- The carried forwards of LSTMNet, CRN, GCRN and DPCRN (`forward(x,
  carry=, split=)`) against se_tpu's `model.apply(variables, x, carry=,
  split=)` from a non-zero carry, without and with a split: outputs and
  carries within 1e-4 * max(1, max|se_tpu|).
- `LstmStreamer` and `CausalStreamer` against se_tpu's on the same weights
  and pieces, within 1e-4 * max(1, max|se_tpu|), and against the port's
  own offline decode at se_tpu's own tolerance (2e-4 for LSTMNet, 3e-4 for
  the causal families: tests/test_streaming.py); the self-gain stream;
  the utterance too short to start; the small-chunk ValueError.
- `enhance_windowed` against se_tpu's for GCRN and DPCRN, the ragged tail,
  and Uformer (the waveform family) at a short chunk; another dtype
  raises.

Weights are drawn by `fill_tree` (every BN statistic off its default) and
carried across by `from_jax_variables`. The models run at their published
widths on a few seconds of audio.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import se_tpu.models as jmodels
from se_tpu.eval import streaming as jstreaming
from se_tpu.nn.recurrent import LSTM as JLSTM
from se_tpu.nn.recurrent import lstm_split as j_lstm_split
from se_tpu_torch.eval import streaming
from se_tpu_torch.eval.enhance import enhance_waveform
from se_tpu_torch.models import get_model
from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.nn import LSTM
from se_tpu_torch.nn.recurrent import lstm_split
from torch_kernel_inputs import fill_tree

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's intra-op threads would only contend with the other test
    workers' processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(name: str, seed: int, **kw) -> dict:
    model = jmodels.get_model(name).make(**kw)
    entry = get_model(name)
    if entry.io_kind == "waveform":
        args = (np.zeros((1, 1600), np.float32),) * 2
    elif entry.io_kind == "mag_mask":
        args = (np.zeros((1, 16, entry.stft.bins), np.float32),)
    else:
        args = (np.zeros((1, 16, entry.stft.bins, 2), np.float32),)
    return fill_tree(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                    *args), seed)


def _pair(name: str, seed: int = 0):
    """(se_tpu module, its variables, the port's model with the same
    weights on the CPU)."""
    variables = _variables(name, seed)
    model = get_model(name).make(device="cpu")
    model.load_state_dict(get_model(name).from_jax_variables(variables))
    return jmodels.get_model(name).make(), variables, model


def _wav(n: int, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(
        np.float32)


def _gain(wav: np.ndarray) -> float:
    return float(np.sqrt(len(wav) / max(np.sum(wav ** 2), 1e-12)))


def _assert_as(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(1.0, np.abs(want).max()))


def _to_torch(carry):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), carry)


def _same_carry(got, want, rel):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _assert_as(a.numpy(), b, rel)


# ----------------------------------------------------------------- lstm_split

@pytest.mark.parametrize("split", [0, 6, 16, 19])
def test_lstm_split_matches_se_tpu(split):
    t, d, h = 16, 24, 32
    jlstm = JLSTM(h, num_layers=2)
    x = np.random.default_rng(1).standard_normal((2, t, d)).astype(
        np.float32)
    variables = fill_tree(jax.eval_shape(jlstm.init, jax.random.PRNGKey(0),
                                         x), 2)
    sd = {}
    jt.put_lstm(sd, "m", variables["params"])
    lstm = LSTM(d, h, num_layers=2)
    lstm.load_state_dict({k[2:]: v for k, v in sd.items()})
    rng = np.random.default_rng(3)
    carry = [tuple(rng.standard_normal((2, h)).astype(np.float32) * 0.5
                   for _ in range(2)) for _ in range(2)]
    want, want_c = j_lstm_split(jlstm.bind(variables), jnp.asarray(x),
                                jax.tree.map(jnp.asarray, carry), split)
    with torch.no_grad():
        got, got_c = lstm_split(lstm, torch.from_numpy(x), _to_torch(carry),
                                split)
    _assert_as(got.numpy(), want, 1e-5)
    _same_carry(got_c, want_c, 1e-5)


# ----------------------------------------------------------- carried forwards

def _features(name: str, t: int, seed: int) -> np.ndarray:
    """(1, t, F) magnitudes or (1, t, F, 2) spectra."""
    entry = get_model(name)
    x = np.random.default_rng(seed).standard_normal(
        (1, t, entry.stft.bins, 2)).astype(np.float32)
    return np.abs(x[..., 0]) if entry.io_kind == "mag_mask" else x


@pytest.mark.parametrize("split", [None, 6], ids=["no_split", "split6"])
@pytest.mark.parametrize("name", ["lstm", "crn", "gcrn", "dpcrn"])
def test_carried_forward_matches_se_tpu(name, split):
    """se_tpu's LSTMNet takes no split (its streamer replays nothing): the
    port's carry after a split is held against se_tpu's carry after the
    forward over the first `split` frames alone."""
    jmodel, variables, model = _pair(name, seed=4)
    x = _features(name, 16, 5)
    zero = model.zero_carry(1, device="cpu")
    rng = np.random.default_rng(6)
    carry = jax.tree.map(
        lambda z: (rng.standard_normal(tuple(z.shape)) * 0.5).astype(
            np.float32), zero)
    jvars = jax.tree.map(jnp.asarray, variables)
    jcarry = jax.tree.map(jnp.asarray, carry)
    if name == "lstm":
        want, want_c = jmodel.apply(jvars, jnp.asarray(x), carry=jcarry)
        if split is not None:
            _, want_c = jmodel.apply(jvars, jnp.asarray(x[:, :split]),
                                     carry=jcarry)
    else:
        want, want_c = jmodel.apply(jvars, jnp.asarray(x), carry=jcarry,
                                    split=split)
    with torch.no_grad():
        got, got_c = model(torch.from_numpy(x), carry=_to_torch(carry),
                           split=split)
    _assert_as(got.numpy(), want)
    _same_carry(got_c, want_c, 1e-4)


# ------------------------------------------------------------------ streamers

def _stream(st, pieces):
    outs = [st.push(p) for p in pieces]
    outs.append(st.flush())
    return outs


def test_lstm_streamer_matches_se_tpu_and_the_offline_decode():
    jmodel, variables, model = _pair("lstm", seed=8)
    n = 40000  # 2.5 s, not a hop multiple after the last frame
    wav = _wav(n, 1)
    cuts = [0, 1000, 8777, 23456, n]
    pieces = [wav[a:b] for a, b in zip(cuts, cuts[1:])]
    c = _gain(wav)
    outs = _stream(streaming.LstmStreamer(model, chunk_frames=16, gain=c,
                                          device="cpu"), pieces)
    got = np.concatenate(outs)
    want = np.concatenate(_stream(jstreaming.LstmStreamer(
        variables, model=jmodel, chunk_frames=16, gain=c), pieces))
    assert got.shape == want.shape == (n,)
    _assert_as(got, want)
    offline = enhance_waveform("lstm", model, wav, device="cpu")
    np.testing.assert_allclose(got, offline, atol=2e-4, rtol=0)
    # incremental: output arrived before the flush
    assert sum(len(o) for o in outs[:-1]) > 0.8 * n


def test_lstm_streamer_self_gain():
    """Without a gain the stream estimates it from its first samples: the
    same as se_tpu's stream, and close to the offline decode for a
    stationary input."""
    jmodel, variables, model = _pair("lstm", seed=8)
    wav = _wav(32000, 2)
    pieces = [wav[:16000], wav[16000:]]
    got = np.concatenate(_stream(streaming.LstmStreamer(
        model, chunk_frames=8, device="cpu"), pieces))
    want = np.concatenate(_stream(jstreaming.LstmStreamer(
        variables, model=jmodel, chunk_frames=8), pieces))
    _assert_as(got, want)
    full = enhance_waveform("lstm", model, wav, device="cpu")
    err = np.abs(got - full).mean() / (np.abs(full).mean() + 1e-9)
    assert err < 0.05, err


@pytest.mark.parametrize("name", ["crn", "gcrn", "dpcrn"])
def test_causal_streamer_matches_se_tpu_and_the_offline_decode(name):
    jmodel, variables, model = _pair(name, seed=9)
    n = 24000  # 1.5 s, not a hop multiple
    wav = _wav(n, 3)
    cuts = [0, 900, 7777, 15555, n]  # tests/test_streaming.py's pieces
    pieces = [wav[a:b] for a, b in zip(cuts, cuts[1:])]
    c = _gain(wav)
    outs = _stream(streaming.CausalStreamer(name, model, chunk_frames=16,
                                            gain=c, device="cpu"), pieces)
    got = np.concatenate(outs)
    want = np.concatenate(_stream(jstreaming.CausalStreamer(
        name, variables, model=jmodel, chunk_frames=16, gain=c), pieces))
    assert got.shape == want.shape == (n,)
    _assert_as(got, want)
    offline = enhance_waveform(name, model, wav, device="cpu")
    np.testing.assert_allclose(got, offline, atol=3e-4, rtol=0)
    assert sum(len(o) for o in outs[:-1]) > 0.7 * n


def test_streamer_too_short_to_start_falls_back_to_the_offline_decode():
    """An utterance shorter than the head's reflect padding (fft // 2 + 1
    samples) never starts the stream: the flush hands it to the offline
    decode, empty for no input. torch's reflect padding refuses a pad as
    long as the input, where se_tpu's repeats the reflection (ROADMAP
    Queue 3): the port's offline decode raises there, and so does the
    fallback, alike."""
    _, _, model = _pair("crn", seed=9)
    wav = _wav(120, 4)
    st = streaming.CausalStreamer("crn", model, device="cpu")
    assert st.push(wav).shape == (0,)
    with pytest.raises(RuntimeError, match="[Pp]adding") as offline:
        enhance_waveform("crn", model, wav, device="cpu")
    with pytest.raises(RuntimeError) as fallback:
        st.flush()
    assert str(fallback.value) == str(offline.value)
    lstm = streaming.LstmStreamer(_pair("lstm")[2], device="cpu")
    assert lstm.push(np.zeros(0, np.float32)).shape == (0,)
    assert lstm.flush().shape == (0,)


def test_causal_streamer_rejects_small_chunk():
    model = get_model("crn").make(device="cpu")
    with pytest.raises(ValueError, match="replay_frames"):
        streaming.CausalStreamer("crn", model, chunk_frames=4, device="cpu")


# ------------------------------------------------------------------- windowed

@pytest.mark.parametrize("name", ["gcrn", "dpcrn"])
def test_windowed_matches_se_tpu(name):
    """Four windows of 1 s + 0.5 s context, two a batch; and the ragged
    tail: exactly n samples back."""
    jmodel, variables, model = _pair(name, seed=10)
    n = 4 * SR - 1234
    wav = _wav(n, 5)
    kw = dict(chunk_seconds=1.0, context_seconds=0.5, max_batch=2)
    got = streaming.enhance_windowed(name, model, wav, device="cpu", **kw)
    want = jstreaming.enhance_windowed(name, variables, wav, model=jmodel,
                                       **kw)
    assert got.shape == want.shape == (n,)
    _assert_as(got, want)


def test_windowed_padding_windows_change_nothing():
    """The tail batch's silent padding windows leave the real ones as they
    are: one batch of 4 against batches of 3 (the second padded)."""
    _, _, model = _pair("gcrn", seed=10)
    wav = _wav(4 * SR, 6)
    kw = dict(chunk_seconds=1.0, context_seconds=0.25, device="cpu")
    one = streaming.enhance_windowed("gcrn", model, wav, max_batch=4, **kw)
    padded = streaming.enhance_windowed("gcrn", model, wav, max_batch=3,
                                        **kw)
    np.testing.assert_allclose(padded, one, rtol=0,
                               atol=1e-5 * np.abs(one).max())


def test_windowed_uformer_matches_se_tpu():
    """The waveform family (STFT, network and iSTFT in the model) at a
    short chunk: three windows of 0.1 s + 0.05 s context."""
    jmodel, variables, model = _pair("uformer", seed=11)
    n = 4000
    wav = _wav(n, 7)
    kw = dict(chunk_seconds=0.1, context_seconds=0.05, max_batch=2)
    got = streaming.enhance_windowed("uformer", model, wav, device="cpu",
                                     **kw)
    want = jstreaming.enhance_windowed("uformer", variables, wav,
                                       model=jmodel, **kw)
    assert got.shape == (n,)
    _assert_as(got, want)


def test_windowed_refuses_other_dtypes():
    """float32 and bfloat16 only (enhance_waveform's rule), before any
    work."""
    model = get_model("gcrn").make(device="cpu")
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            streaming.enhance_windowed("gcrn", model, _wav(1600),
                                       dtype=dtype, device="cpu")
