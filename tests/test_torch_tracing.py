"""The port's span recorder (se_tpu_torch/utils/profiling.py), on the
CPU.

Off, `span` is one shared null context and records nothing. Inside
`recording()`, or while torch.profiler traces (into `PROFILED`), a span
records (name, start_ns, end_ns, parent) in start order: the entry's
`enhance` with its five children, the trainer's `train.step`, the
autograd wrapper's `autograd.kernel` and `autograd.twin`, `kernel.launch`
and each pack function's own, once a pack; Uformer's `_cached` packs
once. Spans from several threads each keep their own index and end."""

import threading

import numpy as np
import pytest
import torch

from se_tpu_torch.eval.enhance import enhance_waveform
from se_tpu_torch.models import get_model
from se_tpu_torch.models import uformer as uf
from se_tpu_torch.ops import _autograd, _build, decoder, dsconv, encoder, lstm
from se_tpu_torch.ops._dtype import widened_launch
from se_tpu_torch.train.trainer import TrainConfig, make_train_step
from se_tpu_torch.utils import profiling
from torch_kernel_inputs import (
    dec_params, dsconv_params, enc_params, lstm_inputs, pair_inputs,
    to_bf16, to_torch,
)


def _names(spans):
    return [s[0] for s in spans]


def _nested(spans):
    """Every span closed, inside its parent, and in start order."""
    for name, a, b, parent in spans:
        assert a <= b, name
        if parent >= 0:
            _, pa, pb, _ = spans[parent]
            assert pa <= a and b <= pb, (name, spans[parent][0])
    assert [s[1] for s in spans] == sorted(s[1] for s in spans)


def _children(spans, parent):
    return [s[0] for s in spans if s[3] == parent]


def test_span_off_is_the_shared_null_context():
    before = list(profiling.PROFILED)
    ctx = profiling.span("x")
    assert ctx is profiling.span("y") is profiling._NULL
    with ctx:
        pass
    assert profiling.PROFILED == before


def test_recording_nests_spans_and_restores_the_outer_one():
    with profiling.recording() as outer:
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.recording() as inner:
                    with profiling.span("c"):
                        pass
            with profiling.span("d"):
                pass
    assert _names(outer) == ["a", "b", "d"]
    assert [s[3] for s in outer] == [-1, 0, 0]
    assert _names(inner) == ["c"] and inner[0][3] == -1
    _nested(outer)
    assert profiling.span("e") is profiling._NULL


def test_profiler_turns_the_recorder_on():
    from torch.profiler import ProfilerActivity, profile

    n = len(profiling.PROFILED)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("p"):
                with profiling.span("q"):
                    pass
            with profiling.recording() as spans:
                with profiling.span("r"):
                    pass
        mine = profiling.PROFILED[n:]
        assert _names(mine) == ["p", "q"]
        assert mine[1][3] == n
        assert _names(spans) == ["r"]
        assert profiling.span("s") is profiling._NULL
    finally:
        del profiling.PROFILED[n:]


def test_profiled_spans_stop_at_the_limit(monkeypatch):
    n = len(profiling.PROFILED)
    monkeypatch.setattr(profiling._PROFILED, "limit", n + 1)
    monkeypatch.setattr(profiling._torch_profiler, "_is_profiler_enabled",
                        True)
    try:
        for name in ("kept", "dropped"):
            with profiling.span(name):
                pass
        assert _names(profiling.PROFILED[n:]) == ["kept"]
        assert profiling._PROFILED.open == []
    finally:
        del profiling.PROFILED[n:]


def test_span_is_off_where_torch_has_no_profiler_flag(monkeypatch):
    monkeypatch.delattr(profiling._torch_profiler, "_is_profiler_enabled")
    assert profiling.span("x") is profiling._NULL


def test_spans_from_two_threads_keep_their_own_ends():
    opened, release = threading.Event(), threading.Event()

    def other():
        with profiling.span("a"):
            opened.set()
            assert release.wait(5)

    with profiling.recording() as spans:
        worker = threading.Thread(target=other)
        worker.start()
        assert opened.wait(5)
        with profiling.span("b"):
            release.set()
            worker.join(5)  # "a" ends while "b" is open
            with profiling.span("c"):
                pass
        with profiling.span("d"):
            pass
    assert _names(spans) == ["a", "b", "c", "d"]
    assert [s[3] for s in spans] == [-1, 0, 1, -1]
    assert spans[0][2] <= spans[2][1] and spans[2][2] <= spans[1][2]


def test_spans_from_many_threads_each_get_their_own_index():
    def work(k):
        for _ in range(300):
            with profiling.span(f"t{k}"):
                with profiling.span(f"t{k}.inner"):
                    pass

    with profiling.recording() as spans:
        sink = profiling._recording
        workers = [threading.Thread(target=work, args=(k,))
                   for k in range(4)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(30)
    assert len(spans) == 4 * 300 * 2
    assert all(b >= a for _, a, b, _ in spans)
    assert sink.open == []
    assert [s[1] for s in spans] == sorted(s[1] for s in spans)


def test_enhance_records_the_entry_spans():
    model = get_model("lstm").make(hidden=8, device="cpu")
    wav = np.random.default_rng(0).standard_normal((2, 1600)) \
        .astype(np.float32) * 0.1
    with profiling.recording() as spans:
        out = enhance_waveform("lstm", model, wav, device="cpu")
    assert out.shape == wav.shape
    _nested(spans)
    assert spans[0][0] == "enhance" and spans[0][3] == -1
    assert _children(spans, 0) == ["enhance.gain", "enhance.h2d",
                                   "enhance.model", "enhance.d2h",
                                   "enhance.ungain"]
    assert sum(s[3] == -1 for s in spans) == 1


def test_train_step_records_the_trainer_spans():
    cfg = TrainConfig(model="lstm", model_kwargs=dict(hidden=16))
    model, init_fn, step_fn, _ = make_train_step(cfg, device="cpu")
    state = init_fn(0)
    hop = get_model("lstm").stft.hop
    gen = torch.Generator().manual_seed(0)
    clean = torch.randn(2, 1600, generator=gen) * 0.1
    batch = {"mix": clean + 0.05 * torch.randn(2, 1600, generator=gen),
             "clean": clean,
             "frames": torch.full((2,), 1600 // hop + 1, dtype=torch.int64)}
    with profiling.recording() as spans:
        step_fn(state, batch)
    _nested(spans)
    assert spans[0][0] == "train.step"
    assert _children(spans, 0) == ["train.forward", "train.backward",
                                   "train.optimizer"]
    forward = _names(spans).index("train.forward")
    assert _children(spans, forward) == ["train.prep"]


def test_kernel_call_records_the_kernel_then_the_twin():
    x = torch.randn(3, 4, requires_grad=True)

    def double(t):
        return t * 2

    with profiling.recording() as spans:
        y = _autograd.kernel_call(double, double, x)
        with torch.no_grad():
            _autograd.kernel_call(double, double, x)
        y.sum().backward()
    assert _names(spans) == ["autograd.kernel", "autograd.twin"]
    assert spans[0][2] <= spans[1][1]
    assert torch.equal(x.grad, torch.full_like(x, 2.0))


def test_launch_is_a_span_even_where_it_raises(monkeypatch):
    def no_build():
        raise AssertionError("launch built the library")

    monkeypatch.setattr(_build, "library", no_build)
    with profiling.recording() as spans:
        with pytest.raises(ValueError, match="one CUDA device"):
            _build.launch("se_lstm_layer", torch.zeros(2),
                          torch.zeros(2, device="meta"), 3)
    assert _names(spans) == ["kernel.launch"] and spans[0][2] >= spans[0][1]


def _lstm(rng):
    _, wx, wh, _ = to_torch(lstm_inputs(rng, 1, 1, 12, 8))
    return wx, wh


PACKS = {
    "pack_weights": lambda rng: lstm.pack_weights(*_lstm(rng)),
    "pack_weights_bf16": lambda rng: lstm.pack_weights_bf16(
        *(w.to(torch.bfloat16) for w in _lstm(rng))),
    "pack_input": lambda rng: lstm.pack_input(_lstm(rng)[0]),
    "pack_recurrent": lambda rng: lstm.pack_recurrent(_lstm(rng)[1]),
    "pack_encoder_weights": lambda rng: encoder.pack_encoder_weights(
        to_torch(enc_params(rng, 4, 8))),
    "pack_decoder_weights": lambda rng: decoder.pack_decoder_weights(
        to_torch(dec_params(rng, 8, 8))),
    "pack_block_weights": lambda rng: dsconv.pack_block_weights(
        to_torch(dsconv_params(rng, 16, 4, 2)), 2),
    "pack_pair_weights": lambda rng: dsconv.pack_pair_weights(
        *(to_torch(p) for p in pair_inputs(rng, 1, 2, 4, 8, 4)[2:])),
}


@pytest.mark.parametrize("kind", sorted(PACKS))
def test_each_pack_counts_once_under_its_name(rng, kind):
    with profiling.recording() as spans:
        PACKS[kind](rng)
    assert _names(spans) == [kind]
    assert spans[0][3] == -1 and spans[0][2] >= spans[0][1]


def test_widened_launch_counts_its_own_pack(rng):
    params = to_bf16(dec_params(rng, 8, 8))
    xc, xm = to_bf16((rng.standard_normal((1, 3, 4, 16)),
                      rng.standard_normal((1, 3, 4, 8))))
    with profiling.recording() as spans:
        widened_launch("decoder", lambda xc, xm, params, packed: (xc, xm),
                       xc, xm, params, (0, 1, 6, 7), None,
                       decoder.pack_decoder_weights)
    assert _names(spans) == ["pack_decoder_weights"]


def test_uformer_cache_packs_once(rng):
    owner = torch.nn.Module()
    mod = torch.nn.Linear(2, 2)
    params = to_torch(enc_params(rng, 4, 8))

    def make():
        return encoder.pack_encoder_weights(params)

    with torch.no_grad(), profiling.recording() as spans:
        first = uf._cached(owner, "encoder", 0, (mod,), make)
        assert uf._cached(owner, "encoder", 0, (mod,), make) is first
        assert _names(spans) == ["pack_encoder_weights"]
        mod.weight.add_(1.0)  # a weight changed in place: packed anew
        uf._cached(owner, "encoder", 0, (mod,), make)
    assert _names(spans) == ["pack_encoder_weights"] * 2
