"""se_tpu_torch.ops.stft_fused against se_tpu.ops.pallas_stft on the CPU.

On a CPU tensor `stft_fused` runs its plain twin; the twin is held against
`stft_pallas` run in interpret mode (patched as tests/test_pallas_stft.py
patches it). The CUDA kernel is held against the twin on the card in
tests/test_torch_cuda.py. Tolerance 1e-4 * max|ref|: K-long fp32 sums in
another order on spectra of O(10).
"""

import functools
import importlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from se_tpu.ops import pallas_stft as jps
from se_tpu_torch.ops import _build
from se_tpu_torch.ops import stft as tst
from se_tpu_torch.ops.stft_fused import stft_auto, stft_fused

# se_tpu.ops re-exports the function `stft` under the module's name
jst = importlib.import_module("se_tpu.ops.stft")

CASES = {
    "320": dict(win_length=320, hop=160, n_fft=320),
    "512_256": dict(win_length=512, hop=256, n_fft=512),
    "512_128": dict(win_length=512, hop=128, n_fft=512),
    "pad_end_hamming": dict(win_length=512, hop=256, n_fft=512,
                            window="hamming", convention="pad_end"),
    "valid": dict(win_length=400, hop=100, n_fft=512, convention="valid"),
}


def _pallas_interp(x, cfg):
    orig = pl.pallas_call
    with mock.patch.object(jps.pl, "pallas_call",
                           functools.partial(orig, interpret=True)):
        # bypass the jit cache so the interpret flag takes effect
        return jps.stft_pallas.__wrapped__(x, cfg)


@pytest.mark.parametrize("n", [8000, 4321])
@pytest.mark.parametrize("case", sorted(CASES))
def test_stft_fused_twin_matches_pallas_interpret(case, n):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    want = _pallas_interp(jnp.asarray(x), jst.StftConfig(**CASES[case]))
    got = stft_fused(torch.from_numpy(x), tst.StftConfig(**CASES[case]))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=1e-4 * scale)


def test_stft_fused_rejects_frame_not_multiple_of_hop():
    cfg = tst.StftConfig(400, 160, 512)  # frame 512, hop 160
    with pytest.raises(ValueError, match="frame_len % hop"):
        stft_fused(torch.zeros(1, 1600), cfg)
    with pytest.raises(ValueError, match="frame_len % hop"):
        stft_fused(torch.zeros(1, 1600, device="meta"), cfg)


@pytest.mark.parametrize("preset", ["PRESET_512_128", "PRESET_UFORMER"])
def test_stft_auto_on_cpu_is_the_plain_stft(preset):
    cfg = getattr(tst, preset)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3000)).astype(np.float32))
    before = _build.LAUNCHES["stft"]
    got = stft_auto(x, cfg)
    assert _build.LAUNCHES["stft"] == before
    for g, w in zip(got, tst.stft(x, cfg)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_pad_signal_gives_every_frame(rng):
    """Frame t of the plain framing is xp[t*hop : t*hop + frame_len] of
    the padded waveform the kernel reads."""
    for kw in CASES.values():
        cfg = tst.StftConfig(**kw)
        x = torch.from_numpy(rng.standard_normal((2, 4321)).astype(
            np.float32))
        xp = tst.pad_signal(x, cfg)
        frames = tst.frame_signal(x, cfg)
        for t in (0, frames.shape[1] - 1):
            start = t * cfg.hop
            torch.testing.assert_close(
                frames[:, t], xp[:, start:start + cfg.frame_len], rtol=0,
                atol=0)
