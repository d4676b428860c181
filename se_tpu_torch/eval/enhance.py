"""Enhancement (decode) entry point: the port of se_tpu/eval/enhance.py for
io-kinds "waveform" (Uformer: STFT, network and iSTFT in the model),
"mag_mask" (LSTM, CRN: magnitude in, magnitude out, noisy phase reused),
"complex_map" (GCRN, DCCRN, CTSNet, TaylorSENet, G2Net: complex spectrum
in and out; G2Net's stages stacked first, the last taken), "complex_mask"
(DPCRN: its mask applied inside the model) and "cirm" (FullSubNet:
magnitude in, complex ratio mask out).

Per-utterance RMS gain c = sqrt(n / energy) is applied before the model and
removed after it (for G2Net the other way round, as its reference does).
Every spectral branch takes its STFT from `ops.stft_fused.stft_auto`: the
fused CUDA kernel on the card. The "hybrid" io-kind (DeepXi) has no branch
here, as in se_tpu: it decodes through `models.deepxi.enhance` (and
`models.deepxi_driver.DeepXiDriver.infer_dir`), with no RMS gain.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from se_tpu_torch.device import resolve_device
from se_tpu_torch.models.registry import ModelEntry, get_model
from se_tpu_torch.ops.stft import istft
from se_tpu_torch.ops.stft_fused import stft_auto


def model_device(model: torch.nn.Module, device=None) -> torch.device:
    """The device a decode of `model` runs on: `device` (None means the
    card; raises when CUDA is absent), which must hold the weights."""
    dev = resolve_device(device)
    wdev = next(model.parameters()).device
    if wdev.type != dev.type or (dev.index is not None and wdev != dev):
        raise ValueError(f"model weights are on {wdev}, asked to run on {dev}")
    return dev


def _magphase(re, im):
    return torch.sqrt(re * re + im * im), torch.atan2(im, re)


def _spectral(entry: ModelEntry, model: torch.nn.Module, wav: torch.Tensor,
              length: int, compressed: bool) -> torch.Tensor:
    """The spectral branches of se_tpu's `_enhance_jit`: STFT, the
    (compressed) magnitude and phase, the model, decompression, iSTFT."""
    cfg, kind = entry.stft, entry.io_kind
    mag, phase = _magphase(*stft_auto(wav, cfg))
    if compressed:
        mag = mag ** 0.5

    if kind == "mag_mask":  # the estimate is a magnitude: noisy phase
        est = model(mag)
        if compressed:
            est = est ** 2
        out_re, out_im = est * torch.cos(phase), est * torch.sin(phase)
    elif kind in ("complex_map", "complex_mask"):
        spec = torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)],
                           dim=-1)
        est = model(spec)
        if est.ndim == 5:  # multi-stage (G2Net): the last stage
            est = est[-1]
        est_mag, est_phase = _magphase(est[..., 0], est[..., 1])
        if compressed:
            est_mag = est_mag ** 2
        out_re = est_mag * torch.cos(est_phase)
        out_im = est_mag * torch.sin(est_phase)
    else:  # cirm: the mask multiplies the (compressed) complex feature
        feat_re, feat_im = mag * torch.cos(phase), mag * torch.sin(phase)
        mask = model(mag)
        m_re, m_im = mask[..., 0], mask[..., 1]
        out_re = m_re * feat_re - m_im * feat_im
        out_im = m_re * feat_im + m_im * feat_re
        if compressed:
            est_mag, est_phase = _magphase(out_re, out_im)
            est_mag = est_mag ** 2
            out_re = est_mag * torch.cos(est_phase)
            out_im = est_mag * torch.sin(est_phase)
    return istft(out_re, out_im, cfg, length=length)


@torch.no_grad()
def _enhance(entry: ModelEntry, model: torch.nn.Module, wav: torch.Tensor,
             length: int, compressed: bool = True) -> torch.Tensor:
    """se_tpu's `_enhance_jit` for the ported io-kinds, fp32."""
    if entry.io_kind in ("mag_mask", "complex_map", "complex_mask", "cirm"):
        return _spectral(entry, model, wav, length, compressed)
    if entry.io_kind != "waveform":  # "hybrid"; se_tpu raises alike
        raise ValueError(f"io kind {entry.io_kind!r} needs a dedicated "
                         "driver (DeepXi's: models.deepxi.enhance)")
    est, _, _, _ = model(wav, wav)
    pad = length - est.shape[-1]
    if pad > 0:
        est = F.pad(est, (0, pad))
    return est[..., :length]


def enhance_waveform(name: str, model: torch.nn.Module, wav: np.ndarray,
                     compressed: bool = True, device=None) -> np.ndarray:
    """Enhance a batch (B, N) or one (N,) waveform with `model`, a module
    of family `name` whose weights already live on `device` (None means the
    card; raises when CUDA is absent). `compressed` selects the mag**0.5
    regime of the spectral io-kinds; Uformer ignores it (its regime is a
    constructor argument). Returns float32 numpy of the input shape."""
    entry = get_model(name)
    dev = model_device(model, device)
    single = wav.ndim == 1
    x = np.atleast_2d(np.asarray(wav, np.float32))
    n = x.shape[-1]

    # per-utterance RMS gain; a family may invert it (entry.inverted_gain)
    energy = np.sum(np.square(x), axis=-1, keepdims=True)
    c = np.sqrt(n / np.maximum(energy, 1e-12)).astype(np.float32)
    inverted = entry.inverted_gain
    x_in = x / c if inverted else x * c
    model.eval()
    est = _enhance(entry, model, torch.from_numpy(x_in).to(dev), n,
                   compressed)
    est = est.cpu().numpy()
    est = est * c if inverted else est / c
    return est[0] if single else est
