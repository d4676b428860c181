"""Enhancement (decode) entry point: the port of se_tpu/eval/enhance.py for
io-kind "waveform" (Uformer: STFT, network and iSTFT in the model).

Per-utterance RMS gain c = sqrt(n / energy) is applied before the model and
removed after it. Other io-kinds are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from se_tpu_torch.device import resolve_device
from se_tpu_torch.models.registry import ModelEntry, get_model

# io-kind -> the ROADMAP.md item that ports its decode branch
_NOT_PORTED = {
    "mag_mask": "Queue 1 item 8 (lstm, crn)",
    "complex_map": "Queue 1 items 7-9 (gcrn, dpcrn, dccrn, ctsnet, g2net, "
                   "taylorsenet)",
    "complex_mask": "Queue 1 item 8 (dpcrn)",
    "cirm": "Queue 1 item 6 (fullsubnet)",
    "hybrid": "Queue 1 item 10 (deepxi)",
}


@torch.no_grad()
def _enhance(entry: ModelEntry, model: torch.nn.Module, wav: torch.Tensor,
             length: int) -> torch.Tensor:
    """The waveform branch of se_tpu's `_enhance_jit`, fp32."""
    if entry.io_kind != "waveform":
        where = _NOT_PORTED.get(entry.io_kind, "no ROADMAP item")
        raise NotImplementedError(
            f"io kind {entry.io_kind!r} is not ported yet: {where}")
    est, _, _, _ = model(wav, wav)
    pad = length - est.shape[-1]
    if pad > 0:
        est = F.pad(est, (0, pad))
    return est[..., :length]


def enhance_waveform(name: str, model: torch.nn.Module, wav: np.ndarray,
                     device=None) -> np.ndarray:
    """Enhance a batch (B, N) or one (N,) waveform with `model`, a module
    of family `name` whose weights already live on `device` (None means the
    card; raises when CUDA is absent). Returns float32 numpy of the input
    shape."""
    entry = get_model(name)
    dev = resolve_device(device)
    wdev = next(model.parameters()).device
    if wdev.type != dev.type or (dev.index is not None and wdev != dev):
        raise ValueError(f"model weights are on {wdev}, asked to run on {dev}")
    single = wav.ndim == 1
    x = np.atleast_2d(np.asarray(wav, np.float32))
    n = x.shape[-1]

    # per-utterance RMS gain
    energy = np.sum(np.square(x), axis=-1, keepdims=True)
    c = np.sqrt(n / np.maximum(energy, 1e-12)).astype(np.float32)
    model.eval()
    est = _enhance(entry, model, torch.from_numpy(x * c).to(dev), n)
    est = est.cpu().numpy() / c
    return est[0] if single else est
