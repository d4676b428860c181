"""Fused STFT (framing + window + DFT): the port of
se_tpu/ops/pallas_stft.py (`stft_pallas`, kernel `_kernel`; dispatcher
`stft_auto`).

On a CUDA tensor `stft_fused` pads the waveform in torch, as `stft_pallas`
pads outside its `pallas_call`, and launches csrc/stft.cu, which never
writes the frames tensor; on a CPU tensor it runs `_reference`, the plain
twin (`ops.stft.stft`: framing, then one matmul with the same basis).

`stft_auto` sends every 2-D CUDA input with frame_len % hop == 0 to the
kernel. It drops the JAX dispatcher's k = frame_len / hop >= 3 threshold,
a TPU v5e measurement; whether the kernel beats the plain path at k = 2 on
the card is measured by chip_smoke.py.
"""

from __future__ import annotations

import torch

from se_tpu_torch.ops import _build
from se_tpu_torch.ops.stft import StftConfig, _const, num_frames, pad_signal
from se_tpu_torch.ops.stft import stft as _reference


def stft_fused(x: torch.Tensor, cfg: StftConfig):
    """(B, n) fp32 waveform -> ((B, T, F) real, (B, T, F) imag)."""
    if cfg.frame_len % cfg.hop != 0:  # the TPU entry's contract
        raise ValueError(f"fused stft needs frame_len % hop == 0, got "
                         f"{cfg.frame_len} and {cfg.hop}")
    if x.device.type == "cpu":
        return _reference(x, cfg)
    if x.ndim != 2:
        raise ValueError(f"stft kernel: expected (B, n), got {tuple(x.shape)}")
    b, n = x.shape
    t_frames = num_frames(n, cfg)
    xp = pad_signal(x, cfg).contiguous()
    basis = _const("forward", cfg, x.device)
    f2 = basis.shape[1]
    _build.check(xp, (b, xp.shape[1]), "x")
    out = x.new_empty(b, t_frames, f2)
    _build.launch("se_stft_fwd", xp, basis, out, b, xp.shape[1], t_frames,
                  cfg.frame_len, f2, cfg.hop)
    _build.LAUNCHES["stft"] += 1
    return out[..., :cfg.bins], out[..., cfg.bins:]


def stft_auto(x: torch.Tensor, cfg: StftConfig):
    """`stft_fused` for a 2-D waveform whose configuration it takes (on the
    CPU that is its plain twin), the plain `stft` otherwise (other ranks,
    frame_len % hop != 0 as Uformer's center 512/160). Decided from the
    device and shapes only."""
    if x.ndim == 2 and cfg.frame_len % cfg.hop == 0:
        return stft_fused(x, cfg)
    return _reference(x, cfg)
