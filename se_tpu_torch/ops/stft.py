"""STFT / iSTFT as matmul-DFT, the port of se_tpu/ops/stft.py.

Framing is a shift-and-concat of hop-sized slots when `frame_len % hop ==
0`, a strided gather otherwise; the windowed DFT is one `(B*T, L) @ (L, 2F)`
product and the inverse the transposed basis followed by a shift-and-add
overlap-add. The formulation (and so the order of the sums) is se_tpu's,
not torch.stft's.

Three framing conventions:

- ``center``:  reflect-pad n_fft//2 on both sides, frame length n_fft,
  window center-padded to n_fft, 1 + n//hop frames;
- ``pad_end``: frame length win, zero-pad the frame tail, ceil(n/hop)
  frames; synthesis with the periodized inverse window;
- ``valid``:   frame length win, 1 + (n-win)//hop frames.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from se_tpu_torch.ops.windows import get_window

Convention = str  # "center" | "pad_end" | "valid"


@dataclasses.dataclass(frozen=True)
class StftConfig:
    """Static STFT configuration (hashable)."""

    win_length: int
    hop: int
    n_fft: int | None = None
    window: str = "hann"
    convention: Convention = "center"
    periodic: bool = True
    # "ola" = divide by the overlap-added window-square envelope;
    # "periodized" = fold the periodized inverse window into the basis.
    synthesis_norm: str = "ola"

    @property
    def fft(self) -> int:
        return self.n_fft if self.n_fft is not None else self.win_length

    @property
    def bins(self) -> int:
        return self.fft // 2 + 1

    @property
    def frame_len(self) -> int:
        """Length of the extracted signal frame before the DFT."""
        return self.fft if self.convention == "center" else self.win_length


PRESET_320 = StftConfig(win_length=320, hop=160, n_fft=320)
PRESET_512_256 = StftConfig(win_length=512, hop=256, n_fft=512)
PRESET_512_128 = StftConfig(win_length=512, hop=128, n_fft=512)
PRESET_UFORMER = StftConfig(win_length=400, hop=160, n_fft=512, window="hann")
PRESET_DEEPXI = StftConfig(
    win_length=512, hop=256, n_fft=512, window="hamming", convention="pad_end"
)


def num_frames(n: int, cfg: StftConfig) -> int:
    if cfg.convention == "center":
        return 1 + n // cfg.hop
    if cfg.convention == "pad_end":
        return -(-n // cfg.hop)
    if cfg.convention == "valid":
        return 1 + (n - cfg.win_length) // cfg.hop
    raise ValueError(f"unknown convention {cfg.convention!r}")


def _padded_window(cfg: StftConfig) -> np.ndarray:
    """Window placed inside the frame (center-padded to n_fft for `center`)."""
    w = get_window(cfg.window, cfg.win_length, cfg.periodic).astype(np.float64)
    if cfg.convention == "center" and cfg.win_length < cfg.fft:
        lpad = (cfg.fft - cfg.win_length) // 2
        w = np.pad(w, (lpad, cfg.fft - cfg.win_length - lpad))
    return w


@functools.lru_cache(maxsize=None)
def _forward_basis(cfg: StftConfig) -> np.ndarray:
    """(frame_len, 2*bins) windowed real-DFT basis: out = frames @ basis.
    Columns [0:F] are the real part, [F:2F] the imaginary part."""
    n = cfg.fft
    w = _padded_window(cfg)
    frame_len = cfg.frame_len
    l_idx = np.arange(frame_len, dtype=np.float64)
    f_idx = np.arange(cfg.bins, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(l_idx, f_idx) / n
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    basis *= w[:frame_len, None]
    return basis.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _inverse_basis(cfg: StftConfig) -> np.ndarray:
    """(2*bins, frame_len) basis for the windowed irfft: frames = X_ri @
    basis, times the synthesis window (the analysis window for `center` and
    `valid`; the periodized inverse window for `pad_end`)."""
    n = cfg.fft
    f_bins = cfg.bins
    frame_len = cfg.frame_len
    l_idx = np.arange(frame_len, dtype=np.float64)
    f_idx = np.arange(f_bins, dtype=np.float64)
    coef = np.full(f_bins, 2.0)
    coef[0] = 1.0
    if n % 2 == 0:
        coef[-1] = 1.0
    ang = 2.0 * np.pi * np.outer(f_idx, l_idx) / n
    re_rows = coef[:, None] * np.cos(ang) / n
    im_rows = -coef[:, None] * np.sin(ang) / n
    basis = np.concatenate([re_rows, im_rows], axis=0)

    w = _padded_window(cfg)[:frame_len]
    if cfg.convention == "pad_end" or cfg.synthesis_norm == "periodized":
        env = np.zeros(frame_len)
        k_max = frame_len // cfg.hop + 1
        for k in range(-k_max, k_max + 1):
            idx = np.arange(frame_len) + k * cfg.hop
            valid = (idx >= 0) & (idx < frame_len)
            env[valid] += w[idx[valid]] ** 2
        synth = np.where(env > 1e-30, w / env, 0.0)
    else:
        synth = w
    basis *= synth[None, :]
    return basis.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _const(name: str, cfg: StftConfig, device: torch.device) -> torch.Tensor:
    """A basis or window of `cfg` as a tensor on `device`, made once."""
    if name == "forward":
        arr = _forward_basis(cfg)
    elif name == "inverse":
        arr = _inverse_basis(cfg)
    else:
        arr = _padded_window(cfg)[: cfg.frame_len].astype(np.float32)
    return torch.from_numpy(arr).to(device)


def _pad_last(x: torch.Tensor, lo: int, hi: int, mode: str = "constant"):
    if mode == "reflect":
        lead = x.shape[:-1]
        y = F.pad(x.reshape(-1, 1, x.shape[-1]), (lo, hi), mode="reflect")
        return y.reshape(*lead, y.shape[-1])
    return F.pad(x, (lo, hi))


def frame_signal(x: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """(..., n) waveform -> (..., T, frame_len) frames."""
    n = x.shape[-1]
    t_frames = num_frames(n, cfg)
    hop = cfg.hop
    frame_len = cfg.frame_len

    if cfg.convention == "center":
        pad = cfg.fft // 2
        x = _pad_last(x, pad, pad, mode="reflect")
    elif cfg.convention == "pad_end":
        total = (t_frames - 1) * hop + frame_len
        x = _pad_last(x, 0, total - n)

    needed = (t_frames - 1) * hop + frame_len
    if x.shape[-1] < needed:  # center with n % hop != 0 may fall short
        x = _pad_last(x, 0, needed - x.shape[-1])

    if frame_len % hop == 0:
        k = frame_len // hop
        slots = x[..., : (t_frames + k - 1) * hop]
        slots = slots.reshape(*x.shape[:-1], t_frames + k - 1, hop)
        parts = [slots[..., j : j + t_frames, :] for j in range(k)]
        return torch.cat(parts, dim=-1)

    starts = torch.arange(t_frames, device=x.device) * hop
    idx = starts[:, None] + torch.arange(frame_len, device=x.device)[None, :]
    return x[..., idx]


def stft(x: torch.Tensor, cfg: StftConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., n) waveform -> ((..., T, F) real, (..., T, F) imag)."""
    frames = frame_signal(x, cfg)
    out = torch.matmul(frames, _const("forward", cfg, x.device).to(x.dtype))
    f_bins = cfg.bins
    return out[..., :f_bins], out[..., f_bins:]


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., T, L) frames -> (..., (T-1)*hop + L) via shift-and-add."""
    *lead, t_frames, frame_len = frames.shape
    k = -(-frame_len // hop)
    if k * hop != frame_len:
        frames = F.pad(frames, (0, k * hop - frame_len))
    segs = frames.reshape(*lead, t_frames, k, hop)
    n_slots = t_frames + k - 1
    out = frames.new_zeros((*lead, n_slots, hop))
    for j in range(k):
        out[..., j : j + t_frames, :] += segs[..., j, :]
    out = out.reshape(*lead, n_slots * hop)
    return out[..., : (t_frames - 1) * hop + frame_len]


def istft(re: torch.Tensor, im: torch.Tensor, cfg: StftConfig,
          length: int | None = None) -> torch.Tensor:
    """((..., T, F), (..., T, F)) -> (..., n) waveform.

    `center`/`valid` divide by the overlap-added squared-window envelope
    where it exceeds 1e-11; `pad_end` folds the periodized inverse window
    into the basis."""
    t_frames = re.shape[-2]
    x_ri = torch.cat([re, im], dim=-1)
    frames = torch.matmul(x_ri, _const("inverse", cfg, re.device).to(re.dtype))
    out = overlap_add(frames, cfg.hop)

    if cfg.convention in ("center", "valid") and cfg.synthesis_norm == "ola":
        w = _const("window", cfg, re.device)
        wsq = (w * w).expand(t_frames, cfg.frame_len)
        env = overlap_add(wsq, cfg.hop)
        out = torch.where(env > 1e-11, out / env.clamp(min=1e-11), out)

    if cfg.convention == "center":
        out = out[..., cfg.fft // 2:]
    if length is not None:
        pad = length - out.shape[-1]
        out = _pad_last(out, 0, pad) if pad > 0 else out[..., :length]
    return out
