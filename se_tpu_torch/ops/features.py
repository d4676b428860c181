"""Feature utilities: the port of se_tpu/ops/features.py.

Covers the FullSubNet feature library (ref FullSubNet/fullsubnet_net_sa/
feature.py:10-235) and trans.py's feature helpers (splice, speed-perturb
filter, pre-emphasis — ref Uformer/trans.py:186-254).

The numpy host-side helpers (amplitude norm, dB-FS tailoring, clipping,
VAD, subsampling, the speed-perturb filter) are copies of se_tpu's; its
jnp functions (magnitude and phase, pre-emphasis, splice, overlap_cat,
IPD, LPS) are torch here. No model, driver or trainer of either package
calls them.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# --------------------------------------------------------- host-side (numpy)

def norm_amplitude(y: np.ndarray, scalar: float | None = None, eps=1e-6):
    """(ref feature.py:89-93)."""
    if not scalar:
        scalar = float(np.max(np.abs(y))) + eps
    return y / scalar, scalar


def tailor_db_fs(y: np.ndarray, target_db_fs: float = -25.0, eps=1e-6):
    """Scale to a target dB-FS RMS (ref feature.py:96-100)."""
    rms = float(np.sqrt(np.mean(y**2)))
    scalar = 10 ** (target_db_fs / 20) / (rms + eps)
    return y * scalar, rms, scalar


def is_clipped(y: np.ndarray, clipping_threshold: float = 0.999) -> bool:
    """(ref feature.py:103-104)."""
    return bool(np.any(np.abs(y) > clipping_threshold))


def subsample(data: np.ndarray, sub_sample_length: int,
              start_position: int = -1,
              rng: np.random.Generator | None = None):
    """Random fixed-length crop with zero-pad (ref feature.py:140-166)."""
    length = len(data)
    if length > sub_sample_length:
        if start_position < 0:
            r = rng or np.random.default_rng()
            start_position = int(r.integers(length - sub_sample_length))
        data = data[start_position : start_position + sub_sample_length]
    elif length < sub_sample_length:
        data = np.append(
            data, np.zeros(sub_sample_length - length, dtype=np.float32))
    return data


def aligned_subsample(a: np.ndarray, b: np.ndarray, sub_sample_length: int,
                      rng: np.random.Generator | None = None):
    """(ref feature.py:116-138)."""
    if a.shape[-1] > sub_sample_length:
        r = rng or np.random.default_rng()
        start = int(r.integers(a.shape[-1] - sub_sample_length + 1))
        sl = slice(start, start + sub_sample_length)
        return a[..., sl], b[..., sl]
    if a.shape[-1] < sub_sample_length:
        pad = [(0, 0)] * (a.ndim - 1) + [(0, sub_sample_length - a.shape[-1])]
        return np.pad(a, pad), np.pad(b, pad)
    return a, b


def activity_detector(audio: np.ndarray, fs: int = 16000,
                      activity_threshold: float = 0.13,
                      target_level: float = -25.0, eps=1e-6) -> float:
    """Fraction of 50 ms windows above a smoothed energy threshold
    (ref feature.py:186-226)."""
    audio, _, _ = tailor_db_fs(audio, target_level)
    window_samples = int(fs * 50 / 1000)
    prev_energy_prob = 0.0
    active = 0
    cnt = 0
    a, b = -1.0, 0.2
    alpha_rel, alpha_att = 0.05, 0.8
    for start in range(0, len(audio), window_samples):
        win = audio[start : start + window_samples]
        frame_rms = 20 * np.log10(float(np.sum(win**2)) + eps)
        prob = 1.0 / (1.0 + math.exp(-(a + b * frame_rms)))
        if prob > prev_energy_prob:
            smoothed = prob * alpha_att + prev_energy_prob * (1 - alpha_att)
        else:
            smoothed = prob * alpha_rel + prev_energy_prob * (1 - alpha_rel)
        if smoothed > activity_threshold:
            active += 1
        prev_energy_prob = prob
        cnt += 1
    return active / max(cnt, 1)


def speed_perturb_filter(src_sr: int, dst_sr: int, cutoff_ratio: float = 0.95,
                         num_zeros: int = 64) -> np.ndarray:
    """Polyphase speed-perturb filter bank (ref Uformer/trans.py:186-217)."""
    gcd = math.gcd(src_sr, dst_sr)
    src_sr //= gcd
    dst_sr //= gcd
    if src_sr == 1 or dst_sr == 1:
        raise ValueError("integer resampling factors are not supported")
    zeros_per_block = min(src_sr, dst_sr) * cutoff_ratio
    padding = 1 + int(num_zeros / zeros_per_block)
    times = (np.arange(dst_sr)[:, None, None] / float(dst_sr)
             - np.arange(src_sr)[None, :, None] / float(src_sr)
             - np.arange(2 * padding + 1)[None, None, :] + padding)
    window = np.heaviside(1 - np.abs(times / padding), 0.0) * (
        0.5 + 0.5 * np.cos(times / padding * math.pi))
    weight = (np.sinc(times * zeros_per_block) * window * zeros_per_block
              / src_sr)
    return weight.astype(np.float32)


# ----------------------------------------------------------- in-graph (torch)

def mag_phase(re: torch.Tensor, im: torch.Tensor):
    """(ref feature.py:85-86)."""
    return torch.sqrt(re * re + im * im), torch.atan2(im, re)


def pre_emphasis(x: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """x[t] - coeff * x[t-1] (ref Uformer/trans.py pre-emphasis option)."""
    return torch.cat([x[..., :1], x[..., 1:] - coeff * x[..., :-1]], -1)


def splice_feature(feats: torch.Tensor, lctx: int = 1, rctx: int = 1,
                   subsampling_factor: int = 1, op: str = "cat"
                   ) -> torch.Tensor:
    """Context splicing with edge clamping (ref Uformer/trans.py:220-254):
    frames (axis -2) from t - lctx to t + rctx, clamped to the
    utterance, concatenated on the last axis ("cat") or stacked on a new
    one."""
    if lctx + rctx == 0:
        return feats
    t = feats.shape[-2]
    t -= t % subsampling_factor
    ctx = []
    for c in range(-lctx, rctx + 1):
        idx = torch.from_numpy(np.clip(np.arange(c, c + t), 0, t - 1))
        ctx.append(torch.index_select(feats, -2, idx.to(feats.device)))
    return torch.cat(ctx, -1) if op == "cat" else torch.stack(ctx, -1)


def overlap_cat(chunks, axis: int = -1) -> torch.Tensor:
    """50%-overlap chunk stitching (ref feature.py:169-183)."""
    out = []
    for i, chunk in enumerate(chunks):
        half = chunk.shape[axis] // 2
        first, last = torch.split(chunk, [half, chunk.shape[axis] - half],
                                  dim=axis)
        if i == 0:
            out += [first, last]
        else:
            out[-1] = (out[-1] + first) / 2
            out.append(last)
    return torch.cat(out, dim=axis)


def compute_ipd(phase: torch.Tensor, mic_pairs
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inter-channel phase differences for multichannel features
    (ref FullSubNet feature.py:493-502). phase: (B, M, T, F)."""
    left = [p[0] for p in mic_pairs]
    right = [p[1] for p in mic_pairs]
    diff = phase[:, left] - phase[:, right]
    return torch.cos(diff), torch.sin(diff)


def compute_lps(mag: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Log power spectrum (ref FullSubNet feature.py LPS branch)."""
    return torch.log(torch.square(mag) + eps)
