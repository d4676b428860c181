"""The masked loss library: the port of se_tpu/train/losses.py, each loss
with se_tpu's name, conventions and quirks (line numbers there).

Conventions: spectra are (B, T, F) magnitudes or (B, T, F, 2) complex
pairs; waveforms are (B, N). `frames` is the per-utterance valid frame
count (the reference's `frame_mask_list`); everything is vectorized, no
loop over the batch.

Under an active mesh (`parallel.activation_mesh`) each rank holds its
rows of the global batch, and a loss is this rank's share of the global
batch's loss: the local numerator over the global denominator, so the
ranks' losses, and their gradients, sum to one device's. Two kinds:
- masked: the denominator counts valid frames or kept utterances, which
  differ from rank to rank; it is all-reduced (`global_sum`):
  `mag_mse_loss`, `com_mse_loss`, and through them `com_mag_mse_loss`,
  `mse_com_mag_mse_loss`, `stagewise_com_mag_mse_loss`; and
  `uformer_sisnr_loss`'s count of utterances it keeps;
- plain means over the batch: every rank's shard has as many rows, so
  the global denominator is the local one times the "data" size, and no
  collective is needed (`_mean`): `sisdr_loss`, `snr_loss`,
  `fusion_snr_loss`, `StftmLoss`, `uformer_cplx_mse_loss`,
  `uformer_mag_mse_loss`, the two sub-band losses, `uformer_time_mae_loss`
  and `uformer_bce_loss`.
"""

from __future__ import annotations

import numpy as np
import torch

from se_tpu_torch.parallel.mesh import data_size, global_sum

EPSILON = 1e-12


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch's rows, as this rank's share: x's
    mean divided by the "data" size (1 without a mesh)."""
    n = data_size()
    return x.mean() if n == 1 else x.mean() / n


def frame_mask(frames: torch.Tensor, t_max: int) -> torch.Tensor:
    """(B,) valid frame counts -> (B, t_max) 0/1 mask."""
    t = torch.arange(t_max, device=frames.device)
    return (t[None, :] < frames[:, None]).float()


def sample_mask_from_frames(frames: torch.Tensor, n_max: int,
                            hop: int) -> torch.Tensor:
    """Waveform-domain mask with the reference's (frames - 1) * hop length
    (ref DCCRN/Backup.py:128; se_tpu :29-34)."""
    lengths = (frames - 1) * hop
    n = torch.arange(n_max, device=frames.device)
    return (n[None, :] < lengths[:, None]).float()


def mag_mse_loss(esti, label, frames):
    """(B, T, F) masked MSE, over valid frames x F (:37-41)."""
    m = frame_mask(frames, esti.shape[1])[..., None]
    denom = global_sum(m.sum()) * esti.shape[-1]
    return ((esti - label) * m).square().sum() / denom


def com_mse_loss(esti, label, frames):
    """(B, T, F, 2) masked MSE over both components (:44-48)."""
    m = frame_mask(frames, esti.shape[1])[..., None, None]
    denom = 2.0 * global_sum(m.sum()) * esti.shape[-2]
    return ((esti - label) * m).square().sum() / denom


def magnitude(pairs: torch.Tensor) -> torch.Tensor:
    """sqrt(re^2 + im^2 + 0.0) over the last axis, with no floor, as
    se_tpu's losses take it, but with the gradient 0 where the magnitude
    is exactly 0: se_tpu's is 0 / 0 = NaN there, and a bf16 step meets
    it (one estimate bin whose two components both round to 0 turned
    every gradient of a TaylorSENet step NaN)."""
    sq = pairs.square().sum(-1)
    live = sq > 0
    return torch.where(live, torch.sqrt(torch.where(live, sq, 1.0) + 0.0),
                       0.0)


def com_mag_mse_loss(esti, label, frames):
    """0.5 RI-MSE + 0.5 mag-MSE, the magnitude sqrt(re^2 + im^2 + 0.0)
    with no floor (:51-56; `magnitude`)."""
    mag_e = magnitude(esti)
    mag_l = magnitude(label)
    return 0.5 * (mag_mse_loss(mag_e, mag_l, frames)
                  + com_mse_loss(esti, label, frames))


def mse_com_mag_mse_loss(esti_mag, esti, label_mag, label, frames,
                         alpha: float = 0.2):
    """alpha mag MSE + (1 - alpha) com+mag MSE (:59-62)."""
    return (alpha * mag_mse_loss(esti_mag, label_mag, frames)
            + (1.0 - alpha) * com_mag_mse_loss(esti, label, frames))


def stagewise_com_mag_mse_loss(stage_estis, label, frames):
    """The mean of com_mag_mse over the stages' outputs (:65-69)."""
    losses = [com_mag_mse_loss(e, label, frames) for e in stage_estis]
    return sum(losses) / len(losses)


def sisdr_loss(esti, label, frames, hop: int, eps: float = EPSILON):
    """Masked SI-SDR on waveforms (:76-87): eps is added to the ratio
    outside the division, as the reference does; DCCRN_SNR passes 2e-7."""
    m = sample_mask_from_frames(frames, esti.shape[-1], hop)
    e, l = esti * m, label * m
    s_t = ((e * l).sum(-1, keepdim=True)
           / ((l * l).sum(-1, keepdim=True) + eps)) * l
    e_n = e - s_t
    ratio = s_t.square().sum(-1) / e_n.square().sum(-1) + eps
    return _mean(-10.0 * torch.log10(ratio))


def snr_loss(esti, label, frames, hop: int):
    """Masked SNR loss (:90-96)."""
    m = sample_mask_from_frames(frames, esti.shape[-1], hop)
    e, l = esti * m, label * m
    ratio = l.square().sum(-1) / ((l - e).square().sum(-1) + EPSILON) \
        + EPSILON
    return _mean(-10.0 * torch.log10(ratio))


def fusion_snr_loss(esti, label, lengths):
    """0.5 SI-SNR + 0.5 SV-SNR over masked waveforms (:99-112); the
    SV-SNR term has no EPSILON in its denominator (:110)."""
    n = torch.arange(esti.shape[-1], device=esti.device)
    m = (n[None, :] < lengths[:, None]).float()
    e, l = esti * m, label * m
    s_t = l * (e * l).sum(-1, keepdim=True) / (
        l.square().sum(-1, keepdim=True) + EPSILON)
    e_n = e - s_t
    loss1 = _mean(-10.0 * torch.log10(
        s_t.square().sum(-1) / (e_n.square().sum(-1) + EPSILON) + EPSILON))
    loss2 = _mean(-10.0 * torch.log10(
        l.square().sum(-1) / (e - l).square().sum(-1) + EPSILON))
    return 0.5 * (loss1 + loss2)


class StftmLoss:
    """STFT-magnitude-components L1 by DFT matmul (:115-140): valid
    framing, the symmetric Hamming window, the full n-point DFT."""

    def __init__(self, frame_size: int = 512, frame_shift: int = 256):
        self.frame_size = frame_size
        self.frame_shift = frame_shift
        n = frame_size
        idx = np.arange(n)
        ang = 2.0 * np.pi * np.outer(idx, idx) / n
        w = np.hamming(n)  # symmetric, as the reference
        self.dr = torch.from_numpy((np.cos(ang) * w[:, None])
                                   .astype(np.float32))
        self.di = torch.from_numpy((-np.sin(ang) * w[:, None])
                                   .astype(np.float32))

    def _frames(self, x):
        return x.unfold(-1, self.frame_size, self.frame_shift)

    def __call__(self, esti, label):
        dr, di = self.dr.to(esti.device), self.di.to(esti.device)
        fe, fl = self._frames(esti), self._frames(label)
        er, ei = fe @ dr, fe @ di
        lr, li = fl @ dr, fl @ di
        return _mean((lr - er).abs() + (li - ei).abs())


# ------------------------------------------------- Uformer loss set (loss.py)

def uformer_sisnr_loss(esti, label, eps: float = EPSILON):
    """Per-utterance SI-SNR with the mean removed over the whole utterance;
    utterances whose source has mean power below 1.2e-8 are skipped
    (:145-156, the skip at :155-156)."""
    x_zm = esti - esti.mean(-1, keepdim=True)
    s_zm = label - label.mean(-1, keepdim=True)
    t = ((x_zm * s_zm).sum(-1, keepdim=True) * s_zm
         / (s_zm.square().sum(-1, keepdim=True) + eps))
    num = torch.sqrt(t.square().sum(-1))
    den = torch.sqrt((x_zm - t).square().sum(-1))
    per_utt = -20.0 * torch.log10(eps + num / (den + eps))
    nonzero = (label.square().mean(-1) >= 1.2e-8).float()
    return (per_utt * nonzero).sum() / torch.clamp(global_sum(nonzero.sum()),
                                                   min=1.0)


def uformer_cplx_mse_loss(esti, label):
    """(B, T, F, 2): a per-utterance sum / F, then the mean / 2
    (:159-163)."""
    f = esti.shape[2]
    per = (esti - label).square().sum(dim=(1, 2, 3)) / f
    return _mean(per) / 2.0


def uformer_mag_mse_loss(esti, label):
    """(B, T, F, 2) -> the MSE of sqrt(max(re^2 + im^2, EPSILON))
    (:166-173)."""
    me = torch.sqrt(torch.clamp(esti.square().sum(-1), min=EPSILON))
    ml = torch.sqrt(torch.clamp(label.square().sum(-1), min=EPSILON))
    f = esti.shape[2]
    return _mean((me - ml).square().sum(dim=(1, 2)) / f)


_SUBBAND_W4 = (1.5, 1.2, 0.8, 0.5)


def _bands(x):
    """(B, T, F', ...) -> (..., 4): F' in four equal bands on a new last
    axis (jnp.stack(jnp.split(x, 4, axis=2), axis=-1))."""
    return torch.stack(torch.chunk(x, 4, dim=2), dim=-1)


def uformer_cplx_mse_subband_loss(esti, label):
    """4-band weighted complex MSE with the DC bin stripped (:179-188)."""
    e, l = esti[:, :, 1:], label[:, :, 1:]
    f = e.shape[2]
    w = torch.tensor(_SUBBAND_W4, device=esti.device)
    per = (_bands(e) - _bands(l)).square().sum(dim=(1, 2, 3)) * w  # (B, 4)
    return per.sum() / (e.shape[0] * data_size()) / f / 2.0


def uformer_mag_mse_subband_loss(esti, label):
    """4-band weighted magnitude MSE with the DC bin stripped (:191-205);
    divided by T, not F', as the reference (:201-205: it divides by
    shape[2] after its chunk and stack, the time axis there)."""
    me = torch.sqrt(torch.clamp(esti.square().sum(-1), min=EPSILON))
    ml = torch.sqrt(torch.clamp(label.square().sum(-1), min=EPSILON))
    me, ml = me[:, :, 1:], ml[:, :, 1:]
    w = torch.tensor(_SUBBAND_W4, device=esti.device)
    per = (_bands(me) - _bands(ml)).square().sum(dim=(1, 2)) * w
    return per.sum() / (me.shape[0] * data_size()) / me.shape[1]


def uformer_time_mae_loss(esti, label):
    """(:208-210)."""
    return _mean((esti - label).abs().sum(-1))


def uformer_bce_loss(output, target):
    """Summed BCE / (B T), the output clipped to [1e-7, 1 - 1e-7]
    (:213-218)."""
    eps = 1e-7
    o = torch.clamp(output, eps, 1.0 - eps)
    bce = -(target * torch.log(o) + (1.0 - target) * torch.log(1.0 - o))
    return bce.sum() / (output.shape[0] * data_size()) / output.shape[1]


def uformer_accuracy(output, target):
    """(:221-226)."""
    pred = (output > 0.5).float()
    err = (pred - target).abs().sum()
    total = float(np.prod(output.shape))
    return (total - err) / total
