"""FullSubNet (Hao et al., ICASSP 2021, arXiv:2010.15508) in plain
PyTorch, from the benchmark's state_dict: the enhance call and the
training step of the configuration `configs/fullsubnet-fp32.json`.

The network: a full-band 2-layer LSTM on the offline-Laplace-normalised
magnitude (look-ahead frames padded at the end), a Linear and ReLU; per
bin the 2n+1 reflected neighbours of the magnitude and the full-band
output, normalised again, into a sub-band 2-layer LSTM on the (B F, T, .)
fold, a Linear to the two components of the cIRM; the look-ahead frames
cut off the front. In training, at a batch above one, `drop_band` keeps
half of the bins: samples of even index the even bins, odd the odd ones,
grouped in that order. The LSTMs train one bias a gate (the stored
`bias_ih + bias_hh`, `bias_hh` a zero buffer), as the JAX package does.

The enhance call follows the port's decode of the "cirm" io-kind: the
per-utterance RMS gain, the STFT, magnitude**0.5, the mask times the
compressed complex spectrum, the magnitude squared back, the iSTFT, the
gain removed. The step: the same features of mix and clean, the mask,
the complex estimate, 0.5 RI-MSE + 0.5 magnitude MSE over valid frames,
the gradients clipped to a global norm of 5 and Adam (optax's defaults).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.common import (
    FP32, Precision, istft, linear, lstm_layer, rms_gain, stft,
)


def trainable(name: str) -> bool:
    """The state_dict entries a step trains: all but the LSTMs' bias_hh
    (zero; the gate bias is one, bias_ih)."""
    return ".bias_hh_" not in name


def _laplace(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=tuple(range(1, x.ndim)), keepdim=True)
    return x / (mu + 1e-5)


def _neighbours(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, T, F) -> (B, T, F, 2n+1): bin f's neighbours f-n .. f+n, the
    edges reflected."""
    if n == 0:
        return x[..., None]
    xp = F.pad(x, (n, n), mode="reflect")
    return xp.unfold(-1, 2 * n + 1, 1)


def drop_band(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, T, F, C) -> (B, T, F // groups, C), group g: samples g, g + G,
    ... with bins g, g + G, ..., the groups one after the other."""
    f = x.shape[2] - x.shape[2] % groups
    return torch.cat([x[g::groups, :, g:f:groups] for g in range(groups)])


def _group_rows(x: torch.Tensor, groups: int) -> torch.Tensor:
    return torch.cat([x[g::groups] for g in range(groups)])


def _sequence(x, sd: dict, prefix: str, layers: int, p: Precision):
    for k in range(layers):
        lstm = f"{prefix}.sequence_model"
        x = lstm_layer(x, sd[f"{lstm}.weight_ih_l{k}"],
                       sd[f"{lstm}.weight_hh_l{k}"],
                       sd[f"{lstm}.bias_ih_l{k}"] + sd[f"{lstm}.bias_hh_l{k}"],
                       p)
    return linear(x, sd, f"{prefix}.fc_output_layer", p)


def network(sd: dict, mag: torch.Tensor, cfg: dict, train: bool = False,
            p: Precision = FP32) -> torch.Tensor:
    """(B, T, F) noisy magnitude -> (B', T, F', 2) cIRM (B', F' = B, F
    but in training at B > 1: drop_band's)."""
    model = cfg["model"]
    la = model["look_ahead"]
    b, _, f = mag.shape
    mag = F.pad(mag, (0, 0, 0, la))
    t = mag.shape[1]
    fb = torch.relu(_sequence(_laplace(mag), sd, "fb_model", 2, p))
    sb = _laplace(torch.cat([_neighbours(mag, model["sb_num_neighbors"]),
                             _neighbours(fb, model["fb_num_neighbors"])], -1))
    if train and b > 1:
        sb = drop_band(sb, cfg["drop_band_groups"])
        b, f = sb.shape[0], sb.shape[2]
    folded = sb.transpose(1, 2).reshape(b * f, t, sb.shape[-1])
    mask = _sequence(folded, sd, "sb_model", 2, p)
    return mask.reshape(b, f, t, 2).transpose(1, 2)[:, la:]


def _features(wav: torch.Tensor, cfg: dict):
    """(B, N) -> (compressed magnitude, cos, sin of the phase), (B, T, F)."""
    st = cfg["stft"]
    re, im = stft(wav, st["n_fft"], st["hop"], st["win_length"])
    phase = torch.atan2(im, re)
    mag = torch.sqrt(re * re + im * im)
    if cfg["compressed"]:
        mag = torch.sqrt(mag)
    return mag, torch.cos(phase), torch.sin(phase)


def enhance(sd: dict, wav: torch.Tensor, cfg: dict,
            p: Precision = FP32) -> torch.Tensor:
    """(B, N) noisy waveforms -> (B, N) estimates."""
    gain = rms_gain(wav)
    mag, cos, sin = _features(wav * gain, cfg)
    mask = network(sd, mag, cfg, False, p)
    m_re, m_im = mask[..., 0], mask[..., 1]
    f_re, f_im = mag * cos, mag * sin
    o_re = m_re * f_re - m_im * f_im
    o_im = m_re * f_im + m_im * f_re
    if cfg["compressed"]:
        scale = torch.sqrt(o_re * o_re + o_im * o_im)
        o_re, o_im = o_re * scale, o_im * scale
    st = cfg["stft"]
    est = istft(o_re, o_im, st["n_fft"], st["hop"], st["win_length"],
                wav.shape[-1])
    return est / gain


def _magnitude(pairs: torch.Tensor) -> torch.Tensor:
    sq = pairs.square().sum(-1)
    live = sq > 0
    return torch.where(live, torch.sqrt(torch.where(live, sq, 1.0)), 0.0)


def loss(sd: dict, batch: dict, cfg: dict, p: Precision = FP32):
    """The training loss of one batch ({"mix", "clean": (B, N), "frames":
    (B,)}) in train mode."""
    with torch.no_grad():
        mag, cos, sin = _features(batch["mix"], cfg)
        lmag, lcos, lsin = _features(batch["clean"], cfg)
        spec = torch.stack([mag * cos, mag * sin], -1)
        lspec = torch.stack([lmag * lcos, lmag * lsin], -1)
    mask = network(sd, mag, cfg, True, p)
    frames = batch["frames"]
    if mask.shape[2] != spec.shape[2]:
        g = cfg["drop_band_groups"]
        spec, lspec = drop_band(spec, g), drop_band(lspec, g)
        frames = _group_rows(frames, g)
    m_re, m_im = mask[..., 0], mask[..., 1]
    est = torch.stack([m_re * spec[..., 0] - m_im * spec[..., 1],
                       m_re * spec[..., 1] + m_im * spec[..., 0]], -1)
    t_len, f_len = est.shape[1], est.shape[2]
    valid = (torch.arange(t_len, device=est.device)[None]
             < frames[:, None]).float()
    n_valid = valid.sum()
    mag_err = ((_magnitude(est) - _magnitude(lspec)) * valid[..., None])
    mag_mse = mag_err.square().sum() / (n_valid * f_len)
    com_mse = ((est - lspec) * valid[..., None, None]).square().sum() \
        / (2.0 * n_valid * f_len)
    return 0.5 * (mag_mse + com_mse)


def train_steps(sd: dict, batches: list, cfg: dict, p: Precision = FP32):
    """`len(batches)` training steps from the weights `sd` (not changed):
    -> {"losses": [float], "grad1": the first step's clipped gradient
    by name, "params": the trained entries after the last step}."""
    tcfg = cfg["train"]
    params = {n: t.detach().clone().requires_grad_(trainable(n))
              for n, t in sd.items()}
    names = [n for n in params if trainable(n)]
    mu = {n: torch.zeros_like(params[n]) for n in names}
    nu = {n: torch.zeros_like(params[n]) for n in names}
    b1, b2, eps = tcfg["adam_b1"], tcfg["adam_b2"], tcfg["adam_eps"]
    out = {"losses": []}
    for step, batch in enumerate(batches, start=1):
        value = loss(params, batch, cfg, p)
        grads = torch.autograd.grad(value, [params[n] for n in names])
        out["losses"].append(float(value.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.where(norm < tcfg["grad_clip"], 1.0,
                                tcfg["grad_clip"] / norm)
            grads = [g * scale for g in grads]
            if step == 1:
                out["grad1"] = {n: g.clone() for n, g in zip(names, grads)}
            c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for n, g in zip(names, grads):
                mu[n].mul_(b1).add_(g, alpha=1.0 - b1)
                nu[n].mul_(b2).add_(g * g, alpha=1.0 - b2)
                u = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps)
                params[n].sub_(tcfg["learning_rate"] * u)
        del value, grads
    out["params"] = {n: params[n].detach() for n in names}
    return out
