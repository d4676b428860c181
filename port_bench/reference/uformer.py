"""Uformer (Fu et al., ICASSP 2022, arXiv:2111.06015) in plain PyTorch,
from the benchmark's state_dict: the enhance call of the configuration
`configs/uformer-fp32.json` (eval mode, uncompressed regime).

A complex and a magnitude U-net of six levels each (channels 1, 8, 16,
32, 64, 128, 128), the branches fused after every level: re, im +=
sigmoid(mag), mag += sigmoid(sqrt(max(re^2 + im^2, eps))). An encoder
level is a (5, 2) conv over (F, T), stride 2 along F, padded 2 along F
and causally 1 along T, then BatchNorm (running statistics) and PReLU; a
complex conv is real_conv(re) - imag_conv(im), real_conv(im) +
imag_conv(re), each with its own bias. A decoder level takes [skip, x]
per component into a transposed (5, 2) conv, stride 2 along F, padding
2, output padding 1, the first T frames kept; BatchNorm and PReLU but at
the last level. The bottleneck, the dilated dual-path conformer on (B, T,
F, C): feed-forward (LayerNorm, Linear 64, PReLU, Linear, half residual),
axial attention over T then over F (the complex one as eight real
single-head attentions of width 16 combined as a complex product), eight
gated dilated DSConv blocks (dilations 1 .. 128 against 128 .. 1), a
second feed-forward and LayerNorms, fusing after each step. Heads: a
sigmoid magnitude mask, a tanh-bounded complex mask with its phase,
averaged on the noisy magnitude; the DC bin, stripped before the U-net,
padded back. STFT 512 points, a 400-point Hann window, hop 160; the
output length (T - 1) * hop. The enhance call adds the per-utterance RMS
gain around the network, as the port's decode does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.common import (
    EPS32, FP32, Precision, attention, istft, layer_norm, linear, prelu,
    rms_gain, stft,
)

CHANNELS = (1, 8, 16, 32, 64, 128, 128)
DILATIONS = (1, 2, 4, 8, 16, 32, 64, 128)
ATT = ("rrr", "rii", "iri", "iir", "rri", "rir", "irr", "iii")


def _fusion(re, im, mag):
    cmag = torch.sqrt(torch.clamp(re * re + im * im, min=EPS32))
    s = torch.sigmoid(mag)
    return re + s, im + s, mag + torch.sigmoid(cmag)


def _bn(x, sd, name, channel_dim: int):
    shape = [1] * x.ndim
    shape[channel_dim] = -1

    def v(key):
        return sd[f"{name}.{key}"].reshape(shape)

    return (x - v("running_mean")) * torch.rsqrt(v("running_var") + 1e-5) \
        * v("weight") + v("bias")


def _cconv(re, im, sd, name, conv, p: Precision, **kw):
    """A complex conv (NCHW) from real_conv and imag_conv; `conv` is
    Precision.conv2d or conv_transpose2d."""
    wr, br = sd[f"{name}.real_conv.weight"], sd[f"{name}.real_conv.bias"]
    wi, bi = sd[f"{name}.imag_conv.weight"], sd[f"{name}.imag_conv.bias"]
    shape = (1, -1, 1, 1)
    out_re = conv(re, wr, **kw) - conv(im, wi, **kw) \
        + (br - bi).reshape(shape)
    out_im = conv(im, wr, **kw) + conv(re, wi, **kw) \
        + (br + bi).reshape(shape)
    return out_re, out_im


def _rconv(x, sd, name, conv, **kw):
    return conv(x, sd[f"{name}.weight"], **kw) \
        + sd[f"{name}.bias"].reshape(1, -1, 1, 1)


def _encoder(i, re, im, mag, sd, p: Precision):
    pad = (1, 0, 2, 2)  # T causal, F both sides
    kw = {"stride": (2, 1)}
    re, im = _cconv(F.pad(re, pad), F.pad(im, pad), sd, f"encoder.{i}.0",
                    p.conv2d, p, **kw)
    slope = sd[f"encoder.{i}.2.weight"]
    re = prelu(_bn(re, sd, f"encoder.{i}.1", 1), slope)
    im = prelu(_bn(im, sd, f"encoder.{i}.1", 1), slope)
    mag = _rconv(F.pad(mag, pad), sd, f"encoder_real.{i}.0.conv",
                 p.conv2d, **kw)
    mag = prelu(_bn(mag, sd, f"encoder_real.{i}.1", 1),
                sd[f"encoder_real.{i}.2.weight"])
    return _fusion(re, im, mag)


def _decoder(i, re, im, mag, sd, p: Precision):
    t = re.shape[-1]
    kw = {"stride": (2, 1), "padding": (2, 0), "output_padding": (1, 0)}
    re, im = _cconv(re, im, sd, f"decoder.{i}.0", p.conv_transpose2d, p,
                    **kw)
    mag = _rconv(mag, sd, f"decoder_real.{i}.0.conv", p.conv_transpose2d,
                 **kw)
    re, im, mag = re[..., :t], im[..., :t], mag[..., :t]
    if f"decoder.{i}.1.weight" in sd:
        slope = sd[f"decoder.{i}.2.weight"]
        re = prelu(_bn(re, sd, f"decoder.{i}.1", 1), slope)
        im = prelu(_bn(im, sd, f"decoder.{i}.1", 1), slope)
        mag = prelu(_bn(mag, sd, f"decoder_real.{i}.1", 1),
                    sd[f"decoder_real.{i}.2.weight"])
    return _fusion(re, im, mag)


# ------------------------------------------------------------ conformer
# on (B, T, F, C)

def _cdense(re, im, sd, name, p: Precision):
    r = linear(re, sd, f"{name}.real_linear", p) \
        - linear(im, sd, f"{name}.imag_linear", p)
    i = linear(im, sd, f"{name}.real_linear", p) \
        + linear(re, sd, f"{name}.imag_linear", p)
    return r, i


def _ff_cplx(re, im, sd, name, p):
    yr = layer_norm(re, sd, f"{name}.layernorm_linear")
    yi = layer_norm(im, sd, f"{name}.layernorm_linear")
    yr, yi = _cdense(yr, yi, sd, f"{name}.linear1", p)
    slope = sd[f"{name}.prelu.weight"]
    yr, yi = _cdense(prelu(yr, slope), prelu(yi, slope), sd,
                     f"{name}.linear2", p)
    return yr * 0.5 + re, yi * 0.5 + im


def _ff_real(x, sd, name, p):
    y = layer_norm(x, sd, f"{name}.layernorm_linear")
    y = prelu(linear(y, sd, f"{name}.linear1.linear", p),
              sd[f"{name}.prelu.weight"])
    return linear(y, sd, f"{name}.linear2.linear", p) * 0.5 + x


def _fold(x, axis):
    b, t, f, c = x.shape
    if axis == "t":
        return x.transpose(1, 2).reshape(b * f, t, c)
    return x.reshape(b * t, f, c)


def _unfold(x, axis, shape):
    b, t, f, _ = shape
    if axis == "t":
        return x.reshape(b, f, t, -1).transpose(1, 2)
    return x.reshape(b, t, f, -1)


def _qkv(sd, name, q, k, v, p):
    return (linear(q, sd, f"{name}.query.linear", p),
            linear(k, sd, f"{name}.key.linear", p),
            linear(v, sd, f"{name}.value.linear", p))


def _att_cplx(re, im, sd, axis, p):
    name = f"conformer.cplx_{axis}att"
    heads = f"{name}.attn_heads.0"
    proj = "T_att" if axis == "t" else "F_att"
    src = {"r": layer_norm(_fold(re, axis), sd, f"{heads}.layernorm1"),
           "i": layer_norm(_fold(im, axis), sd, f"{heads}.layernorm1")}
    outs = [attention(*_qkv(sd, f"{heads}.{proj}{k + 1}", src[sel[0]],
                            src[sel[1]], src[sel[2]], p), p)
            for k, sel in enumerate(ATT)]
    a, b, c, d, e, f, g, h = outs
    r = layer_norm(a - b - c - d, sd, f"{heads}.layernorm2")
    i = layer_norm(e + f + g - h, sd, f"{heads}.layernorm2")
    r, i = _cdense(r, i, sd, f"{name}.transform_linear", p)
    r, i = _unfold(r, axis, re.shape), _unfold(i, axis, re.shape)
    slope = sd[f"{name}.prelu.weight"]
    r = prelu(layer_norm(r, sd, f"{name}.layernorm3"), slope)
    i = prelu(layer_norm(i, sd, f"{name}.layernorm3"), slope)
    return r + re, i + im


def _att_real(x, sd, axis, p):
    name = f"conformer.mag_{axis}att"
    heads = f"{name}.attn_heads.0"
    proj = "T_att" if axis == "t" else "F_att"
    h = layer_norm(_fold(x, axis), sd, f"{heads}.layernorm1")
    h = attention(*_qkv(sd, f"{heads}.{proj}", h, h, h, p), p)
    h = layer_norm(h, sd, f"{heads}.layernorm2")
    h = _unfold(linear(h, sd, f"{name}.transform_linear.linear", p), axis,
                x.shape)
    return prelu(layer_norm(h, sd, f"{name}.layernorm3"),
                 sd[f"{name}.prelu.weight"]) + x


def _nchw(x):
    return x.permute(0, 3, 2, 1)  # (B, T, F, C) -> (B, C, F, T)


def _nhwc(x):
    return x.permute(0, 3, 2, 1)


def _dsconv(parts, sd, name, d1, d2, p):
    """One gated dilated DSConv block on the components `parts` ((re, im)
    or (mag,)), each (B, T, F, C); the convs over (F, T) with dilation
    (1, d) and padding (1, d)."""
    cplx = len(parts) == 2
    slope = sd[f"{name}.prelu.weight"]

    def conv(xs, conv_name, **kw):
        xs = [_nchw(x) for x in xs]
        if cplx:
            ys = _cconv(*xs, sd, f"{name}.{conv_name}", p.conv2d, p, **kw)
        else:
            ys = (_rconv(xs[0], sd, f"{name}.{conv_name}.conv", p.conv2d,
                         **kw),)
        return [_nhwc(y) for y in ys]

    ys = conv([layer_norm(x, sd, f"{name}.layernorm_conv1") for x in parts],
              "conv1x1")
    ys = [prelu(y, slope) for y in ys]
    z1 = conv(ys, "dconv1", padding=(1, d1), dilation=(1, d1))
    z2 = conv(ys, "dconv2", padding=(1, d2), dilation=(1, d2))
    zs = [layer_norm(a * torch.sigmoid(b), sd, f"{name}.layernorm_conv2")
          for a, b in zip(z1, z2)]
    zs = conv([z * torch.sigmoid(z) for z in zs], "sconv")
    return [x + z for x, z in zip(parts, zs)]


def _conformer(re, im, mag, sd, p):
    c = "conformer"
    re, im = _ff_cplx(re, im, sd, f"{c}.ff1_cplx", p)
    re, im, mag = _fusion(re, im, _ff_real(mag, sd, f"{c}.ff1_mag", p))
    for axis in ("t", "f"):
        re, im = _att_cplx(re, im, sd, axis, p)
        re, im, mag = _fusion(re, im, _att_real(mag, sd, axis, p))
    n = len(DILATIONS)
    for k, d1 in enumerate(DILATIONS):
        d2 = DILATIONS[n - 1 - k]
        re, im = _dsconv((re, im), sd, f"{c}.dsconv_cplx.{k}", d1, d2, p)
        (m,) = _dsconv((mag,), sd, f"{c}.dsconv_real.{k}", d1, d2, p)
        re, im, mag = _fusion(re, im, m)
    re, im = _ff_cplx(re, im, sd, f"{c}.ff2_cplx", p)
    re, im, mag = _fusion(re, im, _ff_real(mag, sd, f"{c}.ff2_mag", p))
    return (layer_norm(re, sd, f"{c}.ln_conformer_cplx"),
            layer_norm(im, sd, f"{c}.ln_conformer_cplx"),
            layer_norm(mag, sd, f"{c}.ln_conformer_mag"))


def _unit(a, b):
    bb = b + EPS32
    inv = torch.rsqrt(a * a + bb * bb)
    return a * inv, bb * inv


def network(sd: dict, wav: torch.Tensor, cfg: dict,
            p: Precision = FP32) -> torch.Tensor:
    """(B, N) waveform -> (B, (T - 1) * hop) estimate."""
    if cfg["model"]["compressed"]:
        raise ValueError("the reference runs Uformer's uncompressed regime")
    st = cfg["stft"]
    n_fft, hop, win = st["n_fft"], st["hop"], st["win_length"]
    n_re, n_im = stft(wav, n_fft, hop, win)  # (B, T, F)
    mag_full = torch.sqrt(torch.clamp(n_re * n_re + n_im * n_im,
                                      min=EPS32))
    cos_p, sin_p = _unit(n_re, n_im)
    # (B, 1, F - 1, T): the DC bin stripped
    re = (mag_full * cos_p)[..., 1:].transpose(1, 2)[:, None]
    im = (mag_full * sin_p)[..., 1:].transpose(1, 2)[:, None]
    mag = mag_full[..., 1:].transpose(1, 2)[:, None]
    skips = []
    for i in range(len(CHANNELS) - 1):
        re, im, mag = _encoder(i, re, im, mag, sd, p)
        skips.append((re, im, mag))
    re, im, mag = _conformer(_nhwc(re), _nhwc(im), _nhwc(mag), sd, p)
    re, im, mag = _nchw(re), _nchw(im), _nchw(mag)
    for i in range(len(CHANNELS) - 1):
        s_re, s_im, s_mag = skips[-1 - i]
        re, im, mag = _decoder(i, torch.cat([s_re, re], 1),
                               torch.cat([s_im, im], 1),
                               torch.cat([s_mag, mag], 1), sd, p)
    # heads, back on (B, T, F)
    mag = F.pad(torch.sigmoid(mag[:, 0].transpose(1, 2)), (1, 0)) * mag_full
    m_re, m_im = re[:, 0].transpose(1, 2), im[:, 0].transpose(1, 2)
    m_mag = torch.sqrt(torch.clamp(m_re * m_re + m_im * m_im, min=EPS32))
    cos_m, sin_m = _unit(m_re / (m_mag + EPS32), m_im / (m_mag + EPS32))
    m_mag = F.pad(torch.tanh(m_mag + EPS32), (1, 0))
    cos_m = F.pad(cos_m, (1, 0), value=1.0)
    sin_m = F.pad(sin_m, (1, 0))
    cos_e = cos_p * cos_m - sin_p * sin_m
    sin_e = sin_p * cos_m + cos_p * sin_m
    fused = (m_mag * mag_full + mag) * 0.5
    return istft(fused * cos_e, fused * sin_e, n_fft, hop, win,
                 (n_re.shape[-2] - 1) * hop)


def enhance(sd: dict, wav: torch.Tensor, cfg: dict,
            p: Precision = FP32) -> torch.Tensor:
    """(B, N) noisy waveforms -> (B, N) estimates (zeros past the
    network's output length)."""
    gain = rms_gain(wav)
    est = network(sd, wav * gain, cfg, p)
    n = wav.shape[-1]
    est = F.pad(est, (0, max(0, n - est.shape[-1])))[..., :n]
    return est / gain
