"""Uformer: dilated dual-path complex/real conformer U-net, waveform in and
out; the port of se_tpu/models/uformer.py.

Dual-branch U-net: a complex branch (full-channel complex convs on
channel-concat [re | im] with the interleaved kernel [[Wr, Wi], [-Wi, Wr]])
and a magnitude branch, 6 levels each (channels 1->8->16->32->64->128->128),
cross-branch `fusion` after every level. Bottleneck: the
DilatedDualpathConformer (FF -> T-attention -> F-attention -> 8 gated
dilated DSConv stages -> FF -> LayerNorm, fusing the branches after each
step). Heads: a sigmoid magnitude mask and a tanh complex mask, averaged;
STFT and iSTFT in the graph.

Every module keeps the reference PyTorch parameter names, so
`se_tpu.models.uformer.from_reference_state_dict(model.state_dict())`
loads the same weights into JAX, and `from_jax_variables` goes the other
way. The U-net levels run `ops.encoder.encoder_level` and
`ops.decoder.decoder_level`, the conformer `ops.dsconv.dsconv_pair_block`
(one entry a DSConv stage) and `ops.attention.sdp_attention`: CUDA kernels
on the card, their plain twins on the CPU. `DSConvCplx`/`DSConvReal` keep
the single-block `ops.dsconv.dsconv_block` as their own eval forward.

Train mode (`model.train()`) follows se_tpu's `train=True`: dropout 0.1
(`nn.Dropout`, drawn from the `generator` that `forward` receives) after
FFCplx's and FFReal's activation and second linear, after the axial
attentions' PReLU, and on each DSConv block's delta; BN batch statistics
in every U-net level, whose levels then run their plain path (conv -> BN
-> PReLU -> fusion), never the level kernels; each DSConv block on its
plain path under a block-granular checkpoint, then the fusion, never the
pair stage. The attentions keep their kernel. The dropout masks are drawn
outside every checkpointed region, so a recompute sees the same ones.

Quirks kept from se_tpu: EPS inside sqrt(max(., EPS)), `b + EPS` in
`unit_phase`, tanh(mask_mags + EPS), the DC bin stripped before the U-net
and re-padded at the heads (DC cos_m padded with 1), FF residuals scaled by
0.5, decoder concat [skip, x], out_len = (T - 1) * hop.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from se_tpu_torch.device import resolve_device, weight_key
from se_tpu_torch.models import jax_tree as jt
from se_tpu_torch.models.registry import ModelEntry, register
from se_tpu_torch.nn import (
    BatchNorm, ComplexDense, ConvParams, Dropout, LayerNorm, Linear, PReLU,
)
from se_tpu_torch.nn.conv import (
    conv2d_nhwc, interleave_complex_bias, interleave_complex_kernel,
)
from se_tpu_torch.ops import dsconv
from se_tpu_torch.ops._dtype import pack_dtype
from se_tpu_torch.ops.attention import sdp_attention
from se_tpu_torch.ops.decoder import (
    _tconv_phase_split, decoder_level, level_design, pack_decoder_weights,
    split_phase_weights,
)
from se_tpu_torch.ops.dsconv import (
    dsconv_block, dsconv_pair_block, pack_block_weights, pack_pair_weights,
    pair_design,
)
from se_tpu_torch.ops.encoder import (
    encoder_level, fuse, fusion, pack_encoder_weights,
)
from se_tpu_torch.ops.encoder import level_design as enc_level_design
from se_tpu_torch.ops.stft import PRESET_UFORMER, istft, stft

EPS = float(np.finfo(np.float32).eps)
KERNELS = (1, 8, 16, 32, 64, 128, 128)
DILATIONS = (1, 2, 4, 8, 16, 32, 64, 128)
ATT_HIDDEN = 16


def _row(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1).contiguous()


class CConvEnc(nn.Module):
    """Complex conv weights: real_conv / imag_conv (torch Conv2d layout),
    served as one interleaved HWIO kernel on [re | im]."""

    transpose = False

    def __init__(self, cin: int, cout: int, kernel=(2, 5)):
        super().__init__()
        self.real_conv = ConvParams(cin, cout, kernel, self.transpose)
        self.imag_conv = ConvParams(cin, cout, kernel, self.transpose)

    def weights(self):
        """(kt, kf, 2cin, 2cout) kernel and (2cout,) bias."""
        w = interleave_complex_kernel(self.real_conv.hwio(),
                                      self.imag_conv.hwio())
        b = interleave_complex_bias(self.real_conv.bias, self.imag_conv.bias)
        return w, b


class CConvDec(CConvEnc):
    """Complex transposed conv weights (torch ConvTranspose2d layout);
    `weights()` is unflipped."""

    transpose = True


class RConvEnc(nn.Module):
    """Real conv weights under the child name `conv`."""

    transpose = False

    def __init__(self, cin: int, cout: int, kernel=(2, 5)):
        super().__init__()
        self.conv = ConvParams(cin, cout, kernel, self.transpose)

    def weights(self):
        return self.conv.hwio(), self.conv.bias


class RConvDec(RConvEnc):
    transpose = True


class ComplexBN(BatchNorm):
    """torch BatchNorm3d on (N, C, F, T, 2): per-channel statistics shared
    by re and im, so in eval mode one affine serves both. `forward` takes
    channel-concat [re | im] and pools both halves into one set of batch
    statistics in train mode (se_tpu stacks them on a new axis)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1] // 2
        return super().forward(x.reshape(*x.shape[:-1], 2, c)) \
            .reshape(x.shape)


class _Dense(nn.Module):
    """A Linear under the child name `linear` (the reference's wrapper)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear = Linear(cin, cout)

    def forward(self, x):
        return self.linear(x)


class FFCplx(nn.Module):
    """LN -> ComplexDense -> PReLU -> ComplexDense, residual scaled 0.5;
    LN and PReLU shared by re and im."""

    def __init__(self, dim: int, hidden: int = 64):
        super().__init__()
        self.layernorm_linear = LayerNorm(dim)
        self.linear1 = ComplexDense(dim, hidden)
        self.linear2 = ComplexDense(hidden, dim)
        self.prelu = PReLU()
        self.dropout = Dropout(0.1)

    def forward(self, re, im, generator=None):
        drop = self.dropout
        yr, yi = self.layernorm_linear(re), self.layernorm_linear(im)
        yr, yi = self.linear1(yr, yi)
        yr, yi = drop(self.prelu(yr), generator), drop(self.prelu(yi),
                                                       generator)
        yr, yi = self.linear2(yr, yi)
        yr, yi = drop(yr, generator), drop(yi, generator)
        return yr * 0.5 + re, yi * 0.5 + im


class FFReal(nn.Module):
    def __init__(self, dim: int, hidden: int = 64):
        super().__init__()
        self.layernorm_linear = LayerNorm(dim)
        self.linear1 = _Dense(dim, hidden)
        self.linear2 = _Dense(hidden, dim)
        self.prelu = PReLU()
        self.dropout = Dropout(0.1)

    def forward(self, x, generator=None):
        y = self.prelu(self.linear1(self.layernorm_linear(x)))
        y = self.linear2(self.dropout(y, generator))
        return self.dropout(y, generator) * 0.5 + x


class _AttProj(nn.Module):
    """q/k/v projections of one single-head attention."""

    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.query = _Dense(cin, hidden)
        self.key = _Dense(cin, hidden)
        self.value = _Dense(cin, hidden)

    def forward(self, q, k, v):
        return self.query(q), self.key(k), self.value(v)


# (q, k, v) input per head of the complex attention; out = (A-B-C-D, E+F+G-H)
_CPLX_INPUTS = ("rrr", "rii", "iri", "iir", "rri", "rir", "irr", "iii")


class ComplexSelfAtt(nn.Module):
    """8 real attentions over folded (N, L, C), run as one 8-head call."""

    def __init__(self, cin: int, axis: str, hidden: int = ATT_HIDDEN):
        super().__init__()
        self.prefix = "T_att" if axis == "t" else "F_att"
        self.hidden = hidden
        self.layernorm1 = LayerNorm(cin)
        for k in range(1, 9):
            setattr(self, f"{self.prefix}{k}", _AttProj(cin, hidden))
        self.layernorm2 = LayerNorm(hidden)

    def forward(self, re, im):
        src = {"r": self.layernorm1(re), "i": self.layernorm1(im)}
        qs, ks, vs = [], [], []
        for k, sel in enumerate(_CPLX_INPUTS):
            proj = getattr(self, f"{self.prefix}{k + 1}")
            q, kk, v = proj(src[sel[0]], src[sel[1]], src[sel[2]])
            qs.append(q)
            ks.append(kk)
            vs.append(v)
        out = sdp_attention(torch.stack(qs, 1), torch.stack(ks, 1),
                            torch.stack(vs, 1), 1.0 / math.sqrt(self.hidden))
        a, b, c, d, e, f, g, h = out.unbind(1)
        return (self.layernorm2(a - b - c - d),
                self.layernorm2(e + f + g - h))


class _RealSelfAtt(nn.Module):
    def __init__(self, cin: int, axis: str, hidden: int = ATT_HIDDEN):
        super().__init__()
        self.hidden = hidden
        self.layernorm1 = LayerNorm(cin)
        self.proj_name = "T_att" if axis == "t" else "F_att"
        setattr(self, self.proj_name, _AttProj(cin, hidden))
        self.layernorm2 = LayerNorm(hidden)

    def forward(self, x):
        h = self.layernorm1(x)
        q, k, v = getattr(self, self.proj_name)(h, h, h)
        out = sdp_attention(q[:, None], k[:, None], v[:, None],
                            1.0 / math.sqrt(self.hidden))
        return self.layernorm2(out[:, 0])


def _fold(x, axis):
    b, t, f, c = x.shape
    if axis == "t":
        return x.transpose(1, 2).reshape(b * f, t, c)
    return x.reshape(b * t, f, c)


def _unfold(x, axis, shape):
    b, t, f, _ = shape
    if axis == "t":
        return x.reshape(b, f, t, -1).transpose(1, 2).contiguous()
    return x.reshape(b, t, f, -1)


class ComplexAxialAtt(nn.Module):
    """Axial complex attention over T (axis "t") or F (axis "f")."""

    def __init__(self, axis: str, c: int, hidden: int = ATT_HIDDEN):
        super().__init__()
        self.axis = axis
        self.attn_heads = nn.ModuleList([ComplexSelfAtt(c, axis, hidden)])
        self.transform_linear = ComplexDense(hidden, c)
        self.layernorm3 = LayerNorm(c)
        self.prelu = PReLU()
        self.dropout = Dropout(0.1)

    def forward(self, re, im, generator=None):
        r, i = self.attn_heads[0](_fold(re, self.axis), _fold(im, self.axis))
        r, i = self.transform_linear(r, i)
        r, i = _unfold(r, self.axis, re.shape), _unfold(i, self.axis, re.shape)
        r = self.dropout(self.prelu(self.layernorm3(r)), generator)
        i = self.dropout(self.prelu(self.layernorm3(i)), generator)
        return r + re, i + im


class RealAxialAtt(nn.Module):
    def __init__(self, axis: str, c: int, hidden: int = ATT_HIDDEN):
        super().__init__()
        self.axis = axis
        self.attn_heads = nn.ModuleList([_RealSelfAtt(c, axis, hidden)])
        self.transform_linear = _Dense(hidden, c)
        self.layernorm3 = LayerNorm(c)
        self.prelu = PReLU()
        self.dropout = Dropout(0.1)

    def forward(self, x, generator=None):
        h = self.transform_linear(self.attn_heads[0](_fold(x, self.axis)))
        h = _unfold(h, self.axis, x.shape)
        return self.dropout(self.prelu(self.layernorm3(h)), generator) + x


class _DSConv(nn.Module):
    """Gated dilated DSConv block (`ops.dsconv.dsconv_block`), on x
    channel-concat of `ncomp` components."""

    ncomp = 1
    conv = RConvEnc

    def __init__(self, c_in: int, conv_channels: int = 32, dilation1=1,
                 dilation2=1):
        super().__init__()
        cc = conv_channels
        self.dilation1, self.dilation2 = dilation1, dilation2
        self.layernorm_conv1 = LayerNorm(c_in)
        self.conv1x1 = self.conv(c_in, cc, (1, 1))
        self.prelu = PReLU()
        self.dconv1 = self.conv(cc, cc, (3, 3))
        self.dconv2 = self.conv(cc, cc, (3, 3))
        self.layernorm_conv2 = LayerNorm(cc)
        self.sconv = self.conv(cc, c_in, (1, 1))
        self.dropout = Dropout(0.1)

    def params(self):
        """The 13-tuple of `dsconv_block` (se_tpu's `_dsconv_params`)."""
        n = self.ncomp
        w1, bb1 = self.conv1x1.weights()
        wd1, bd1 = self.dconv1.weights()
        wd2, bd2 = self.dconv2.weights()
        ws, bs = self.sconv.weights()
        tot = w1.shape[-1]
        ln1, ln2 = self.layernorm_conv1, self.layernorm_conv2
        return (_row(ln1.weight.repeat(n)), _row(ln1.bias.repeat(n)),
                w1.reshape(-1, tot).contiguous(), _row(bb1),
                self.prelu.weight.reshape(1, 1),
                wd1.reshape(9 * tot, tot).contiguous(), _row(bd1),
                wd2.reshape(9 * tot, tot).contiguous(), _row(bd2),
                _row(ln2.weight.repeat(n)), _row(ln2.bias.repeat(n)),
                ws.reshape(tot, -1).contiguous(), _row(bs))

    def weights(self):
        """The 13-tuple and, on the card, its pack for the tensor-core
        block (in `pack_dtype` for the block's design, `block_design`:
        bf16 weights stay bf16 at the conformer's widths); kept as
        `_cached` says."""

        def make():
            params = self.params()
            packed = None
            if params[0].device.type == "cuda":
                with torch.no_grad():
                    packed = pack_block_weights(params, self.ncomp)
            return params, packed

        return _cached(self, "dsconv_block", 0, (self,), make)

    def forward(self, x, generator=None):
        """Eval: the block kernel. Train: se_tpu's train path, the plain
        block under a checkpoint and dropout on its delta, x + drop(block(x)
        - x) (se_tpu/models/uformer.py:481-497)."""
        if not self.training:
            params, packed = self.weights()
            return dsconv_block(x.contiguous(), params, self.dilation1,
                                self.dilation2, self.ncomp, packed=packed)
        from torch.utils.checkpoint import checkpoint

        out = checkpoint(dsconv._reference, x, self.params(), self.dilation1,
                         self.dilation2, self.ncomp, use_reentrant=False)
        return x + self.dropout(out - x, generator)


class DSConvCplx(_DSConv):
    """Complex block on [re | im] (ncomp 2, interleaved weights)."""

    ncomp = 2
    conv = CConvEnc


class DSConvReal(_DSConv):
    pass


class DilatedDualpathConformer(nn.Module):
    def __init__(self, c: int = KERNELS[-1]):
        super().__init__()
        self.ff1_cplx, self.ff1_mag = FFCplx(c), FFReal(c)
        self.cplx_tatt, self.mag_tatt = ComplexAxialAtt("t", c), \
            RealAxialAtt("t", c)
        self.cplx_fatt, self.mag_fatt = ComplexAxialAtt("f", c), \
            RealAxialAtt("f", c)
        n = len(DILATIONS)
        pairs = [(d, DILATIONS[n - i - 1]) for i, d in enumerate(DILATIONS)]
        self.dsconv_cplx = nn.ModuleList(
            [DSConvCplx(c, 32, d1, d2) for d1, d2 in pairs])
        self.dsconv_real = nn.ModuleList(
            [DSConvReal(c, 32, d1, d2) for d1, d2 in pairs])
        self.ff2_cplx, self.ff2_mag = FFCplx(c), FFReal(c)
        self.ln_conformer_cplx = LayerNorm(c)
        self.ln_conformer_mag = LayerNorm(c)

    def _stage_weights(self, k: int):
        """DSConv stage k's two 13-tuples and, on the card, their packs for
        the tensor-core stage (in `pack_dtype` for the stage's design);
        kept as `_cached` says."""
        blk_c, blk_m = self.dsconv_cplx[k], self.dsconv_real[k]

        def make():
            params_c, params_m = blk_c.params(), blk_m.params()
            packed = None
            if params_c[0].device.type == "cuda":
                w1c, w1m = params_c[2], params_m[2]
                design = pair_design(w1m.shape[0], w1c.shape[1],
                                     w1m.shape[1], w1c.dtype)
                with torch.no_grad():
                    packed = pack_pair_weights(params_c, params_m,
                                               pack_dtype(w1c, design))
            return params_c, params_m, packed

        return _cached(self, "dsconv_pair", k, (blk_c, blk_m), make)

    def forward(self, re, im, mag, generator=None):
        g = generator
        re, im = self.ff1_cplx(re, im, g)
        re, im, mag = fusion(re, im, self.ff1_mag(mag, g))
        re, im = self.cplx_tatt(re, im, g)
        re, im, mag = fusion(re, im, self.mag_tatt(mag, g))
        re, im = self.cplx_fatt(re, im, g)
        re, im, mag = fusion(re, im, self.mag_fatt(mag, g))
        c = re.shape[-1]
        xc, mag = torch.cat([re, im], dim=-1), mag.contiguous()
        for k, blk in enumerate(self.dsconv_cplx):
            if self.training:  # each block on its own, then the fusion
                xc, mag = fuse(blk(xc, g), self.dsconv_real[k](mag, g))
                continue
            # one stage: both blocks and the fusion in one kernel entry
            params_c, params_m, packed = self._stage_weights(k)
            xc, mag = dsconv_pair_block(xc, mag, params_c, params_m,
                                        blk.dilation1, blk.dilation2,
                                        packed=packed)
        re, im = xc[..., :c], xc[..., c:]
        re, im = self.ff2_cplx(re, im, g)
        re, im, mag = fusion(re, im, self.ff2_mag(mag, g))
        ln = self.ln_conformer_cplx
        return ln(re), ln(im), self.ln_conformer_mag(mag)


def unit_phase(a, b):
    """(a, b + EPS) / hypot: cos and sin of atan2(b + EPS, a), no trig."""
    bb = b + EPS
    inv = torch.rsqrt(a * a + bb * bb)
    return a * inv, bb * inv


def _cached(owner: nn.Module, kind: str, i: int, modules, make):
    """make()'s result for `owner`'s (kind, i), one entry a dtype of the
    weights, made once and kept until a parameter or buffer of `modules`
    moves or changes in place (`weight_key`). Under autograd it is made
    anew and not kept, so gradients reach the weights."""
    key = weight_key(modules)
    slot = (kind, i, key[0][1] if key else None)
    cache = owner.__dict__.setdefault("_weight_cache", {})
    hit = cache.get(slot)
    if not torch.is_grad_enabled() and hit is not None and hit[0] == key:
        return hit[1]
    out = make()
    if not torch.is_grad_enabled():
        cache[slot] = (key, out)
    return out


def _level_params(cconv, bn, act, rconv, bn_r, act_r, split: bool):
    """se_tpu's encoder 10-tuple (split=False) or decoder 12-tuple. From
    bf16 weights the conv kernels stay bf16 and the tail vectors are fp32:
    the bias and slope widened, BN's affine folded in fp32 from the bf16
    statistics (the bf16 level kernels' inputs)."""
    out = []
    for conv, norm, prelu, tile in ((cconv, bn, act, 2),
                                    (rconv, bn_r, act_r, 1)):
        w, b = conv.weights()
        tail = torch.float32 if w.dtype == torch.bfloat16 else w.dtype
        ws = [t.contiguous() for t in split_phase_weights(w)] if split \
            else [w.contiguous()]
        b = b.to(tail)
        if norm is None:  # last decoder level: no BN, no PReLU
            inv = shift = torch.zeros_like(b)
            alpha = b.new_zeros(1, 1)
        else:
            inv, shift = norm.affine(tail)
            inv, shift = inv.repeat(tile), shift.repeat(tile)
            alpha = prelu.weight.reshape(1, 1).to(tail)
        out += ws + [_row(b), _row(inv), _row(shift), alpha]
    return tuple(out)


class Uformer(nn.Module):
    """Waveform -> (est_wav, src_wav_rt, est_cplx (re, im), src_cplx
    (re, im)). `compressed=True` runs the mag**0.5 regime in the graph.
    Weights are drawn from `generator` (seed 0 when None) with torch's
    conv/linear init; `device=None` means the card."""

    def __init__(self, compressed: bool = False, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.compressed = compressed
        self.encoder = nn.ModuleList()
        self.encoder_real = nn.ModuleList()
        for cin, cout in zip(KERNELS[:-1], KERNELS[1:]):
            self.encoder.append(nn.ModuleList(
                [CConvEnc(cin, cout), ComplexBN(cout), PReLU()]))
            self.encoder_real.append(nn.ModuleList(
                [RConvEnc(cin, cout), BatchNorm(cout), PReLU()]))
        self.conformer = DilatedDualpathConformer()
        self.decoder = nn.ModuleList()
        self.decoder_real = nn.ModuleList()
        for i in range(6):
            c_comp, cout = 2 * KERNELS[6 - i], KERNELS[5 - i]
            tail_c = [ComplexBN(cout), PReLU()] if i < 5 else []
            tail_m = [BatchNorm(cout), PReLU()] if i < 5 else []
            self.decoder.append(nn.ModuleList([CConvDec(c_comp, cout)]
                                              + tail_c))
            self.decoder_real.append(nn.ModuleList([RConvDec(c_comp, cout)]
                                                   + tail_m))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for mod in self.modules():
            if isinstance(mod, (ConvParams, Linear)):
                mod.reset_parameters(generator)
        self.to(resolve_device(device)).eval()  # eval until train()

    def _encoder_weights(self, i: int):
        """Encoder level i's 10-tuple and, for a tensor-core level on the
        card, its packed weights (in `pack_dtype` for the level's design);
        kept as `_cached` says."""
        enc, enc_r = self.encoder[i], self.encoder_real[i]

        def make():
            params = _level_params(*enc, *enc_r, split=False)
            design = enc_level_design(params[5].shape[2], params[0].dtype)
            packed = None
            if params[0].device.type == "cuda" and design != "cuda_core":
                with torch.no_grad():
                    packed = pack_encoder_weights(
                        params, pack_dtype(params[0], design))
            return params, packed

        return _cached(self, "encoder", i, (enc, enc_r), make)

    def _decoder_weights(self, i: int):
        """Decoder level i's 12-tuple and, for a tensor-core level on the
        card, its packed weights (in `pack_dtype` for the level's design);
        kept as `_cached` says."""
        dec, dec_r = self.decoder[i], self.decoder_real[i]

        def make():
            has_bn = len(dec) > 1
            tail_c = tuple(dec[1:]) if has_bn else (None, None)
            tail_m = tuple(dec_r[1:]) if has_bn else (None, None)
            params = _level_params(dec[0], *tail_c, dec_r[0], *tail_m,
                                   split=True)
            cc, cout = params[6].shape[1], params[6].shape[2]
            design = level_design(cc, cout, params[0].dtype)
            packed = None
            if params[0].device.type == "cuda" and design != "cuda_core":
                with torch.no_grad():
                    packed = pack_decoder_weights(
                        params, pack_dtype(params[0], design))
            return params, packed

        return _cached(self, "decoder", i, (dec, dec_r), make)

    def _encoder_train(self, i: int, xc, xm):
        """Encoder level i on its plain path: conv -> BN (batch statistics
        in train mode) -> PReLU per branch, then the fusion."""
        out = []
        for x, (conv, bn, act) in ((xc, self.encoder[i]),
                                   (xm, self.encoder_real[i])):
            w, b = conv.weights()
            y = conv2d_nhwc(x, w, strides=(1, 2), padding=((1, 0), (2, 2)))
            out.append(act(bn(y + b)))
        return fuse(*out)

    def _decoder_train(self, i: int, xc, xm):
        """Decoder level i on its plain path: the phase-split transposed
        conv -> BN -> PReLU per branch (no BN and PReLU at the last level),
        then the fusion."""
        out = []
        for x, level in ((xc, self.decoder[i]), (xm, self.decoder_real[i])):
            w, b = level[0].weights()
            y = _tconv_phase_split(x, *split_phase_weights(w), b)
            if len(level) > 1:
                y = level[2](level[1](y))
            out.append(y)
        return fuse(*out)

    def forward(self, noisy: torch.Tensor, src: torch.Tensor,
                generator: torch.Generator | None = None):
        """In train mode `generator` (on the model's device) draws the
        dropout masks; it is required there and unused in eval mode."""
        if self.training and generator is None:
            raise ValueError("Uformer in train mode draws its dropout from a "
                             "torch.Generator: pass `generator`")
        cfg = PRESET_UFORMER
        n_re, n_im = stft(noisy, cfg)  # (B, T, F)
        s_re, s_im = stft(src, cfg)
        out_len = (n_re.shape[-2] - 1) * cfg.hop
        src_rt = istft(s_re, s_im, cfg, length=out_len)

        s_mag = torch.sqrt(torch.clamp(s_re * s_re + s_im * s_im, min=EPS))
        s_cos, s_sin = unit_phase(s_re, s_im)
        if self.compressed:
            s_mag = s_mag ** 0.5
        src_cplx = (s_mag * s_cos, s_mag * s_sin)

        mag_full = torch.sqrt(torch.clamp(n_re * n_re + n_im * n_im,
                                          min=EPS))
        cos_p, sin_p = unit_phase(n_re, n_im)
        if self.compressed:
            mag_full = mag_full ** 0.5
        # strip DC, add the channel axis: xc = [re | im] with C = 1
        xc = torch.stack([(mag_full * cos_p)[..., 1:],
                          (mag_full * sin_p)[..., 1:]], dim=-1)
        mag = mag_full[..., 1:, None].contiguous()

        skips = []
        for i in range(len(self.encoder)):
            if self.training:
                xc, mag = self._encoder_train(i, xc, mag)
            else:
                params, packed = self._encoder_weights(i)
                xc, mag = encoder_level(xc, mag, params, packed=packed)
            skips.append((xc, mag))

        c = xc.shape[-1] // 2
        re, im, mag = self.conformer(xc[..., :c], xc[..., c:], mag,
                                     generator)
        xc = torch.cat([re, im], dim=-1)

        for i, (dec, dec_r) in enumerate(zip(self.decoder,
                                             self.decoder_real)):
            skip_c, skip_m = skips[-1 - i]
            cs, cx = skip_c.shape[-1] // 2, xc.shape[-1] // 2
            # decoder concat order [skip, x], per component
            xin = torch.cat([skip_c[..., :cs], xc[..., :cx],
                             skip_c[..., cs:], xc[..., cx:]], dim=-1)
            min_ = torch.cat([skip_m, mag], dim=-1)
            if self.training:
                xc, mag = self._decoder_train(i, xin, min_)
                continue
            params, packed = self._decoder_weights(i)
            xc, mag = decoder_level(xin, min_, params, has_bn=len(dec) > 1,
                                    packed=packed)

        # heads; the channel axis is 1 per component
        mag = F.pad(torch.sigmoid(mag[..., 0]), (1, 0)) * mag_full
        mask_re, mask_im = xc[..., 0], xc[..., 1]
        mask_mags = torch.sqrt(torch.clamp(mask_re * mask_re
                                           + mask_im * mask_im, min=EPS))
        real_phase = mask_re / (mask_mags + EPS)
        imag_phase = mask_im / (mask_mags + EPS)
        mask_mags = torch.tanh(mask_mags + EPS)
        cos_m, sin_m = unit_phase(real_phase, imag_phase)
        mask_mags = F.pad(mask_mags, (1, 0))
        cos_m = F.pad(cos_m, (1, 0), value=1.0)  # DC: mask phase 0
        sin_m = F.pad(sin_m, (1, 0))
        cos_est = cos_p * cos_m - sin_p * sin_m
        sin_est = sin_p * cos_m + cos_p * sin_m

        mag_fused = (mask_mags * mag_full + mag) * 0.5
        out_cplx = (mag_fused * cos_est, mag_fused * sin_est)
        if self.compressed:
            mag_fused = mag_fused ** 2
        est = istft(mag_fused * cos_est, mag_fused * sin_est, cfg,
                    length=out_len)
        return est, src_rt, out_cplx, src_cplx


# ---------------------------------------------------------------- conversion
# The inverse of se_tpu.models.uformer.from_reference_state_dict: se_tpu's
# kernels are (kt, kf, I, O), torch's Conv2d (O, I, kf, kt) and
# ConvTranspose2d (I, O, kf, kt), unflipped; Dense (I, O), Linear (O, I).

def _put_conv(sd, p, tree, transpose=False):
    jt.put_conv(sd, p, tree, transpose, freq_first=True)


def _put_cconv(sd, p, tree, transpose=False):
    for name in ("real_conv", "imag_conv"):
        _put_conv(sd, f"{p}.{name}", tree[name], transpose)


def _put_prelu(sd, p, tree):
    """se_tpu's own PReLU names its slope `weight`, as torch does."""
    sd[f"{p}.weight"] = jt.tensor(tree["weight"]).reshape(1)


def _put_cdense(sd, p, tree):
    jt.put_dense(sd, f"{p}.real_linear", tree["linear_real"])
    jt.put_dense(sd, f"{p}.imag_linear", tree["linear_imag"])


def _put_att_proj(sd, p, tree):
    for name in ("query", "key", "value"):
        jt.put_dense(sd, f"{p}.{name}.linear", tree[name])


def from_jax_variables(variables: dict) -> dict:
    """se_tpu's Uformer {"params", "batch_stats"} tree (numpy or jax
    arrays) -> this port's state_dict."""
    prm, st = variables["params"], variables["batch_stats"]
    sd: dict = {}
    for i in range(6):
        _put_cconv(sd, f"encoder.{i}.0", prm[f"enc{i}"])
        jt.put_batchnorm(sd, f"encoder.{i}.1", prm[f"enc_bn{i}"]["bn3d"],
                         st[f"enc_bn{i}"]["bn3d"])
        _put_prelu(sd, f"encoder.{i}.2", prm[f"enc_act{i}"])
        _put_conv(sd, f"encoder_real.{i}.0.conv", prm[f"enc_real{i}"]["conv"])
        jt.put_batchnorm(sd, f"encoder_real.{i}.1", prm[f"enc_real_bn{i}"],
                         st[f"enc_real_bn{i}"])
        _put_prelu(sd, f"encoder_real.{i}.2", prm[f"enc_real_act{i}"])
        _put_cconv(sd, f"decoder.{i}.0", prm[f"dec{i}"], transpose=True)
        _put_conv(sd, f"decoder_real.{i}.0.conv", prm[f"dec_real{i}"]["conv"],
                  transpose=True)
        if i < 5:
            jt.put_batchnorm(sd, f"decoder.{i}.1", prm[f"dec_bn{i}"]["bn3d"],
                             st[f"dec_bn{i}"]["bn3d"])
            _put_prelu(sd, f"decoder.{i}.2", prm[f"dec_act{i}"])
            jt.put_batchnorm(sd, f"decoder_real.{i}.1",
                             prm[f"dec_real_bn{i}"], st[f"dec_real_bn{i}"])
            _put_prelu(sd, f"decoder_real.{i}.2", prm[f"dec_real_act{i}"])

    conf = prm["conformer"]
    for k in ("ff1", "ff2"):
        p, t = f"conformer.{k}_cplx", conf[f"{k}_cplx"]
        jt.put_layernorm(sd, f"{p}.layernorm_linear", t["ln"])
        _put_cdense(sd, f"{p}.linear1", t["linear1"])
        _put_cdense(sd, f"{p}.linear2", t["linear2"])
        _put_prelu(sd, f"{p}.prelu", t["prelu"])
        p, t = f"conformer.{k}_mag", conf[f"{k}_mag"]
        jt.put_layernorm(sd, f"{p}.layernorm_linear", t["ln"])
        jt.put_dense(sd, f"{p}.linear1.linear", t["linear1"])
        jt.put_dense(sd, f"{p}.linear2.linear", t["linear2"])
        _put_prelu(sd, f"{p}.prelu", t["prelu"])
    for axis, name in (("t", "T_att"), ("f", "F_att")):
        p, t = f"conformer.cplx_{axis}att", conf[f"cplx_{axis}att"]
        heads = f"{p}.attn_heads.0"
        for k in range(1, 9):
            _put_att_proj(sd, f"{heads}.{name}{k}", t["att"][f"att{k}"])
        jt.put_layernorm(sd, f"{heads}.layernorm1", t["att"]["ln1"])
        jt.put_layernorm(sd, f"{heads}.layernorm2", t["att"]["ln2"])
        _put_cdense(sd, f"{p}.transform_linear", t["transform"])
        jt.put_layernorm(sd, f"{p}.layernorm3", t["ln3"])
        _put_prelu(sd, f"{p}.prelu", t["prelu"])
        p, t = f"conformer.mag_{axis}att", conf[f"mag_{axis}att"]
        heads = f"{p}.attn_heads.0"
        _put_att_proj(sd, f"{heads}.{name}", t["att"])
        jt.put_layernorm(sd, f"{heads}.layernorm1", t["ln1"])
        jt.put_layernorm(sd, f"{heads}.layernorm2", t["ln2"])
        jt.put_dense(sd, f"{p}.transform_linear.linear", t["transform"])
        jt.put_layernorm(sd, f"{p}.layernorm3", t["ln3"])
        _put_prelu(sd, f"{p}.prelu", t["prelu"])
    for name in ("ln_conformer_cplx", "ln_conformer_mag"):
        jt.put_layernorm(sd, f"conformer.{name}", conf[name])
    for idx in range(len(DILATIONS)):
        for kind, put in (("cplx", _put_cconv), ("real", None)):
            p, t = f"conformer.dsconv_{kind}.{idx}", \
                conf[f"dsconv_{kind}{idx}"]
            jt.put_layernorm(sd, f"{p}.layernorm_conv1", t["ln1"])
            jt.put_layernorm(sd, f"{p}.layernorm_conv2", t["ln2"])
            _put_prelu(sd, f"{p}.prelu", t["prelu"])
            for conv in ("conv1x1", "dconv1", "dconv2", "sconv"):
                if put is None:
                    _put_conv(sd, f"{p}.{conv}.conv", t[conv]["conv"])
                else:
                    put(sd, f"{p}.{conv}", t[conv])
    return sd


register(
    ModelEntry(
        name="uformer",
        make=Uformer,
        stft=PRESET_UFORMER,
        io_kind="waveform",
        from_jax_variables=from_jax_variables,
        variants=("cprs",),
        bf16=True,
    )
)
