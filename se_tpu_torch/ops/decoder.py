"""One Uformer decoder level, both branches: the port of
se_tpu/ops/pallas_decoder.py (`decoder_level`, kernel `_kernel`, math
`_level_math`, and `split_phase_weights`).

Per branch: the channel-concat [skip, x] -> stride-(1, 2) transposed (2, 5)
conv (torch geometry: padding (0, 2), output_padding (0, 1), output T
trimmed to the input's) in phase-split form: even output columns from
f-taps wf0/2/4, odd ones from wf1/3 -> (BN affine -> PReLU, if `has_bn`);
then the cross-branch `fusion`. `params` is se_tpu's 12-tuple, complex then
real branch, each (w_even (6, Cin_b, Cout_b), w_odd (4, Cin_b, Cout_b),
bias (1, Cout_b), bn_scale (1, Cout_b), bn_shift (1, Cout_b), alpha (1, 1)).
The complex input is [skip_re | x_re | skip_im | x_im]. On a CUDA tensor
`decoder_level` launches csrc/decoder.cu; on a CPU tensor it runs
`_reference`, the plain twin.

csrc/decoder.cu has two designs, picked a level by `level_design` from the
shape: an implicit GEMM on the tensor cores (`se_decoder_level_tc`, Cout
>= 8: Uformer's levels 0-4), whose weights `pack_decoder_weights` lays
out once (Uformer caches them a model), and a CUDA-core kernel for the
narrowest (`se_decoder_level_cc`, Cout < 8: level 5), which reads the
12-tuple as it is.

Under autograd the launch is a Function (`_autograd.kernel_call`) whose
backward is the VJP of `_reference`, recomputed (se_tpu's
`pallas_decoder.py:169-175`); `packed` is a constant to it.

bf16 xc and xm launch each design's bf16 variant (`se_decoder_level_tc_bf16`,
`se_decoder_level_cc_bf16`, counted as `decoder_bf16`): bf16 conv weights
(the tensor-core design's packed in bf16, on bf16 `mma.m16n8k16`; the
CUDA-core design's widened to fp32), fp32 tail vectors, fp32 sums and
epilogue, the outputs rounded once; `_reference` mirrors it. The bf16
tensor-core design copies 8 channels at a time (Uformer's levels 0-4: Cc
256 ... 32); a bf16 level whose Cc is a multiple of 4 but not of 8 takes
"tc_widened" (`_dtype.widened_launch`): the fp32 tensor-core kernel on
the widened inputs and fp32 packs, its outputs rounded to bf16 once,
counted also as `decoder_bf16_widened`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from se_tpu_torch.ops import _autograd, _build
from se_tpu_torch.ops._dtype import pack_dtype, widened, widened_launch
from se_tpu_torch.ops.encoder import (
    _aligned, _prelu, _round_up, fuse, launch_params,
)
from se_tpu_torch.parallel.mesh import map_leading


def split_phase_weights(kernel: torch.Tensor):
    """(2, 5, Cin, Cout) unflipped tconv kernel -> (w_even (6, Cin, Cout),
    w_odd (4, Cin, Cout)), taps ordered (t-tap major, f-tap): with
    wf = flip(kernel), even-phase f-taps are [wf0, wf2, wf4] over
    x[q-1..q+1], odd-phase f-taps [wf1, wf3] over x[q..q+1]."""
    wf = torch.flip(kernel, dims=(0, 1))
    cin, cout = kernel.shape[2], kernel.shape[3]
    w_even = wf[:, 0::2].reshape(2 * 3, cin, cout)
    w_odd = wf[:, 1::2].reshape(2 * 2, cin, cout)
    return w_even, w_odd


def _tconv_phase_split(x, w_even, w_odd, bias):
    """x (B, T, F, Cin) -> (B, T, 2F, Cout), one matmul per tap."""
    b, t, f, _ = x.shape
    xp_t = F.pad(x, (0, 0, 0, 0, 1, 0))  # row t reads x[t-1], x[t]

    def phase(w_taps, pads, n_taps):
        xf = F.pad(xp_t, (0, 0) + pads)
        acc = 0
        for it in range(2):
            for jf in range(n_taps):
                tap = xf[:, it : it + t, jf : jf + f]
                acc = acc + torch.matmul(tap, w_taps[it * n_taps + jf])
        return acc

    y_even = phase(w_even, (1, 1), 3)
    y_odd = phase(w_odd, (0, 1), 2)
    y = torch.stack([y_even, y_odd], dim=3).reshape(b, t, 2 * f, -1)
    return y + bias


@widened
def _reference(xc, xm, params, has_bn: bool):
    def branch(x, w_e, w_o, b, s, t, a):
        y = _tconv_phase_split(x, w_e, w_o, b[0])
        return _prelu(y * s[0] + t[0], a[0, 0]) if has_bn else y

    return fuse(branch(xc, *params[:6]), branch(xm, *params[6:12]))


TC_CHANNELS = 16  # output channels a tensor-core block: Cout padded to it
TC_K = 32         # K a stage: each tap's Cin padded to it
TC_MIN_COUT = 8   # narrower levels take the CUDA cores


def level_design(cc: int, cout: int,
                 dtype: torch.dtype = torch.float32) -> str:
    """The design csrc/decoder.cu runs a level of `dtype` with: "tc" (the
    implicit GEMM on the tensor cores) for Cout >= 8, Uformer's levels 0-4
    (level 4's Cout 8 fills half of each block's channels, and still ran
    2.3-2.6x faster than on the CUDA cores on the card), where Cc % 4 == 0
    (16-byte copies of both branches' channels; in bf16 Cc % 8 == 0, 8
    channels a copy); in bf16 "tc_widened" (the fp32 tensor-core kernel on
    widened inputs) where Cc % 4 == 0 but Cc % 8 != 0; "cuda_core"
    otherwise (level 5, Cout 1, bounded by bytes; a bf16 variant of its
    own). The CUDA-core entry refuses a level whose staged weights and
    input tile do not fit a block's shared memory."""
    if cout < TC_MIN_COUT or cc % 4:
        return "cuda_core"
    return "tc_widened" if dtype == torch.bfloat16 and cc % 8 else "tc"


def _pack_branch(w_even, w_odd, parts: int, dtype: torch.dtype):
    """(6, Cin, parts * Cout) and (4, Cin, parts * Cout) phase weights ->
    (Coutp / 8 * 2 * parts * 8, 6 * Cinp). K index tap * Cinp + ci with tap
    = it * 3 + jf over x[t - 1 + it, q - 1 + jf]: the even phase's taps as
    they are, the odd phase's f-taps wf1/3 at jf = 1, 2 and zeros at jf = 0.
    Column (g8, phase, part, c8) for channel 8 g8 + c8: per 8 channels the
    n8 tiles [re even, im even, re odd, im odd] (complex) or [even, odd]
    (real). Cin is zero-padded to Cinp (a multiple of 32), Cout to Coutp (a
    multiple of 16). In `dtype`."""
    _, cin, n = w_even.shape
    cout = n // parts
    cinp, coutp = _round_up(cin, TC_K), _round_up(cout, TC_CHANNELS)
    even = w_even.reshape(2, 3, cin, parts, cout)
    odd = w_odd.reshape(2, 2, cin, parts, cout)
    odd = torch.cat([torch.zeros_like(odd[:, :1]), odd], dim=1)
    full = torch.stack([even, odd])  # (phase, it, jf, ci, part, c)
    full = F.pad(full, (0, coutp - cout, 0, 0, 0, cinp - cin))
    full = full.reshape(2, 6, cinp, parts, coutp // 8, 8)
    packed = full.permute(4, 0, 3, 5, 1, 2)  # (g8, phase, part, c8, tap, ci)
    return packed.reshape(-1, 6 * cinp).to(dtype).contiguous()


@_build.packs
def pack_decoder_weights(params, dtype: torch.dtype | None = None):
    """The 12-tuple's phase weights packed for the tensor-core design, on
    their device: complex (4 Coutp, 6 Cinp_c) and real (2 Coutp, 6
    Cinp_m), K-major, in `dtype`; by default in bf16 for bf16 weights (the
    bf16 kernel's) and fp32 otherwise (`_dtype.pack_dtype`; the widened
    route takes fp32 packs of bf16 weights). Done once a model (Uformer
    keeps them, a pack a dtype), not once a call."""
    dtype = dtype or pack_dtype(params[0])
    return (_pack_branch(params[0], params[1], 2, dtype),
            _pack_branch(params[6], params[7], 1, dtype))


def decoder_level(xc: torch.Tensor, xm: torch.Tensor, params,
                  has_bn: bool, packed=None):
    """xc (B, T, F, 2*Cc) = [skip_re | x_re | skip_im | x_im], xm (B, T, F,
    Cc) = [skip_m | m] -> ((B, T, 2F, 2*Cout), (B, T, 2F, Cout)). `packed`:
    `pack_decoder_weights(params)`, where the caller keeps it; packed here
    for a tensor-core level without it. B splits over an active mesh's
    model group (`parallel.map_leading`)."""
    return map_leading(lambda xc, xm, *params: _level(xc, xm, params,
                                                      has_bn, packed),
                       (xc, xm), tuple(params))


def _level(xc, xm, params, has_bn: bool, packed):
    if xc.device.type == "cpu":
        return _reference(xc, xm, params, has_bn)
    design = level_design(xc.shape[-1] // 2, params[6].shape[-1], xc.dtype)
    return _autograd.kernel_call(
        lambda xc, xm, params: _launch(xc, xm, params, has_bn, design,
                                       packed),
        lambda xc, xm, params: _reference(xc, xm, params, has_bn),
        xc, xm, params)


def _launch(xc, xm, params, has_bn: bool, design: str, packed=None,
            count=True):
    """Launch `design` ("tc", "cuda_core"; bf16 also "tc_widened") on
    CUDA tensors, its fp32 or its bf16 variant by xc and xm's one dtype
    (as the encoder's `_launch`, `count` too)."""
    if design == "tc_widened":
        return widened_launch(
            "decoder",
            lambda xc, xm, params, packed: _launch(xc, xm, params, has_bn,
                                                   "tc", packed, False),
            xc, xm, params, (0, 1, 6, 7), packed, pack_decoder_weights)
    b, t, f, c2 = xc.shape
    cc, cout = c2 // 2, params[6].shape[-1]
    dtype = _build.launch_dtype("decoder", xc, xm)
    names = ("wce", "wco", "bc", "sc", "tc", "ac",
             "wme", "wmo", "bm", "sm", "tm", "am")
    shapes = ((6, 2 * cc, 2 * cout), (4, 2 * cc, 2 * cout), (1, 2 * cout),
              (1, 2 * cout), (1, 2 * cout), (1, 1),
              (6, cc, cout), (4, cc, cout), (1, cout), (1, cout), (1, cout),
              (1, 1))
    _build.check(xc, (b, t, f, 2 * cc), "xc", dtype)
    _build.check(xm, (b, t, f, cc), "xm", dtype)
    if design == "tc" and dtype == torch.bfloat16 and cc % 8:
        raise ValueError(f"decoder kernel: the bf16 tensor-core design "
                         f"copies 8 channels at a time, Cc must be a "
                         f"multiple of 8, got {cc}")
    if design == "tc" and packed is None:
        packed = pack_decoder_weights(params)
    args = launch_params(params, shapes, names, (0, 1, 6, 7), dtype,
                         keep=(0, 1, 6, 7) if design == "tc" else ())
    yc = torch.empty((b, t, 2 * f, 2 * cout), device=xc.device, dtype=dtype)
    ym = torch.empty((b, t, 2 * f, cout), device=xc.device, dtype=dtype)
    if design == "tc":
        wc, wm = packed
        coutp = _round_up(cout, TC_CHANNELS)
        cinp_c, cinp_m = _round_up(2 * cc, TC_K), _round_up(cc, TC_K)
        _build.check(wc, (4 * coutp, 6 * cinp_c), "packed wc", dtype)
        _build.check(wm, (2 * coutp, 6 * cinp_m), "packed wm", dtype)
        _build.launch(_build.variant("se_decoder_level_tc", dtype),
                      _aligned(xc), _aligned(xm), wc, wm, *args[2:6],
                      *args[8:12], yc, ym, b, t, f, cc, cout, cinp_c, cinp_m,
                      bool(has_bn))
    elif design == "cuda_core":
        _build.launch(_build.variant("se_decoder_level_cc", dtype), xc, xm,
                      *args, yc, ym, b, t, f, cc, cout, bool(has_bn))
    else:
        raise ValueError(f"unknown decoder design {design!r}")
    if count:
        _build.LAUNCHES[_build.variant("decoder", dtype)] += 1
    return yc, ym
