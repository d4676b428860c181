"""One Uformer encoder level, both branches: the port of
se_tpu/ops/pallas_encoder.py (`encoder_level`, kernel `_kernel`, math
`_level_math`).

Per branch: a stride-(1, 2) (2, 5) conv, causal along T (pad (1, 0)) and
padded (2, 2) along F -> BN (eval affine) -> PReLU; then the cross-branch
`fusion`. `params` is se_tpu's 10-tuple, complex then real branch, each
(w (2, 5, Cin_b, Cout_b), bias (1, Cout_b), bn_scale (1, Cout_b),
bn_shift (1, Cout_b), alpha (1, 1)); the complex weight is the interleaved
[[Wr, Wi], [-Wi, Wr]] kernel on channel-concat [re | im]. On a CUDA
tensor `encoder_level` launches csrc/encoder.cu; on a CPU tensor it runs
`_reference`, the plain twin.

csrc/encoder.cu has two designs, picked a level by `level_design` from the
shape: an implicit GEMM on the tensor cores (`se_encoder_level_tc`: Cin %
4 == 0, Uformer's levels 1-5), whose weights `pack_encoder_weights` lays
out once (Uformer caches them a model), and a CUDA-core kernel for the
narrowest level (`se_encoder_level_cc`: level 0, Cin 1), which reads the
10-tuple as it is.

Under autograd the launch is a Function (`_autograd.kernel_call`) whose
backward is the VJP of `_reference`, recomputed (se_tpu's
`pallas_encoder.py:146-150`); `packed` is a constant to it.

bf16 xc and xm launch each design's bf16 variant (`se_encoder_level_tc_bf16`,
`se_encoder_level_cc_bf16`, counted as `encoder_bf16`): bf16 conv weights
(the tensor-core design's packed in bf16, on bf16 `mma.m16n8k16`; the
CUDA-core design's widened to fp32), fp32 tail vectors, every sum and the
epilogue in fp32, the outputs rounded once, as se_tpu's Pallas kernel
does; `_reference` mirrors that (`_dtype.widened`). The bf16 tensor-core
design copies 8 channels at a time; a bf16 level whose Cin is a multiple
of 4 but not of 8 takes "tc_widened" (`_dtype.widened_launch`): the fp32
tensor-core kernel on the widened inputs and fp32 packs, its outputs
rounded to bf16 once (the same rounding points), counted also as
`encoder_bf16_widened`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from se_tpu_torch.nn.conv import conv2d_nhwc
from se_tpu_torch.ops import _autograd, _build
from se_tpu_torch.ops._dtype import pack_dtype, widened, widened_launch
from se_tpu_torch.parallel.mesh import map_leading

EPS = float(np.finfo(np.float32).eps)


def _prelu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


def fusion(re, im, mag):
    """Uformer's cross-branch coupling: mag += sigmoid(|cplx|), re/im +=
    sigmoid(mag), with |cplx| = sqrt(max(re^2 + im^2, EPS))."""
    cplx_mag = torch.sqrt(torch.clamp(re * re + im * im, min=EPS))
    mag_out = mag + torch.sigmoid(cplx_mag)
    s = torch.sigmoid(mag)
    return re + s, im + s, mag_out


def fuse(yc: torch.Tensor, ym: torch.Tensor):
    """`fusion` on channel-concat yc = [re | im] and the real branch ym."""
    c = yc.shape[-1] // 2
    re, im, mag = fusion(yc[..., :c], yc[..., c:], ym)
    return torch.cat([re, im], dim=-1), mag


@widened
def _reference(xc, xm, params):
    def branch(x, w, b, s, t, a):
        y = conv2d_nhwc(x, w, strides=(1, 2), padding=((1, 0), (2, 2)))
        return _prelu((y + b[0]) * s[0] + t[0], a[0, 0])

    return fuse(branch(xc, *params[:5]), branch(xm, *params[5:10]))


TC_CHANNELS = 32  # output channels a tensor-core block: Cout padded to it
TC_K = 32         # K a stage: each tap's Cin padded to it
TAPS = 10         # (2, 5) taps, t-tap major


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def level_design(cin: int, dtype: torch.dtype = torch.float32) -> str:
    """The design csrc/encoder.cu runs a level of `dtype` with: "tc" (the
    implicit GEMM on the tensor cores) where Cin % 4 == 0 (16-byte copies
    of both branches' channels; in bf16 Cin % 8 == 0, 8 channels a copy):
    Uformer's levels 1-5; in bf16 "tc_widened" (the fp32 tensor-core
    kernel on widened inputs) where Cin % 4 == 0 but Cin % 8 != 0;
    "cuda_core" otherwise (level 0, Cin 1, bounded by bytes). Either fp32
    design runs a level whose CUDA-core shared memory fits a block (levels
    0-2); chip_smoke.py times those on both."""
    if cin % 4:
        return "cuda_core"
    return "tc_widened" if dtype == torch.bfloat16 and cin % 8 else "tc"


def _pack_branch(w, parts: int, dtype: torch.dtype):
    """(2, 5, Cin, parts * Cout) HWIO kernel -> (Coutp / 8 * parts * 8,
    10 * Cinp), K-major: K index tap * Cinp + ci with tap = it * 5 + jf over
    input row (t - 1 + it, 2 fo + jf - 2); column (g8, part, c8) for
    channel 8 g8 + c8: per 8 channels the n8 tiles [re, im] (complex) or
    [m] (real). Cin zero-padded to Cinp (a multiple of 32), Cout to Coutp
    (a multiple of 32). In `dtype`."""
    cin, n = w.shape[2], w.shape[3]
    cout = n // parts
    cinp, coutp = _round_up(cin, TC_K), _round_up(cout, TC_CHANNELS)
    full = w.reshape(TAPS, cin, parts, cout)
    full = F.pad(full, (0, coutp - cout, 0, 0, 0, cinp - cin))
    full = full.reshape(TAPS, cinp, parts, coutp // 8, 8)
    packed = full.permute(3, 2, 4, 0, 1)  # (g8, part, c8, tap, ci)
    return packed.reshape(-1, TAPS * cinp).to(dtype).contiguous()


@_build.packs
def pack_encoder_weights(params, dtype: torch.dtype | None = None):
    """The 10-tuple's kernels packed for the tensor-core design, on their
    device: complex (2 Coutp, 10 Cinp_c) and real (Coutp, 10 Cinp_m),
    K-major, in `dtype`; by default in bf16 for bf16 weights (the bf16
    kernel's) and fp32 otherwise (`_dtype.pack_dtype`; the widened route
    takes fp32 packs of bf16 weights). Done once a model (Uformer keeps
    them, a pack a dtype), not once a call."""
    dtype = dtype or pack_dtype(params[0])
    return (_pack_branch(params[0], 2, dtype),
            _pack_branch(params[5], 1, dtype))


def encoder_level(xc: torch.Tensor, xm: torch.Tensor, params, packed=None):
    """xc (B, T, F, 2*Cin), xm (B, T, F, Cin) -> ((B, T, F//2, 2*Cout),
    (B, T, F//2, Cout)). `packed`: `pack_encoder_weights(params)`, where
    the caller keeps it; packed here for a tensor-core level without it.
    B splits over an active mesh's model group (`parallel.map_leading`)."""
    return map_leading(lambda xc, xm, *params: _level(xc, xm, params,
                                                      packed),
                       (xc, xm), tuple(params))


def _level(xc, xm, params, packed):
    if xc.device.type == "cpu":
        return _reference(xc, xm, params)
    design = level_design(xc.shape[-1] // 2, xc.dtype)
    return _autograd.kernel_call(
        lambda xc, xm, params: _launch(xc, xm, params, design, packed),
        _reference, xc, xm, params)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a fresh copy where its data does not start on 16 bytes."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def launch_params(params, shapes, names, weights, dtype: torch.dtype,
                  keep=()):
    """A U-net level's tuple as its launch takes it: checked, in fp32.
    For a bf16 launch the conv weights (indices `weights`) must be bf16
    (the bf16 kernels' products are exact on bf16 values only) and
    every tensor is widened to fp32 but those at `keep` (the weights a
    packed launch does not read), which become None."""
    out = []
    for i, (name, arr, shape) in enumerate(zip(names, params, shapes)):
        if dtype == torch.bfloat16 and i in weights:
            _build.check(arr, shape, name, torch.bfloat16)
            if i in keep:
                out.append(None)
                continue
        arr = arr.float() if dtype == torch.bfloat16 else arr
        _build.check(arr, shape, name)
        out.append(arr)
    return out


def _launch(xc, xm, params, design: str, packed=None, count=True):
    """Launch `design` ("tc", "cuda_core"; bf16 also "tc_widened") on CUDA
    tensors, its fp32 or its bf16 variant by xc and xm's one dtype. A bf16
    launch takes bf16 conv weights (the tensor-core packs bf16) and widens
    the tail vectors to fp32. `count`: add the launch to `_build.LAUNCHES`
    (the widened route counts its fp32 launch as its own)."""
    if design == "tc_widened":
        return widened_launch(
            "encoder",
            lambda xc, xm, params, packed: _launch(xc, xm, params, "tc",
                                                   packed, count=False),
            xc, xm, params, (0, 5), packed, pack_encoder_weights)
    b, t, f, c2 = xc.shape
    cin, cout = c2 // 2, params[5].shape[-1]
    if f % 2:
        raise ValueError(f"encoder kernel: F must be even, got {f}")
    dtype = _build.launch_dtype("encoder", xc, xm)
    names = ("wc", "bc", "sc", "tc", "ac", "wm", "bm", "sm", "tm", "am")
    shapes = ((2, 5, 2 * cin, 2 * cout), (1, 2 * cout), (1, 2 * cout),
              (1, 2 * cout), (1, 1), (2, 5, cin, cout), (1, cout),
              (1, cout), (1, cout), (1, 1))
    _build.check(xc, (b, t, f, 2 * cin), "xc", dtype)
    _build.check(xm, (b, t, f, cin), "xm", dtype)
    if design == "tc" and dtype == torch.bfloat16 and cin % 8:
        raise ValueError(f"encoder kernel: the bf16 tensor-core design "
                         f"copies 8 channels at a time, Cin must be a "
                         f"multiple of 8, got {cin}")
    if design == "tc" and packed is None:
        packed = pack_encoder_weights(params)
    args = launch_params(params, shapes, names, (0, 5), dtype,
                         keep=(0, 5) if design == "tc" else ())
    yc = torch.empty((b, t, f // 2, 2 * cout), device=xc.device,
                     dtype=dtype)
    ym = torch.empty((b, t, f // 2, cout), device=xc.device, dtype=dtype)
    if design == "tc":
        wc, wm = packed
        coutp = _round_up(cout, TC_CHANNELS)
        cinp_c, cinp_m = _round_up(2 * cin, TC_K), _round_up(cin, TC_K)
        _build.check(wc, (2 * coutp, TAPS * cinp_c), "packed wc", dtype)
        _build.check(wm, (coutp, TAPS * cinp_m), "packed wm", dtype)
        _build.launch(_build.variant("se_encoder_level_tc", dtype),
                      _aligned(xc), _aligned(xm), wc, wm, *args[1:5],
                      *args[6:10], yc, ym, b, t, f, cin, cout, cinp_c,
                      cinp_m)
    elif design == "cuda_core":
        _build.launch(_build.variant("se_encoder_level_cc", dtype), xc, xm,
                      *args, yc, ym, b, t, f, cin, cout)
    else:
        raise ValueError(f"unknown encoder design {design!r}")
    if count:
        _build.LAUNCHES[_build.variant("encoder", dtype)] += 1
    return yc, ym
