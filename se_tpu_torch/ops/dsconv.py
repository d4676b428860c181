"""Gated dilated DSConv blocks of the Uformer conformer: the port of
`dsconv_block` (kernel `_kernel`, math `_block_math`) and
`dsconv_pair_block` (kernel `_pair_kernel`, math `_pair_math`) in
se_tpu/ops/pallas_dsconv.py.

One block, on x (B, T, F, Cin) channel-concat ([re | im] for the complex
branch, ncomp = 2; the real branch has ncomp = 1):
LN per component (shared gamma/beta) -> 1x1 conv -> PReLU -> two 3x3 convs
dilated along T by d1 and d2 -> a * sigmoid(g) -> LN per component ->
z * sigmoid(z) -> 1x1 conv -> + x.

`params` is se_tpu's 13-tuple (`_dsconv_params`): (g1, b1, w1, bb1, alpha,
wd1, bd1, wd2, bd2, g2, b2, ws, bs), vectors shaped (1, C), alpha (1, 1),
the dilated kernels flattened to (9*Cm, Cm) in (t-tap, f-tap, cin) row
order. On a CUDA tensor `dsconv_block` launches csrc/dsconv.cu's
`se_dsconv_block_tc` (the pair stage's tensor-core design for one branch:
LN1 -> 1x1 conv -> PReLU in one launch, the rest in another), with the
weights `pack_block_weights` lays out (once a module: DSConvCplx and
DSConvReal keep them); on a CPU tensor it runs `_reference`, the plain
twin.

`dsconv_pair_block` is one conformer stage: the complex block on xc =
[re | im], the real block on xm and Uformer's cross-branch fusion. On a
CUDA tensor it launches csrc/dsconv.cu's pair entry `se_dsconv_pair_tc`
(both branches' LN1 -> 1x1 conv -> PReLU in one tensor-core launch, then
one launch for the rest of both blocks and the fusion, its convs implicit
GEMMs on the tensor cores), with the weights `pack_pair_weights` lays out
(once a model: Uformer keeps them); on a CPU tensor it runs
`_pair_reference`.

Under autograd both launches are Functions (`_autograd.kernel_call`) whose
backwards are the VJPs of `_reference` and `_pair_reference`, recomputed
(se_tpu's `pallas_dsconv.py:245-249` and `:370-375`); the packs are
constants to them.

bf16 activations launch the bf16 variants (`se_dsconv_block_tc_bf16`
and `se_dsconv_pair_tc_bf16`, counted as `dsconv_bf16` and
`dsconv_pair_bf16`): bf16 parameters, every intermediate fp32 (the scratch
y between the two launches too), the outputs rounded once, as se_tpu's
Pallas kernels; `_reference` and `_pair_reference` mirror that
(`_dtype.widened`). Both keep their packed weights bf16 (bf16
`mma.m16n8k16`, each fp32 operand in three bf16 pieces) where x's
channels are a multiple of 8 and the blocks' widths multiples of 16 (the
conformer's: Cin 256 and 128, Cm 64 and 32), and otherwise take
"tc_widened" (`block_design`, `pair_design`, `_dtype.widened_launch`):
the fp32 kernels on the widened inputs and fp32 packs, the outputs
rounded to bf16 once, counted also as `dsconv_bf16_widened` and
`dsconv_pair_bf16_widened`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from se_tpu_torch.nn.conv import conv2d_nhwc
from se_tpu_torch.ops import _autograd, _build
from se_tpu_torch.ops._dtype import pack_dtype, widened, widened_launch
from se_tpu_torch.ops.encoder import _aligned, _round_up
from se_tpu_torch.parallel.mesh import map_leading

_LN_EPS = 1e-5
_FUSION_EPS = float(np.finfo(np.float32).eps)


def _prelu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


@widened
def _reference(x, params, d1: int, d2: int, ncomp: int):
    """One block. In bf16 with the Pallas kernel's rounding points
    (`_dtype.widened`: fp32 inside, the output rounded once), as se_tpu's
    `_reference` widens x too (pallas_dsconv.py:199, :232)."""
    (g1, b1, w1, bb1, alpha, wd1, bd1, wd2, bd2, g2, b2, ws, bs) = params
    tot = w1.shape[1]

    def ln(z, g, b):
        c = z.shape[-1] // ncomp
        zs = z.reshape(*z.shape[:-1], ncomp, c)
        mu = zs.mean(-1, keepdim=True)
        var = (zs - mu).square().mean(-1, keepdim=True)
        zn = ((zs - mu) * torch.rsqrt(var + _LN_EPS)).reshape(z.shape)
        return zn * g[0] + b[0]

    y = torch.matmul(ln(x, g1, b1), w1) + bb1[0]
    y = _prelu(y, alpha[0, 0])

    def dconv(w9, b, d):
        w = w9.reshape(3, 3, tot, tot)
        return conv2d_nhwc(y, w, padding=((d, d), (1, 1)),
                           dilation=(d, 1)) + b[0]

    z = dconv(wd1, bd1, d1) * torch.sigmoid(dconv(wd2, bd2, d2))
    z = ln(z, g2, b2)
    z = z * torch.sigmoid(z)
    return x + (torch.matmul(z, ws) + bs[0])


PAIR_WEIGHTS = (2, 5, 7, 11)  # w1, wd1, wd2, ws in a 13-tuple
PAIR_K = 32           # K a stage: Cin and each dilated tap's Cm padded to it
PAIR_N = (64, 32)     # the block's N, complex and real: Cm padded to it
PAIR_CO = 32          # fusion channels an output pass: C padded to it


def _pack_branch(params, n_cols: int, dtype: torch.dtype):
    """One block's 13-tuple with w1, g1, b1, wd1, wd2 packed for the
    tensor-core stage (ws and bs as they are; `pack_pair_weights` packs the
    two blocks' ws together). w1 (n_cols, K1p): column c of w1 as row c, Cin
    zero-padded to K1p (a multiple of 32), Cm to n_cols; g1, b1 (K1p,) zero
    past Cin; wd (n_cols, 9 Cmp): K index tap * Cmp + ci with tap = 3 i + j
    (t-tap i, f-tap j), each tap's Cm zero-padded to Cmp (a multiple of
    32). w1 and wd in `dtype`, the rest fp32."""
    (g1, b1, w1, bb1, alpha, wd1, bd1, wd2, bd2, g2, b2, ws, bs) = params
    cin, tot = w1.shape
    k1p, totp = _round_up(cin, PAIR_K), _round_up(tot, PAIR_K)
    w1p = F.pad(w1.t(), (0, k1p - cin, 0, n_cols - tot)).contiguous()

    def vec(v):
        return F.pad(v[0], (0, k1p - cin)).contiguous()

    def dil(wd):
        w = wd.reshape(9, tot, tot)  # (tap, ci, co)
        w = F.pad(w, (0, n_cols - tot, 0, totp - tot))
        return w.permute(2, 0, 1).reshape(n_cols, 9 * totp).contiguous()

    out = [t.float() for t in (w1p, vec(g1), vec(b1), bb1, alpha, dil(wd1),
                               bd1, dil(wd2), bd2, g2, b2, ws, bs)]
    for i in (0, 5, 7):
        out[i] = out[i].to(dtype)
    return out


def _check_block(x, params, ncomp: int, what: str) -> int:
    """Raise unless x and the 13-tuple suit the tensor-core kernels: ncomp
    1 or 2, Cin and Cm multiples of 4 (16-byte copies), Cm <= 64 for ncomp
    2 and <= 32 for ncomp 1 (a block's N, `PAIR_N`), every tensor a
    contiguous CUDA tensor of the tuple's shape and of x's dtype (fp32, or
    bf16 for the bf16 variants). Return Cm."""
    (g1, b1, w1, bb1, alpha, wd1, bd1, wd2, bd2, g2, b2, ws, bs) = params
    cin, tot = x.shape[-1], w1.shape[-1]
    if (ncomp not in (1, 2) or cin % 4 or tot % 4 or tot % ncomp
            or tot > PAIR_N[ncomp == 1]):
        raise ValueError(f"{what} kernel: needs ncomp 1 or 2, Cin and Cm "
                         f"multiples of 4 and Cm <= {PAIR_N[ncomp == 1]}, "
                         f"got ncomp={ncomp}, Cin={cin}, Cm={tot}")
    shapes = {"x": (x, x.shape), "g1": (g1, (1, cin)),
              "b1": (b1, (1, cin)), "w1": (w1, (cin, tot)),
              "bb1": (bb1, (1, tot)), "alpha": (alpha, (1, 1)),
              "wd1": (wd1, (9 * tot, tot)), "bd1": (bd1, (1, tot)),
              "wd2": (wd2, (9 * tot, tot)), "bd2": (bd2, (1, tot)),
              "g2": (g2, (1, tot)), "b2": (b2, (1, tot)),
              "ws": (ws, (tot, cin)), "bs": (bs, (1, cin))}
    for name, (arr, shape) in shapes.items():
        _build.check(arr, shape, name, x.dtype)
    return tot


def _check_packed(pk, cin: int, tot: int, ncomp: int, ws_rows: int,
                  name: str, weights: torch.dtype = torch.float32) -> None:
    """Raise unless a packed 13-tuple has `_pack_branch`'s shapes for (Cin,
    Cm, ncomp) and a packed ws of ws_rows rows of round_up(Cm, 8), its
    weights in `weights` and its vectors fp32."""
    k1p, totp = _round_up(cin, PAIR_K), _round_up(tot, PAIR_K)
    n = PAIR_N[ncomp == 1]
    for i, shape in ((0, (n, k1p)), (1, (k1p,)), (2, (k1p,)),
                     (5, (n, 9 * totp)), (7, (n, 9 * totp)),
                     (11, (ws_rows, _round_up(tot, 8)))):
        _build.check(pk[i], shape, f"packed {name} [{i}]",
                     weights if i in (0, 5, 7, 11) else torch.float32)


@_build.packs
def pack_block_weights(params, ncomp: int, dtype: torch.dtype | None = None):
    """One block's 13-tuple as csrc/dsconv.cu's `se_dsconv_block_tc` (or,
    from bf16 weights, `se_dsconv_block_tc_bf16`) takes it, on its device:
    `_pack_branch`'s (N = 64 for ncomp 2, 32 for ncomp 1), and ws (Cm, Cin)
    K-major: (Cin, round_up(Cm, 8)), row c = column c of ws, zero past Cm.
    The weights w1, wd1, wd2 and ws in `dtype`, by default `pack_dtype`'s
    for the block's design (`block_design`: bf16 on "tc", fp32 on the
    widened route), the vectors fp32. Done once a module (DSConvCplx and
    DSConvReal keep it), not once a call."""
    params = tuple(params)
    w1, ws = params[2], params[11]
    cin, tot = w1.shape
    dtype = dtype or pack_dtype(w1, block_design(cin, tot, w1.dtype))
    packed = _pack_branch(params, PAIR_N[ncomp == 1], dtype)
    packed[11] = F.pad(ws, (0, 0, 0, _round_up(tot, 8) - tot)).t() \
        .to(dtype).contiguous()
    return tuple(packed)


def block_design(cin: int, tot: int,
                 dtype: torch.dtype = torch.float32) -> str:
    """The design a block of `dtype` runs with, Cin its channels and tot
    its width: "tc" (the tensor-core kernels; in bf16
    `se_dsconv_block_tc_bf16`, which copies 8 channels of x at a time and
    steps the output GEMM by k16: Cin % 8 == 0, tot % 16 == 0); in bf16
    "tc_widened" otherwise (the fp32 block on widened inputs)."""
    if dtype == torch.bfloat16 and (cin % 8 or tot % 16):
        return "tc_widened"
    return "tc"


def dsconv_block(x: torch.Tensor, params, d1: int, d2: int, ncomp: int,
                 packed=None) -> torch.Tensor:
    """x (B, T, F, Cin) -> same shape, residual included. `packed`:
    `pack_block_weights(params, ncomp)`, where the caller keeps it; packed
    here without it. B splits over an active mesh's model group
    (`parallel.map_leading`)."""
    return map_leading(lambda x, *params: _block(x, params, d1, d2, ncomp,
                                                 packed), (x,), tuple(params))


def _block(x, params, d1: int, d2: int, ncomp: int, packed):
    if x.device.type == "cpu":
        return _reference(x, params, d1, d2, ncomp)
    return _autograd.kernel_call(
        lambda x, params: _block_launch(x, params, d1, d2, ncomp, packed),
        lambda x, params: _reference(x, params, d1, d2, ncomp), x, params)


def _block_launch(x, params, d1: int, d2: int, ncomp: int, packed,
                  count=True):
    """The block's two launches, fp32 or bf16 by x's dtype
    (`block_design`'s "tc_widened": the fp32 launches on the widened
    input); the scratch y between them is fp32 either way. `count` as the
    encoder's `_launch`."""
    dtype = _build.launch_dtype("dsconv", x)
    b, t, f, cin = x.shape
    tot = _check_block(x, params, ncomp, "dsconv")
    if block_design(cin, tot, dtype) == "tc_widened":
        return widened_launch(
            "dsconv",
            lambda x, p, pk: _block_launch(x, p, d1, d2, ncomp, pk, False),
            x, params, PAIR_WEIGHTS, packed,
            lambda p, dtype: pack_block_weights(p, ncomp, dtype))
    pk = pack_block_weights(params, ncomp) if packed is None else packed
    _check_packed(pk, cin, tot, ncomp, cin, "block", dtype)
    y = torch.empty((b, t, f, tot), device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    _build.launch(_build.variant("se_dsconv_block_tc", dtype), _aligned(x),
                  *pk, y, out, b, t, f, cin, tot, ncomp, d1, d2)
    if count:
        _build.LAUNCHES[_build.variant("dsconv", dtype)] += 1
    return out


@widened
def _pair_reference(xc, xm, params_c, params_m, d1: int, d2: int):
    """Both blocks, then the fusion: |z| = sqrt(max(re^2 + im^2, eps)),
    re/im += sigmoid(m), m += sigmoid(|z|). In bf16 with the Pallas pair
    kernel's rounding points (`_dtype.widened`: fp32 inside, the two outputs
    rounded once), not se_tpu's `_pair_reference`'s, which rounds each
    block's output before the fusion."""
    yc = _reference(xc, tuple(params_c), d1, d2, ncomp=2)
    ym = _reference(xm, tuple(params_m), d1, d2, ncomp=1)
    c = yc.shape[-1] // 2
    re, im = yc[..., :c], yc[..., c:]
    cplx_mag = torch.sqrt(torch.clamp(re * re + im * im, min=_FUSION_EPS))
    s = torch.sigmoid(ym)
    return torch.cat([re + s, im + s], dim=-1), ym + torch.sigmoid(cplx_mag)


def _pack_out(wsc, wsm, dtype: torch.dtype):
    """The output 1x1 convs' ws of both blocks as the stage's GEMM reads
    them, K-major: complex (Cp / 8 * 2 * 8, round_up(Cm_c, 8)), row (g8,
    part, c8) = column part * C + 8 g8 + c8 of wsc (per 8 fusion channels
    the n8 tiles re, im); real (Cp, round_up(Cm_m, 8)), row c = column c of
    wsm. C zero-padded to Cp (a multiple of 32), K with zeros; in
    `dtype`."""
    totc, c2 = wsc.shape
    totm, c = wsm.shape
    cp, kc, km = _round_up(c, PAIR_CO), _round_up(totc, 8), _round_up(totm, 8)
    wc = F.pad(wsc.reshape(totc, 2, c), (0, cp - c, 0, 0, 0, kc - totc))
    wc = wc.reshape(kc, 2, cp // 8, 8).permute(2, 1, 3, 0)
    wm = F.pad(wsm, (0, cp - c, 0, km - totm)).t()
    return (wc.reshape(-1, kc).to(dtype).contiguous(),
            wm.to(dtype).contiguous())


@_build.packs
def pack_pair_weights(params_c, params_m, dtype: torch.dtype | None = None):
    """Both blocks' 13-tuples as csrc/dsconv.cu's `se_dsconv_pair_tc` (or,
    from bf16 weights, `se_dsconv_pair_tc_bf16`) takes them, on their
    device: (complex, real), each (w1p, g1p, b1p, bb1, alpha, wd1p, bd1,
    wd2p, bd2, g2, b2, ws packed, bs), the weights w1p, wd1p, wd2p and ws
    in `dtype`, by default `_dtype.pack_dtype`'s (bf16 stays bf16; the
    widened route takes fp32 packs of bf16 weights), the vectors fp32.
    Done once a model (Uformer keeps them, a pack a dtype), not once a
    call."""
    dtype = dtype or pack_dtype(params_c[2])
    pc = _pack_branch(tuple(params_c), PAIR_N[0], dtype)
    pm = _pack_branch(tuple(params_m), PAIR_N[1], dtype)
    pc[11], pm[11] = _pack_out(params_c[11], params_m[11], dtype)
    return tuple(pc), tuple(pm)


def _check_pair(xc, xm, params_c, params_m):
    """Raise unless the stage suits the tensor-core kernels."""
    b, t, f, cc = xc.shape
    cm = xm.shape[-1]
    if xm.shape != (b, t, f, cc // 2) or cc != 2 * cm:
        raise ValueError(f"dsconv_pair kernel: xc {tuple(xc.shape)} must be "
                         f"xm {tuple(xm.shape)} with twice the channels")
    return (_check_block(xc, params_c, 2, "dsconv_pair"),
            _check_block(xm, params_m, 1, "dsconv_pair"))


def dsconv_pair_block(xc: torch.Tensor, xm: torch.Tensor, params_c,
                      params_m, d1: int, d2: int, packed=None):
    """One conformer stage: xc (B, T, F, 2C) = [re | im] and xm (B, T, F,
    C) -> (oc, om) of the same shapes, residuals and fusion included.
    `packed`: `pack_pair_weights(params_c, params_m)`, where the caller
    keeps it; packed here without it. B splits over an active mesh's model
    group (`parallel.map_leading`)."""
    params_c, params_m = tuple(params_c), tuple(params_m)
    n = len(params_c)
    return map_leading(lambda xc, xm, *p: _pair(xc, xm, p[:n], p[n:], d1, d2,
                                                packed),
                       (xc, xm), params_c + params_m)


def _pair(xc, xm, params_c, params_m, d1: int, d2: int, packed):
    if xc.device.type == "cpu":
        return _pair_reference(xc, xm, params_c, params_m, d1, d2)
    return _autograd.kernel_call(
        lambda xc, xm, pc, pm: _pair_launch(xc, xm, pc, pm, d1, d2, packed),
        lambda xc, xm, pc, pm: _pair_reference(xc, xm, pc, pm, d1, d2),
        xc, xm, params_c, params_m)


def pair_design(c: int, totc: int, totm: int,
                dtype: torch.dtype = torch.float32) -> str:
    """The design a conformer stage of `dtype` runs with, C the real
    branch's channels and totc / totm the blocks' widths: "tc" (the stage's
    tensor-core kernels; in bf16 `se_dsconv_pair_tc_bf16`, which copies 8
    channels of C at a time and steps both blocks' widths by k16: C % 8 ==
    0, totc % 16 == totm % 16 == 0); in bf16 "tc_widened" otherwise (the
    fp32 stage on widened inputs)."""
    if dtype == torch.bfloat16 and (c % 8 or totc % 16 or totm % 16):
        return "tc_widened"
    return "tc"


def _pair_launch(xc, xm, params_c, params_m, d1: int, d2: int, packed,
                 count=True):
    """The stage's two launches, fp32 or bf16 by xc and xm's one dtype
    (`pair_design`'s "tc_widened": the fp32 launches on widened inputs);
    the scratch y between them is fp32 either way. `count` as the
    encoder's `_launch`."""
    b, t, f, cc = xc.shape
    cm = xm.shape[-1]
    dtype = _build.launch_dtype("dsconv_pair", xc, xm)
    totc, totm = _check_pair(xc, xm, params_c, params_m)
    if pair_design(cm, totc, totm, dtype) == "tc_widened":
        n = len(params_c)
        return widened_launch(
            "dsconv_pair",
            lambda xc, xm, p, pk: _pair_launch(xc, xm, p[:n], p[n:], d1, d2,
                                               pk, False),
            xc, xm, params_c + params_m, PAIR_WEIGHTS + tuple(
                n + i for i in PAIR_WEIGHTS), packed,
            lambda p, dtype: pack_pair_weights(p[:n], p[n:], dtype))
    pc, pm = pack_pair_weights(params_c, params_m) if packed is None \
        else packed
    cp = _round_up(cm, PAIR_CO)
    _check_packed(pc, cc, totc, 2, 2 * cp, "complex", dtype)
    _check_packed(pm, cm, totm, 1, cp, "real", dtype)
    yc = torch.empty((b, t, f, totc), device=xc.device, dtype=torch.float32)
    ym = torch.empty((b, t, f, totm), device=xc.device, dtype=torch.float32)
    oc, om = torch.empty_like(xc), torch.empty_like(xm)
    _build.launch(_build.variant("se_dsconv_pair_tc", dtype), _aligned(xc),
                  _aligned(xm), *pc, *pm, yc, ym, oc, om, b, t, f, cm, totc,
                  totm, d1, d2)
    if count:
        _build.LAUNCHES[_build.variant("dsconv_pair", dtype)] += 1
    return oc, om
