"""bf16 helpers of the kernel wrappers, their twins and the bf16 kernels'
checks: `widened` runs a twin with the Pallas kernels' bf16 rounding
points and `widened_launch` a kernel's fp32 design with the same points,
`pack_dtype` says what a pack holds, and `bf16_compare` /
`att_flip_slack` are the one tolerance the bf16 kernels are held to, on
the CPU (tests/torch_kernel_inputs.py `bf16_close`) and on the card
(chip_smoke.py phase 3). `promoted` gives a layer's operands the dtype
se_tpu's layers compute in."""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from se_tpu_torch.ops import _build

# one bf16 ulp of each element (two fp32 sums in another order round to
# neighbours), plus 1e-6 of the largest output for elements near zero
BF16_RTOL = 2.0 ** -7
BF16_FLOOR = 1e-6
# attention rounds P to bf16 inside: the share of elements that may pass
# the tolerance above by up to one P element's rounding flip
FLIP_SHARE = 1e-3
# the bf16 LSTM rounds h to bf16 every frame: two runs that sum in other
# orders round an h element to neighbouring bf16 values now and then (a
# flip), and from that frame on their sequences part by what the flip
# moves them, a small fraction of a bf16 ulp of the largest output. Two
# free-running sequences are held to one bf16 ulp of their largest output
# as the floor (`bf16_compare(..., floor=LSTM_FLOOR)`); the same run
# stepped along the other's h (ops/lstm.py `h_in`), which cannot flip, to
# fp32's tolerance
LSTM_FLOOR = BF16_RTOL


def promoted(*tensors: torch.Tensor) -> tuple:
    """The tensors in their one promoted dtype (`torch.promote_types`,
    which for {fp32, bf16} is `jnp.promote_types`): what flax's
    `promote_dtype` gives a Dense, and se_tpu's convs' `kernel.astype(
    x.dtype)` a conv, in a bf16 decode, where every parameter is bf16: an
    fp32 activation widens the bf16 weights to fp32, a bf16 one keeps them
    bf16. torch's matmul and convolutions refuse mixed dtypes, flax
    promotes. A tensor already in that dtype is returned as it is."""
    dtype = functools.reduce(torch.promote_types,
                             (t.dtype for t in tensors))
    return tuple(t.to(dtype) for t in tensors)


def pack_dtype(weight: torch.Tensor, design: str = "tc") -> torch.dtype:
    """The dtype a conv weight keeps in a tensor-core pack for `design`:
    bf16 stays bf16 on "tc" (the B operand of the bf16 kernels'
    `mma.m16n8k16`: the encoder and decoder levels', the DSConv pair
    stage's and the single block's); the widened route ("tc_widened",
    the fp32 kernel) and any other weight pack as fp32."""
    return torch.bfloat16 if weight.dtype == torch.bfloat16 \
        and design == "tc" else torch.float32


def to_float(nest):
    """The tensors of a nest (tuples and lists) widened to fp32; anything
    else as it is."""
    if isinstance(nest, (tuple, list)):
        return type(nest)(to_float(x) for x in nest)
    return nest.float() if isinstance(nest, torch.Tensor) else nest


def widened(twin):
    """`twin` run in bf16 with the Pallas kernels' rounding points: the
    activations and every parameter widened to fp32, the math in fp32,
    each output (a tensor or a tuple of them) rounded to bf16 once
    (pallas_encoder.py:91-94, pallas_decoder.py:110-113,
    pallas_dsconv.py:107-108 and :320-321). fp32 and fp64 calls run
    `twin` as it is."""

    @functools.wraps(twin)
    def run(*args, **kw):
        if args[0].dtype != torch.bfloat16:
            return twin(*args, **kw)
        out = twin(*to_float(args), **kw)
        if isinstance(out, torch.Tensor):
            return out.to(torch.bfloat16)
        return tuple(o.to(torch.bfloat16) for o in out)

    return run


def widened_launch(kernel: str, run, *args):
    """A bf16 U-net level, conformer stage or DSConv block on its kernel's
    fp32 design ("tc_widened", where the bf16 design cannot copy its
    widths). `args`: the activations (one or more), then `params`,
    `weights`, `packed` and `pack`. The bf16 conv weights (indices
    `weights` of the flat `params`) checked, the activations and `params`
    widened to fp32, `run(*activations, params, packed)` the fp32 launches
    (uncounted) on the caller's fp32 packs (`pack(params, torch.float32)`,
    made once where the caller keeps them; here otherwise), the output (a
    tensor or a tuple) rounded to bf16 once: the rounding points of
    `widened`. Counted as `kernel`_bf16 and `kernel`_bf16_widened."""
    *xs, params, weights, packed, pack = args
    if _build.launch_dtype(kernel, *xs) != torch.bfloat16:
        raise ValueError(f"{kernel} kernel: the tc_widened design takes "
                         f"bf16 activations, got {xs[0].dtype}")
    for i in weights:
        if params[i].dtype != torch.bfloat16:
            raise TypeError(f"{kernel} kernel: a bf16 launch takes bf16 "
                            f"conv weights, got {params[i].dtype}")
    if packed is None:
        packed = pack(params, torch.float32)
    out = run(*(x.float() for x in xs), to_float(tuple(params)), packed)
    _build.LAUNCHES[f"{kernel}_bf16"] += 1
    _build.LAUNCHES[f"{kernel}_bf16_widened"] += 1
    if isinstance(out, torch.Tensor):
        return out.to(torch.bfloat16)
    return tuple(o.to(torch.bfloat16) for o in out)


def att_flip_slack(q, k, v, scale: float) -> torch.Tensor:
    """What one rounding flip of a bf16 P element can move attention's
    output by, per (n, h, row, d): 2^-7 (a bf16 ulp's relative bound) x
    the row's largest P (softmax in fp32 on the widened inputs) x the
    column's largest |v|. Two fp32 softmaxes that sum in another order
    round an element of P to neighbours now and then. N in chunks of at
    most 2**26 scores."""
    n, h, length, _ = q.shape
    step = max(1, 2 ** 26 // (h * length * length))
    out = []
    for i in range(0, n, step):
        qf, kf, vf = (t[i:i + step].detach().float() for t in (q, k, v))
        p = torch.softmax(torch.einsum("nhld,nhmd->nhlm", qf, kf) * scale,
                          -1)
        out.append(BF16_RTOL * p.amax(-1, keepdim=True)
                   * vf.abs().amax(-2, keepdim=True))
    return torch.cat(out)


class Bf16Check(NamedTuple):
    max_abs_err: float
    n_past: int            # elements past the strict bound
    share_past: float
    share_differing: float  # elements that differ at all
    ok: bool


def bf16_compare(got, want, slack=None, floor: float = BF16_FLOOR
                 ) -> Bf16Check:
    """|got - want| <= 2^-7 |want| + floor max|want| elementwise over the
    pairs of tensors (floor 1e-6; LSTM_FLOOR for two free-running bf16
    LSTM sequences); with `slack` (one per pair, None for none:
    att_flip_slack), at most FLIP_SHARE of a pair's elements may pass that
    bound, each by no more than its slack."""
    err_max, past_n, diff_n, total, ok = 0.0, 0, 0, 0, True
    slack = [None] * len(got) if slack is None else slack
    for g, w, sl in zip(got, want, slack):
        g, w = g.detach().float(), w.detach().float()
        if g.shape != w.shape:
            raise ValueError(f"shapes differ: {tuple(g.shape)} and "
                             f"{tuple(w.shape)}")
        err = (g - w).abs()
        tol = BF16_RTOL * w.abs() + floor * float(w.abs().max())
        past = err > tol
        if sl is None:
            ok = ok and not bool(past.any())
        else:
            ok = (ok and bool((err <= tol + sl.to(err.device)).all())
                  and float(past.float().mean()) <= FLIP_SHARE)
        err_max = max(err_max, float(err.max()))
        past_n += int(past.sum())
        diff_n += int((err > 0).sum())
        total += err.numel()
    total = max(total, 1)
    return Bf16Check(err_max, past_n, past_n / total, diff_n / total, ok)


# a bf16 train step's gradients. Each tensor's floor is one bf16 ulp
# (2^-7) of the step's largest gradient, capped at FLOOR_SHARE of the
# tensor's own largest |value|, so that a tensor is held at its own scale
# however small its gradient: a zeroed or negated tensor fails wherever the
# reference's bf16 step resolves it. The cap is lifted (the floor is the
# step's) for two kinds of tensor, whose bf16 distance is round-off at the
# scale of their terms, not of their own value: one the reference's bf16
# step does not resolve (its distance from fp32 at least UNRESOLVED of the
# tensor's scale: a conv bias before BN with batch statistics, an attention
# key bias, zero in exact arithmetic), and a scalar (a PReLU slope, a
# ShareSepConv kernel of one tap: one sum of ~1e5-1e6 terms that cancel,
# whose distance is one draw, so twice another step's does not bound it).
STEP_FLOOR = BF16_RTOL
FLOOR_SHARE = 0.25
UNRESOLVED = 0.5
# the BN statistics and the loss: 1e-6 of their own scale
STAT_FLOOR = 1e-6
# a bf16 step is in effect: the reference's gradients part from its fp32
# step's by more than this share, pooled over the step (and the checked
# step's by half of theirs at least)
BF16_IN_EFFECT = 1e-3
# the share of a step's tensors that may pass twice the reference's
# distance (each within four times it, plus the floor): where bf16 parts a
# step far from fp32 (G2Net's), the distances of two equally good bf16
# steps from fp32 scatter around each other by up to a few times
STRAY_SHARE = 0.01


class StepCheck(NamedTuple):
    failures: list   # (name, e_got, e_ref, limit): tensors past 2 e_ref
    pooled_got: float  # sum |got - fp32| / sum |fp32| over the gradients
    pooled_ref: float  # the same for the reference's bf16 step
    ok: bool
    uncapped: int  # gradients whose floor is the step's, cap lifted
    worst: float   # the largest e_got / (2 e_ref + floor) over the tensors


def cap_lifted(e_ref: float, scale: float, numel: int) -> bool:
    """A gradient tensor of `numel` entries and largest |fp32 value|
    `scale`, `e_ref` from the reference's bf16 step, whose floor is the
    step's, uncapped: a scalar, or one the reference does not resolve."""
    return numel == 1 or e_ref >= UNRESOLVED * scale


def bf16_step_compare(got: dict, ref16: dict, ref32: dict) -> StepCheck:
    """A bf16 train step `got` against a reference's bf16 (`ref16`) and
    fp32 (`ref32`) steps from the same weights and batch; each a dict
    name -> tensor or array: "loss", every gradient, and the BN statistics
    after the step (names holding "running"). Each tensor's distance from
    fp32, e = max |x - ref32|, within twice the reference bf16's own plus
    a floor: for a gradient STEP_FLOOR x the step's largest |gradient|,
    capped at FLOOR_SHARE x the tensor's largest |value| unless
    `cap_lifted`; STAT_FLOOR x the tensor's largest |value| for the loss
    and a statistic. At most STRAY_SHARE of the tensors past that, each
    within four times the reference's plus the floor. Pooled over the
    gradients, sum |got - ref32| within half and twice the reference's,
    which is above BF16_IN_EFFECT of sum |ref32|: bf16 in effect on both
    sides (a step that left weights in fp32 would part from fp32 by
    less). A non-finite value fails its tensor; in a reference step it
    raises ValueError."""
    def arr(x):
        x = x.detach().cpu().double() if isinstance(x, torch.Tensor) \
            else torch.as_tensor(x, dtype=torch.float64)
        return x.reshape(-1)

    g, r16, r32 = ({k: arr(v) for k, v in d.items()}
                   for d in (got, ref16, ref32))
    if g.keys() != r32.keys() or r16.keys() != r32.keys():
        raise ValueError(f"the steps hold other tensors: "
                         f"{sorted(set(g) ^ set(r32))}"
                         f"{sorted(set(r16) ^ set(r32))}")
    broken = [k for d in (r16, r32) for k, v in d.items()
              if not bool(torch.isfinite(v).all())]
    if broken:
        raise ValueError(f"a reference step holds non-finite values: "
                         f"{broken[:4]}")
    grads = [k for k in r32 if k != "loss" and "running" not in k]
    gmax = max(float(r32[k].abs().max()) for k in grads)
    failures, strays_ok, uncapped, worst = [], True, 0, 0.0
    for k, want in r32.items():
        e_got = float((g[k] - want).abs().max()) \
            if bool(torch.isfinite(g[k]).all()) else float("inf")
        e_ref = float((r16[k] - want).abs().max())
        scale = float(want.abs().max())
        if k not in grads:
            floor = STAT_FLOOR * scale
        elif cap_lifted(e_ref, scale, want.numel()):
            floor = STEP_FLOOR * gmax
            uncapped += 1
        else:
            floor = min(STEP_FLOOR * gmax, FLOOR_SHARE * scale)
        worst = max(worst, e_got / (2 * e_ref + floor))
        if e_got > 2 * e_ref + floor:
            failures.append((k, e_got, e_ref, 2 * e_ref + floor))
            strays_ok = strays_ok and e_got <= 4 * e_ref + floor
    total = sum(float(r32[k].abs().sum()) for k in grads)
    pooled_got = sum(float((g[k] - r32[k]).abs().sum())
                     for k in grads) / total
    pooled_ref = sum(float((r16[k] - r32[k]).abs().sum())
                     for k in grads) / total
    ok = (strays_ok and len(failures) <= STRAY_SHARE * len(r32)
          and pooled_ref / 2 <= pooled_got <= 2 * pooled_ref
          and BF16_IN_EFFECT < pooled_ref)
    return StepCheck(failures, pooled_got, pooled_ref, ok, uncapped, worst)
