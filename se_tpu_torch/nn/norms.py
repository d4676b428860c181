"""Norms of se_tpu/nn/norms.py on channel-last tensors, with the reference
PyTorch parameter and buffer names: LayerNorm, ChannelWiseLayerNorm and
BatchNorm over the last axis; the instance norms and the cumulative
(causal) layer norms of the TCM families (CTSNet, TaylorSENet, G2Net);
DeepXi's: flax's LayerNorm with its one-pass variance, and the
reference's frame, sequence and sequence-causal norms. No norm but
BatchNorm keeps running statistics, so the others act alike in train and
eval mode."""

from __future__ import annotations

import torch
from torch import nn

from se_tpu_torch.parallel.collectives import all_reduce
from se_tpu_torch.parallel.mesh import active_mesh


class LayerNorm(nn.Module):
    """LayerNorm over the trailing axes of `shape` (an int: the last axis;
    DPCRN's (F, C): the last two), eps 1e-5, statistics in fp32 at least
    (fp64 for an fp64 input): (x - mean) / sqrt(var + eps) * weight +
    bias."""

    def __init__(self, shape: int | tuple[int, ...], eps: float = 1e-5):
        super().__init__()
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.eps = eps
        self.axes = tuple(range(-len(shape), 0))
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(self.axes, keepdim=True)
        var = (xf - mean).square().mean(self.axes, keepdim=True)
        y = (xf - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
        return (y * self.weight + self.bias).to(x.dtype)


class ChannelWiseLayerNorm(nn.Module):
    """LayerNorm over the channel axis of (B, T, C) sequences with affine
    parameters, eps 1e-5, statistics in fp32 (ref FullSubNet
    feature.py:396-414, an nn.LayerNorm whose input it transposes to put C
    last: this layout has it there; se_tpu/nn/norms.py:272). The reference's
    `weight` is se_tpu's `scale`. No model of either package uses it."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
        return (y * self.weight + self.bias).to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis, eps 1e-5, as se_tpu's (flax's
    nn.BatchNorm with momentum 1 - 0.1). In eval mode it reads the running
    statistics. In train mode (`module.train()`) it normalises with the
    batch statistics over every axis but the last, the variance biased
    (under an active mesh the global batch's, `_batch_var_mean`),
    and updates running = 0.9 running + 0.1 batch (the biased variance
    too, unlike torch's F.batch_norm). It starts in eval mode. Holds
    torch.nn.BatchNorm*d's weight, bias, running_mean and running_var. A
    bf16 copy's statistics are bf16: on a bf16 input every step rounds to
    bf16, on an fp32 one the folded scale does, as flax's. In train mode
    the batch statistics and the normalisation are at least fp32 and the
    output takes x's dtype, and the running statistics are replaced by
    flax's 0.9 old + 0.1 batch (`_momentum`)."""

    momentum = 0.1

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.eval()  # as the port's models, until train() asks for it

    def affine(self, dtype: torch.dtype | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(scale, shift) with BN(x) = x * scale + shift, folded in `dtype`
        (None: the parameters' own) from the parameters' values: the bf16
        U-net level kernels take it folded in fp32 from the bf16 values."""
        w, b, mean, var = (t if dtype is None else t.to(dtype)
                           for t in (self.weight, self.bias,
                                     self.running_mean, self.running_var))
        inv = torch.rsqrt(var + self.eps) * w
        return inv, b - mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:  # flax's order: (x - mean) * (rsqrt * scale)
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (x - self.running_mean) * inv + self.bias
        xs = x.to(_stat_dtype(x))
        var, mean = _batch_var_mean(xs)
        keep = 1.0 - self.momentum
        with torch.no_grad():
            self.running_mean = _momentum(self.running_mean, mean, keep)
            self.running_var = _momentum(self.running_var, var, keep)
        y = (xs - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
        return y.to(x.dtype)


def _batch_var_mean(xs: torch.Tensor):
    """The biased variance and the mean over every axis but the last.
    Under an active mesh they are the global batch's, on every rank, in
    two passes: the all-reduced sum and count give the mean, then the
    all-reduced sum of (x - mean)^2 the variance (collectives.all_reduce,
    whose backward all-reduces the gradient)."""
    dims = tuple(range(xs.ndim - 1))
    mesh = active_mesh()
    if mesh is None or mesh.data == 1:
        return torch.var_mean(xs, dim=dims, correction=0)
    count = torch.full((1,), xs.numel() // xs.shape[-1], dtype=xs.dtype,
                       device=xs.device)
    total = all_reduce(torch.cat([xs.sum(dims), count]), mesh)
    mean = total[:-1] / total[-1]
    var = all_reduce((xs - mean).square().sum(dims), mesh) / total[-1]
    return var, mean


def _momentum(old: torch.Tensor, batch: torch.Tensor,
              keep: float) -> torch.Tensor:
    """flax's `keep * old + (1 - keep) * batch` as XLA computes it, in the
    batch statistics' dtype: `keep` is weakly typed, so it rounds to the
    old statistics' dtype (bf16 in a bf16 train step, whose casts they
    are: 0.8984375), and the product is not rounded (XLA's excess
    precision inside a fusion)."""
    k = float(torch.tensor(keep, dtype=old.dtype))
    return old.to(batch.dtype) * k + batch * (1.0 - keep)


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32 statistics at least, fp64 for an fp64 input."""
    return torch.promote_types(x.dtype, torch.float32)


class InstanceNorm(nn.Module):
    """Per (sample, channel) statistics over every axis between the batch
    and the channel ((T, F) on (B, T, F, C), T on (B, T, C)), eps 1e-5:
    (x - mean) * 1 / sqrt(var + eps) * weight + bias, the variance biased;
    torch.nn.InstanceNorm*d(affine=True)'s weight and bias (C,)."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(_stat_dtype(x))
        axes = tuple(range(1, x.ndim - 1))
        mean = xf.mean(axes, keepdim=True)
        var = (xf - mean).square().mean(axes, keepdim=True)
        y = (xf - mean) * torch.reciprocal(torch.sqrt(var + self.eps))
        return (y * self.weight + self.bias).to(x.dtype)


# the reference's two instance norms are one module on channel-last input
InstanceNorm1d = InstanceNorm2d = InstanceNorm


def cumulative_stats(x: torch.Tensor, eps: float):
    """Mean and std over every axis after T (axis 1) and every frame up to
    t, formula for formula as se_tpu's `_cumulative_stats`: the one-pass
    variance (cum_pow - 2 cum_mean cum_sum) / cnt + cum_mean^2, with eps
    inside the sqrt."""
    axes = tuple(range(2, x.ndim))
    n_per_step = 1
    for a in axes:
        n_per_step *= x.shape[a]
    step_sum = x.sum(axes, keepdim=True)
    step_pow = x.square().sum(axes, keepdim=True)
    cum_sum = torch.cumsum(step_sum, dim=1)
    cum_pow = torch.cumsum(step_pow, dim=1)
    t_len = x.shape[1]
    entry_cnt = torch.arange(1, t_len + 1, dtype=x.dtype, device=x.device)
    entry_cnt = entry_cnt.reshape((1, t_len) + (1,) * len(axes)) * n_per_step
    cum_mean = cum_sum / entry_cnt
    cum_var = (cum_pow - 2.0 * cum_mean * cum_sum) / entry_cnt \
        + cum_mean.square()
    return cum_mean, torch.sqrt(cum_var + eps)


class _CumulativeLayerNorm(nn.Module):
    """Causal LN: statistics over every axis after T and every frame up to
    t, eps 1e-5: (x - mean) / std * gain + bias. The reference's gain and
    bias have shape (1, C) + (1,) * (axes after C in its (B, C, ...)
    layout)."""

    trailing = 0

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        shape = (1, ch) + (1,) * self.trailing
        self.gain = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(_stat_dtype(x))
        mean, std = cumulative_stats(xf, self.eps)
        y = (xf - mean) / std
        return (y * self.gain.reshape(-1) + self.bias.reshape(-1)).to(x.dtype)


class CumulativeLayerNorm2d(_CumulativeLayerNorm):
    """On (B, T, F, C): statistics over (F, C); gain, bias (1, C, 1, 1)."""

    trailing = 2


class CumulativeLayerNorm1d(_CumulativeLayerNorm):
    """On (B, T, C): statistics over C; gain, bias (1, C, 1)."""

    trailing = 1


class OnePassLayerNorm(nn.Module):
    """flax's nn.LayerNorm over the last axis as DeepXi uses it (eps 1e-6,
    the scale and the bias each optional), formula for formula: the
    one-pass variance max(0, E[x^2] - E[x]^2) (flax's default
    use_fast_variance), then (x - mean) * (rsqrt(var + eps) * weight) +
    bias. Statistics in fp32 at least. `weight` and `bias` (C,) where
    present."""

    eps = 1e-6

    def __init__(self, ch: int, scale: bool = True, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch)) if scale else None
        self.bias = nn.Parameter(torch.zeros(ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(_stat_dtype(x))
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp(xf.square().mean(-1, keepdim=True)
                          - mean.square(), min=0.0)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (xf - mean) * mul
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


class _DeepXiNorm(nn.Module):
    """The affine of DeepXi's own norms (ref normalisation.py): `gamma`
    and `beta` (F,) where `scale` and `centre` ask for them; eps 1e-12
    inside the rsqrt."""

    def __init__(self, features: int, centre: bool = True,
                 scale: bool = True):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(features)) if scale else None
        self.beta = nn.Parameter(torch.zeros(features)) if centre else None

    def _affine(self, y: torch.Tensor) -> torch.Tensor:
        if self.gamma is not None:
            y = y * self.gamma
        if self.beta is not None:
            y = y + self.beta
        return y


def _frame_mask(x: torch.Tensor, seq_len: torch.Tensor) -> torch.Tensor:
    """(B, T, 1): 1 on frames t < seq_len, 0 on the padded tail."""
    t = torch.arange(x.shape[1], device=x.device)
    return (t[None, :] < seq_len.to(x.device)[:, None]).to(x.dtype)[..., None]


class SeqCausalLayerNorm(_DeepXiNorm):
    """DeepXi's sequence-causal layer norm on (B, T, F) (se_tpu's
    SeqCausalLayerNorm, ref normalisation.py:37-66): mu_t = cumsum_t(sum_f
    x) / (t F) and sigma_t = cumsum_t(sum_f (x_u - mu_u)^2) / (t F), each
    frame's deviation taken against its own running mean before the sum
    (the reference's quirk, :57-59); the output zeroed past seq_len."""

    def forward(self, x: torch.Tensor, seq_len: torch.Tensor) -> torch.Tensor:
        xf = x.to(_stat_dtype(x))
        t, f = x.shape[1], x.shape[2]
        den = (torch.arange(1, t + 1, dtype=xf.dtype, device=x.device)
               * f)[None, :, None]
        mu = torch.cumsum(xf.sum(-1), -1)[..., None] / den
        sigma = torch.cumsum((xf - mu).square().sum(-1), -1)[..., None] / den
        y = self._affine((xf - mu) * torch.rsqrt(sigma + 1e-12))
        return (y * _frame_mask(xf, seq_len)).to(x.dtype)


class SeqLayerNorm(_DeepXiNorm):
    """DeepXi's whole-sequence masked layer norm (ref
    normalisation.py:131-149): one mean and variance an utterance over its
    valid (time, feature) entries; the output zeroed past seq_len."""

    def forward(self, x: torch.Tensor, seq_len: torch.Tensor) -> torch.Tensor:
        xf = x.to(_stat_dtype(x))
        mask = _frame_mask(xf, seq_len)
        den = mask.sum(1, keepdim=True) * x.shape[2]
        mean = (xf * mask).sum((1, 2), keepdim=True) / den
        var = ((xf - mean).square() * mask).sum((1, 2), keepdim=True) / den
        y = self._affine((xf - mean) * torch.rsqrt(var + 1e-12))
        return (y * mask).to(x.dtype)


class FrameLayerNorm(_DeepXiNorm):
    """DeepXi's frame-wise layer norm (ref normalisation.py:69-98):
    statistics a frame over the features, the variance two-pass."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(_stat_dtype(x))
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        return self._affine((xf - mu) * torch.rsqrt(var + 1e-12)).to(x.dtype)


def deepxi_normalisation(norm_type: str, features: int,
                         **kwargs) -> nn.Module:
    """The reference's `Normalisation` dispatcher (ref
    normalisation.py:15-34)."""
    table = {"SeqCausalLayerNorm": SeqCausalLayerNorm,
             "SeqLayerNorm": SeqLayerNorm,
             "FrameLayerNorm": FrameLayerNorm}
    if norm_type == "unnormalised":
        raise ValueError("'unnormalised' needs no module; apply identity")
    if norm_type not in table:
        raise ValueError(f"Normalisation type does not exist: {norm_type}.")
    return table[norm_type](features, **kwargs)
