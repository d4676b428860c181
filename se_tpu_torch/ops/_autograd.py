"""Gradients through the hand-written kernels: the port's counterpart of
se_tpu's custom VJPs (`pallas_attention.py:68-84`, `pallas_lstm.py:169-195`,
`pallas_encoder.py:138-151`, `pallas_decoder.py:160-175`,
`pallas_dsconv.py:235-249` and `:360-375`).

No TPU kernel has a backward of its own: each `bwd` there is `jax.vjp` of
the kernel's plain reference, recomputed. `kernel_call` does the same with
a `torch.autograd.Function`: its forward launches the kernel (counted in
`_build.LAUNCHES` as any launch) and saves the differentiable inputs; its
backward re-runs the plain twin on detached copies under
`torch.enable_grad()` and returns `torch.autograd.grad` of that. What the
kernel and the twin close over (packed weights, dilations, designs,
`has_bn`, the attention scale) is no input of the Function and gets no
gradient: packs are constants to it, so build them under `torch.no_grad()`.
The Function's forward is the span `autograd.kernel`, the twin's
recompute and VJP in its backward the span `autograd.twin`
(utils/profiling.py); a call without grad records neither.
"""

from __future__ import annotations

from typing import Callable

import torch

from se_tpu_torch.utils.profiling import span

_SLOT = object()  # where a tensor stood in a nest


def _flatten(nest) -> list:
    """The tensors of a nest of tuples and lists, depth first."""
    if isinstance(nest, (tuple, list)):
        return [t for item in nest for t in _flatten(item)]
    return [nest] if isinstance(nest, torch.Tensor) else []


def _skeleton(nest):
    """`nest` with each tensor replaced by `_SLOT`."""
    if isinstance(nest, (tuple, list)):
        return type(nest)(_skeleton(item) for item in nest)
    return _SLOT if isinstance(nest, torch.Tensor) else nest


def _fill(skeleton, tensors):
    """`skeleton` with each `_SLOT` replaced by the next of `tensors`."""
    if isinstance(skeleton, (tuple, list)):
        return type(skeleton)(_fill(item, tensors) for item in skeleton)
    return next(tensors) if skeleton is _SLOT else skeleton


class _Spec:
    """What the Function closes over: the kernel, the twin, the inputs'
    skeleton, the flat indices of the outputs without gradient, and, once
    the forward ran, the outputs' skeleton."""

    def __init__(self, kernel, twin, inputs, no_grad_outputs):
        self.kernel, self.twin = kernel, twin
        self.inputs = _skeleton(inputs)
        self.no_grad_outputs = tuple(no_grad_outputs)
        self.outputs = None


class _KernelFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, *tensors):
        with span("autograd.kernel"):
            out = spec.kernel(*_fill(spec.inputs, iter(tensors)))
        spec.outputs = _skeleton(out)
        flat = _flatten(out)
        ctx.spec = spec
        ctx.save_for_backward(*tensors)
        ctx.mark_non_differentiable(*(flat[i] for i in spec.no_grad_outputs))
        return tuple(flat)

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        needs = ctx.needs_input_grad[1:]
        leaves = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, needs)]
        with span("autograd.twin"):
            with torch.enable_grad():
                outs = _flatten(spec.twin(*_fill(spec.inputs,
                                                 iter(leaves))))
            pairs = [(o, g) for i, (o, g) in enumerate(zip(outs, grads))
                     if i not in spec.no_grad_outputs and o.requires_grad]
            wanted = [t for t, n in zip(leaves, needs) if n]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                           [g for _, g in pairs],
                                           allow_unused=True))
        return (None, *(next(got) if n else None for n in needs))


def kernel_call(kernel: Callable, twin: Callable, *inputs,
                no_grad_outputs: tuple[int, ...] = ()):
    """`kernel(*inputs)`, differentiable in every tensor of `inputs` (a
    nest of tuples of tensors and other values) by the VJP of
    `twin(*inputs)`, recomputed in the backward. `kernel` and `twin` return
    the same nest of tensors; the tensors at `no_grad_outputs` (indices
    into that nest, flattened) carry no gradient. Without a tensor that
    requires grad under grad mode, `kernel(*inputs)` is returned as it is.
    """
    flat = _flatten(inputs)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in flat)):
        return kernel(*inputs)
    spec = _Spec(kernel, twin, inputs, no_grad_outputs)
    outs = _KernelFunction.apply(spec, *flat)
    return _fill(spec.outputs, iter(outs))
