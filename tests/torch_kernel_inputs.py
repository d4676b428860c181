"""Seeded numpy inputs for the kernel tests of se_tpu_torch, shared by
test_torch_kernels.py (twins against JAX, on the CPU) and
test_torch_cuda.py (CUDA kernels against twins, on the card). Imports no
JAX, so the CUDA tests run where JAX is not installed."""

import numpy as np
import torch

# att_flip_slack: the tests' slack, the package's own
from se_tpu_torch.ops._dtype import (  # noqa: F401
    BF16_FLOOR, FLIP_SHARE, att_flip_slack, bf16_compare,
)


def rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def to_torch(arrs, device="cpu"):
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in arrs)


def close(got, want, atol):
    for g, w in zip(got, want):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else w
        np.testing.assert_allclose(g, np.asarray(w), atol=atol)


def to_bf16(arrs, device="cpu"):
    """numpy fp32 arrays -> bf16 tensors (rounded to nearest even)."""
    return tuple(t.to(torch.bfloat16) for t in to_torch(arrs, device))


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x, np.float32))


def bf16_close(got, want, slack=None, floor: float = BF16_FLOOR) -> float:
    """Assert the bf16 kernels' tolerance (se_tpu_torch.ops._dtype
    `bf16_compare`: |got - want| <= 2^-7 |want| + floor max|want|
    elementwise, floor 1e-6 unless given; with `slack`, one per pair from att_flip_slack, at most
    FLIP_SHARE of the elements past that by up to their slack) on tensors
    or numpy arrays. Return the share of elements that differ at all."""
    check = bf16_compare([_tensor(g) for g in got],
                         [_tensor(w) for w in want], slack, floor)
    assert check.ok, (
        f"{check.n_past} elements ({check.share_past:.3g}) past the bf16 "
        f"tolerance{' (flip slack on <= %g)' % FLIP_SHARE if slack else ''}"
        f"; max abs error {check.max_abs_err}")
    return check.share_differing


def att_inputs(rng, n, h, l):
    """q, k, v (N, H, L, 16)."""
    return tuple(rand(rng, n, h, l, 16, scale=0.5) for _ in range(3))


def dsconv_params(rng, cin, cm, ncomp):
    """The 13-tuple of dsconv_block for Cin channels, Cm per component."""
    tot = ncomp * cm
    return (rand(rng, 1, cin, scale=0.2, shift=1.0), rand(rng, 1, cin, scale=0.2),
            rand(rng, cin, tot, scale=cin ** -0.5),
            rand(rng, 1, tot, scale=0.2), np.full((1, 1), 0.25, np.float32),
            rand(rng, 9 * tot, tot, scale=(9 * tot) ** -0.5),
            rand(rng, 1, tot, scale=0.2),
            rand(rng, 9 * tot, tot, scale=(9 * tot) ** -0.5),
            rand(rng, 1, tot, scale=0.2),
            rand(rng, 1, tot, scale=0.2, shift=1.0),
            rand(rng, 1, tot, scale=0.2),
            rand(rng, tot, cin, scale=tot ** -0.5), rand(rng, 1, cin, scale=0.2))


def pair_inputs(rng, b, t, f, c, cm):
    """One conformer stage: xc (B, T, F, 2C) = [re | im], xm (B, T, F, C)
    and the complex and real blocks' 13-tuples, Cm per component."""
    return (rand(rng, b, t, f, 2 * c, scale=0.5),
            rand(rng, b, t, f, c, scale=0.5),
            dsconv_params(rng, 2 * c, cm, 2), dsconv_params(rng, c, cm, 1))


def enc_params(rng, cin, cout):
    """The 10-tuple of encoder_level."""
    out = []
    for cb_in, cb_out in ((2 * cin, 2 * cout), (cin, cout)):
        out += [rand(rng, 2, 5, cb_in, cb_out, scale=(10 * cb_in) ** -0.5),
                rand(rng, 1, cb_out, scale=0.1),
                rand(rng, 1, cb_out, scale=0.1, shift=1.0),
                rand(rng, 1, cb_out, scale=0.1),
                np.full((1, 1), 0.2, np.float32)]
    return tuple(out)


def dec_params(rng, cc, cout):
    """The 12-tuple of decoder_level for a per-component concat width cc."""
    out = []
    for cb_in, cb_out in ((2 * cc, 2 * cout), (cc, cout)):
        s = (10 * cb_in) ** -0.5
        out += [rand(rng, 6, cb_in, cb_out, scale=s),
                rand(rng, 4, cb_in, cb_out, scale=s),
                rand(rng, 1, cb_out, scale=0.1),
                rand(rng, 1, cb_out, scale=0.1, shift=1.0),
                rand(rng, 1, cb_out, scale=0.1),
                np.full((1, 1), 0.2, np.float32)]
    return tuple(out)


def lstm_inputs(rng, bf, t, in_dim, h):
    """x (Bf, T, In), wx (In, 4H), wh (H, 4H), b (4H,) as se_tpu's tests
    draw them."""
    return (rand(rng, bf, t, in_dim), rand(rng, in_dim, 4 * h, scale=0.2),
            rand(rng, h, 4 * h, scale=0.2), rand(rng, 4 * h, scale=0.1))


def fill_tree(shapes, seed: int) -> dict:
    """Numpy values for a nest of dicts of shaped leaves (se_tpu's
    `jax.eval_shape(model.init, ...)`), drawn from `seed` by leaf name:
    LSTM weights and biases U(+-1/sqrt(H)), kernels U(+-1/sqrt(fan_in)),
    biases U(+-0.1), BN/LN/IN scales and the cumulative norms' gains 1 +
    0.1 N, PReLU slopes (flax's `negative_slope`, se_tpu's own PReLU's
    `weight`; ShareSepConv's kernel, also named `weight`) 0.25 + 0.05 N, BN
    running means 0.1 N and variances 0.5 + U(0, 1): every statistic and
    affine off its default."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name.endswith(("_wx", "_wh", "_b")):
            h = shape[-1] // 4
            arr = rng.uniform(-h ** -0.5, h ** -0.5, shape)
        elif name == "kernel":
            fan = int(np.prod(shape[:-1]))
            arr = rng.uniform(-fan ** -0.5, fan ** -0.5, shape)
        elif name == "bias":
            arr = rng.uniform(-0.1, 0.1, shape)
        elif name in ("scale", "gain"):
            arr = 1 + 0.1 * rng.standard_normal(shape)
        elif name in ("negative_slope", "weight"):  # PReLU slopes
            arr = 0.25 + 0.05 * rng.standard_normal(shape)
        elif name == "mean":
            arr = 0.1 * rng.standard_normal(shape)
        elif name == "var":
            arr = 0.5 + rng.uniform(0, 1, shape)
        else:
            raise KeyError(name)
        return np.asarray(arr, np.float32)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, tuple(v.shape))
                for k, v in sorted(node.items())}

    return walk(shapes)
