"""Seeded numpy inputs for the kernel tests of se_tpu_torch, shared by
test_torch_kernels.py (twins against JAX, on the CPU) and
test_torch_cuda.py (CUDA kernels against twins, on the card). Imports no
JAX, so the CUDA tests run where JAX is not installed."""

import numpy as np
import torch


def rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def to_torch(arrs, device="cpu"):
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in arrs)


def close(got, want, atol):
    for g, w in zip(got, want):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else w
        np.testing.assert_allclose(g, np.asarray(w), atol=atol)


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
