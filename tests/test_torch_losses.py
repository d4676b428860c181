"""se_tpu_torch.train.losses against se_tpu.train.losses on the CPU: every
loss's value and its gradient in the estimate (jax.grad against
torch.autograd), on the same inputs made from a numpy seed.

Tolerances: the value within 1e-5 relative; each gradient within 1e-5 *
max|grad| of that gradient (absolute). Both sides run the same fp32 math
with sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se_tpu.train import losses as J
from se_tpu_torch.train import losses as P

B, T, F, N, HOP = 3, 20, 33, 2048, 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are small: torch's intra-op threads would only contend
    with the other test workers' processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames():
    return np.array([T, T - 5, 7], np.int32)


def _spec(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _wave(rng):
    return (rng.standard_normal((B, N)) * 0.3).astype(np.float32)


# name -> (inputs from a rng: (differentiable arrays, constant arguments),
# se_tpu's function, the port's function): f(*diff, *const)
CASES = {
    "mag_mse": (lambda r: ([np.abs(_spec(r, B, T, F))],
                           [np.abs(_spec(r, B, T, F)), _frames()]),
                J.mag_mse_loss, P.mag_mse_loss),
    "com_mse": (lambda r: ([_spec(r, B, T, F, 2)],
                           [_spec(r, B, T, F, 2), _frames()]),
                J.com_mse_loss, P.com_mse_loss),
    "com_mag_mse": (lambda r: ([_spec(r, B, T, F, 2)],
                               [_spec(r, B, T, F, 2), _frames()]),
                    J.com_mag_mse_loss, P.com_mag_mse_loss),
    "mse_com_mag_mse": (
        lambda r: ([np.abs(_spec(r, B, T, F)), _spec(r, B, T, F, 2)],
                   [np.abs(_spec(r, B, T, F)), _spec(r, B, T, F, 2),
                    _frames()]),
        lambda em, e, lm, l, fr: J.mse_com_mag_mse_loss(em, e, lm, l, fr,
                                                        alpha=0.3),
        lambda em, e, lm, l, fr: P.mse_com_mag_mse_loss(em, e, lm, l, fr,
                                                        alpha=0.3)),
    "stagewise_com_mag_mse": (
        lambda r: ([_spec(r, B, T, F, 2), _spec(r, B, T, F, 2)],
                   [_spec(r, B, T, F, 2), _frames()]),
        lambda e1, e2, l, fr: J.stagewise_com_mag_mse_loss([e1, e2], l, fr),
        lambda e1, e2, l, fr: P.stagewise_com_mag_mse_loss([e1, e2], l, fr)),
    "sisdr": (lambda r: ([_wave(r)], [_wave(r), _frames()]),
              lambda e, l, fr: J.sisdr_loss(e, l, fr, HOP),
              lambda e, l, fr: P.sisdr_loss(e, l, fr, HOP)),
    "sisdr_eps_2e-7": (lambda r: ([_wave(r)], [_wave(r), _frames()]),
                       lambda e, l, fr: J.sisdr_loss(e, l, fr, HOP, 2e-7),
                       lambda e, l, fr: P.sisdr_loss(e, l, fr, HOP, 2e-7)),
    "snr": (lambda r: ([_wave(r)], [_wave(r), _frames()]),
            lambda e, l, fr: J.snr_loss(e, l, fr, HOP),
            lambda e, l, fr: P.snr_loss(e, l, fr, HOP)),
    "fusion_snr": (lambda r: ([_wave(r)], [_wave(r), np.array(
                       [N, N - 300, 1000], np.int32)]),
                   J.fusion_snr_loss, P.fusion_snr_loss),
    "stftm": (lambda r: ([_wave(r)], [_wave(r)]),
              lambda e, l: J.StftmLoss()(e, l),
              lambda e, l: P.StftmLoss()(e, l)),
    "uformer_sisnr": (lambda r: ([_wave(r)], [_wave(r)]),
                      J.uformer_sisnr_loss, P.uformer_sisnr_loss),
    # utterance 1's source is silent: skipped in the value (se_tpu
    # losses.py:155-156); its gradient is NaN on both sides (sqrt at 0)
    "uformer_sisnr_zero_source": (
        lambda r: ([_wave(r)], [_wave(r) * np.array([[1.0], [0.0], [1.0]],
                                                    np.float32)]),
        J.uformer_sisnr_loss, P.uformer_sisnr_loss),
    "uformer_cplx_mse": (lambda r: ([_spec(r, B, T, F, 2)],
                                    [_spec(r, B, T, F, 2)]),
                         J.uformer_cplx_mse_loss, P.uformer_cplx_mse_loss),
    "uformer_mag_mse": (lambda r: ([_spec(r, B, T, F, 2)],
                                   [_spec(r, B, T, F, 2)]),
                        J.uformer_mag_mse_loss, P.uformer_mag_mse_loss),
    "uformer_cplx_mse_subband": (
        lambda r: ([_spec(r, B, T, F, 2)], [_spec(r, B, T, F, 2)]),
        J.uformer_cplx_mse_subband_loss, P.uformer_cplx_mse_subband_loss),
    # divides by T, not F' (se_tpu losses.py:201-205)
    "uformer_mag_mse_subband": (
        lambda r: ([_spec(r, B, T, F, 2)], [_spec(r, B, T, F, 2)]),
        J.uformer_mag_mse_subband_loss, P.uformer_mag_mse_subband_loss),
    "uformer_time_mae": (lambda r: ([_wave(r)], [_wave(r)]),
                         J.uformer_time_mae_loss, P.uformer_time_mae_loss),
    "uformer_bce": (
        lambda r: ([r.uniform(0.0, 1.0, (B, T, F)).astype(np.float32)],
                   [(r.uniform(0, 1, (B, T, F)) > 0.5).astype(np.float32)]),
        J.uformer_bce_loss, P.uformer_bce_loss),
}


def _to_torch(a):
    t = torch.from_numpy(np.array(a))
    return t.long() if t.dtype == torch.int32 else t


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradient_match_jax(name):
    make, jfn, pfn = CASES[name]
    diff, const = make(np.random.default_rng(sorted(CASES).index(name)))
    want, jgrads = jax.value_and_grad(
        lambda *d: jfn(*d, *map(jnp.asarray, const)),
        argnums=tuple(range(len(diff))))(*map(jnp.asarray, diff))
    xs = [torch.from_numpy(d).requires_grad_() for d in diff]
    got = pfn(*xs, *map(_to_torch, const))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for x, jg in zip(xs, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0,
                                   atol=1e-5 * np.nanmax(np.abs(jg)))


def test_uformer_accuracy_matches_jax():
    rng = np.random.default_rng(5)
    out = rng.uniform(0, 1, (B, T, F)).astype(np.float32)
    tgt = (rng.uniform(0, 1, (B, T, F)) > 0.5).astype(np.float32)
    want = float(J.uformer_accuracy(jnp.asarray(out), jnp.asarray(tgt)))
    got = float(P.uformer_accuracy(torch.from_numpy(out),
                                   torch.from_numpy(tgt)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_masks_match_jax():
    frames = _frames()
    np.testing.assert_array_equal(
        P.frame_mask(_to_torch(frames), T).numpy(),
        np.asarray(J.frame_mask(jnp.asarray(frames), T)))
    np.testing.assert_array_equal(
        P.sample_mask_from_frames(_to_torch(frames), N, HOP).numpy(),
        np.asarray(J.sample_mask_from_frames(jnp.asarray(frames), N, HOP)))


def test_com_mag_mse_gradient_is_finite_at_a_zero_estimate_bin():
    """An estimate bin with both components exactly 0: se_tpu's magnitude
    gradient there is 0 / 0 = NaN (in a train step it spreads to every
    weight); the port's is 0 (`magnitude`), so that bin takes the RI-MSE
    half's gradient alone, and every other bin se_tpu's."""
    rng = np.random.default_rng(9)
    esti, label = _spec(rng, B, T, F, 2), _spec(rng, B, T, F, 2)
    esti[1, 3, 4] = 0.0
    frames = _frames()
    jg = np.asarray(jax.grad(lambda e: J.com_mag_mse_loss(
        e, jnp.asarray(label), jnp.asarray(frames)))(jnp.asarray(esti)))
    assert np.isnan(jg[1, 3, 4]).all()
    x = torch.from_numpy(esti).requires_grad_()
    P.com_mag_mse_loss(x, torch.from_numpy(label),
                       _to_torch(frames)).backward()
    g = x.grad.numpy()
    assert np.isfinite(g).all()
    keep = np.ones(g.shape[:-1], bool)
    keep[1, 3, 4] = False
    np.testing.assert_allclose(g[keep], jg[keep], rtol=0,
                               atol=1e-5 * np.abs(jg[keep]).max())
    ri_half = 0.5 * (0.0 - label[1, 3, 4]) / (frames.sum() * F)
    np.testing.assert_allclose(g[1, 3, 4], ri_half, rtol=1e-6)
