"""se_tpu_torch's bf16 training (`TrainConfig(compute_dtype="bf16")`)
against se_tpu's `make_train_step(compute_dtype="bf16")` on the CPU: the
six LSTM families at tests/test_torch_train.py's widths and batch (B = 2,
16 frames). Uformer and the TCM families: test_torch_bf16_train_conv.py
and test_torch_bf16_train_tcm.py, which share these helpers.

- One bf16 step of each family from the same weights (`fill_tree`, every
  BN statistic off its default) on the same batch, on both sides, and
  se_tpu's fp32 step: the loss, every gradient and every BN statistic
  after the step held by `ops._dtype.bf16_step_compare`. Each tensor's
  distance from se_tpu's fp32 step within twice se_tpu's bf16 step's own
  plus a floor: for a gradient one bf16 ulp of the step's largest
  gradient, capped at a quarter of the tensor's own largest value (the
  cap lifted for a scalar and for a tensor se_tpu's bf16 step does not
  resolve: cancelling sums); 1e-6 of the tensor's scale for the loss and
  a statistic. At most 1% of the tensors within four times it (G2Net's
  bf16 step is far from fp32 everywhere); pooled over the step, the
  port's gradient distance within twice se_tpu's, both above 1e-3 of the
  gradients (bf16 in effect on both sides: a step that left a layer in
  fp32 would not show it in LSTMNet's loss, which bf16 moves by ~2e-5
  only). se_tpu's step keeps its gradients by test_torch_train's
  `_KeepGrads`.
- The rule fails DPCRN's bf16 step with one small gradient tensor (under
  the step's floor, resolved by se_tpu's bf16 step) zeroed, negated or
  NaN, and refuses a reference step that holds a NaN.
- One whole bf16 step with Adam of each family: the master weights, their
  gradients, Adam's moments and the BN statistics stay fp32, every weight
  with a non-zero gradient moves, the loss is finite.
- What the card's path relies on: no train forward of these families
  passes an LSTM carry (the card's LSTM returns (h_T, c_T) without a
  gradient, se_tpu's scan differentiates both); `_prep` takes the fp32
  waveforms under no_grad, before the cast (the STFT kernel refuses bf16
  and grad); the LSTM layer's autograd Function (its twin standing in for
  the kernel, as on the card) hands back each input's gradient in its
  dtype, equal to the twin's own autograd.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from se_tpu.train import trainer as jtrainer
from se_tpu_torch.models import get_model
from se_tpu_torch.nn import Dropout, recurrent
from se_tpu_torch.ops import lstm
from se_tpu_torch.ops._dtype import (
    LSTM_FLOOR, STEP_FLOOR, bf16_step_compare,
)
from se_tpu_torch.train import trainer
from se_tpu_torch.train.trainer import TrainConfig, make_train_step
from torch_kernel_inputs import bf16_close
from test_torch_train import (
    FAMILIES, _KeepGrads, _batch, _jax_variables, _torch_batch,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: torch's intra-op threads would only contend with the
    other test workers' processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_step(monkeypatch, name: str, kw: dict, variables: dict, batch,
             dtype: str) -> dict:
    """se_tpu's train step in `dtype` ("fp32" or "bf16") with its dropout
    off: {"loss", the gradients and the BN statistics after the step} by
    the port's names, as numpy."""
    monkeypatch.setattr(jtrainer, "optax", _KeepGrads)
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    _, _, step_fn, _ = jtrainer.make_train_step(jtrainer.TrainConfig(
        model=name, model_kwargs=kw, compute_dtype=dtype))
    params = jax.tree.map(jnp.asarray, variables["params"])
    extra = {k: jax.tree.map(jnp.asarray, v) for k, v in variables.items()
             if k != "params"}
    state = {"params": params, "extra_vars": extra,
             "opt_state": jax.tree.map(jnp.zeros_like, params),
             "step": jnp.zeros((), jnp.int32), "lr_scale": jnp.ones(()),
             "rng": jax.random.PRNGKey(0)}
    mix, clean, frames = batch
    new, loss = step_fn(state, {"mix": jnp.asarray(mix),
                                "clean": jnp.asarray(clean),
                                "frames": jnp.asarray(frames)})
    tree = {"params": jax.tree.map(np.asarray, new["opt_state"])}
    if "batch_stats" in new["extra_vars"]:
        tree["batch_stats"] = jax.tree.map(
            np.asarray, new["extra_vars"]["batch_stats"])
    out = {k: v.numpy() for k, v in
           get_model(name).from_jax_variables(tree).items()
           if not k.startswith("bias_hh") and ".bias_hh" not in k}
    out["loss"] = np.float64(loss)
    return out


def port_step(name: str, kw: dict, variables: dict, batch,
              dtype: str = "bf16"):
    """The port's train step in `dtype` from `variables`, dropout off:
    (model, state, {"loss", the gradients and the BN statistics after the
    step})."""
    model, init_fn, step_fn, _ = make_train_step(
        TrainConfig(model=name, model_kwargs=kw, compute_dtype=dtype),
        device="cpu")
    state = init_fn(0)
    model.load_state_dict(get_model(name).from_jax_variables(variables))
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    state, loss = step_fn(state, _torch_batch(*batch))
    out = {k: p.grad for k, p in model.named_parameters()}
    out.update((k, b) for k, b in model.named_buffers() if "running" in k)
    out["loss"] = loss
    return model, state, out


@functools.lru_cache(maxsize=None)
def bf16_steps(name: str, seed: int) -> tuple:
    """(the port's bf16 step, se_tpu's bf16 step, se_tpu's fp32 step) of
    `name` from `_jax_variables(name, FAMILIES' kw, seed)` on `_batch()`,
    each as `port_step` / `jax_step` give it; made once a process (the
    rule's test and the planted faults share them)."""
    kw = FAMILIES.get(name, {})
    variables = _jax_variables(name, kw, seed)
    batch = _batch()
    with pytest.MonkeyPatch.context() as mp:
        ref32 = jax_step(mp, name, kw, variables, batch, "fp32")
        ref16 = jax_step(mp, name, kw, variables, batch, "bf16")
    _, _, got = port_step(name, kw, variables, batch)
    return got, ref16, ref32


def check_bf16_step(name: str, seed: int) -> None:
    """The port's bf16 step against se_tpu's bf16 and fp32 steps
    (`bf16_step_compare`)."""
    check = bf16_step_compare(*bf16_steps(name, seed))
    assert check.ok, (check.failures[:8], check.pooled_got,
                      check.pooled_ref)


def check_planted_fault(name: str, seed: int, fault: str) -> None:
    """`bf16_step_compare` fails the port's bf16 step with one small
    gradient tensor zeroed, negated or NaN (`fault`): the smallest of
    those under the step's floor (STEP_FLOOR x its largest |gradient|,
    where a floor the same for every tensor let any value pass) that
    se_tpu's bf16 step resolves to a tenth of their own scale, more than
    one entry."""
    got, ref16, ref32 = bf16_steps(name, seed)
    grads = {k: np.asarray(v, np.float64) for k, v in ref32.items()
             if k != "loss" and "running" not in k}
    gmax = max(float(np.abs(v).max()) for v in grads.values())
    small = [(float(np.abs(v).max()), k) for k, v in grads.items()
             if v.size > 1 and np.abs(v).max() < STEP_FLOOR * gmax
             and np.abs(ref16[k] - v).max() < 0.1 * np.abs(v).max()]
    assert small, "no small resolved gradient to plant a fault in"
    _, k = min(small)
    planted = dict(got)
    planted[k] = {"zero": torch.zeros_like, "negate": torch.neg,
                  "nan": lambda t: torch.full_like(t, float("nan"))
                  }[fault](got[k])
    check = bf16_step_compare(planted, ref16, ref32)
    assert not check.ok and k in [f[0] for f in check.failures], k


def check_masters_stay_fp32(name: str, kw: dict) -> None:
    """One bf16 step with Adam: masters, gradients, Adam's moments and
    buffers fp32; each weight with a non-zero gradient moved (a bias
    before BN may get an exact bf16 zero); the loss finite."""
    model, init_fn, step_fn, _ = make_train_step(
        TrainConfig(model=name, model_kwargs=kw, compute_dtype="bf16"),
        device="cpu")
    state = init_fn(1)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state, loss = step_fn(state, _torch_batch(*_batch()))
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, k
        assert state["opt_state"]["mu"][k].dtype == torch.float32, k
        assert state["opt_state"]["nu"][k].dtype == torch.float32, k
    for k, b in model.named_buffers():
        assert b.dtype == torch.float32, k
    still = [k for k, p in model.named_parameters()
             if torch.equal(p, before[k]) and bool(p.grad.any())]
    assert not still, still
    assert state["opt_state"]["count"] == 1 and state["step"] == 1


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_bf16_train_step_tracks_se_tpu(name):
    check_bf16_step(name, seed=3)


@pytest.mark.parametrize("fault", ["zero", "negate", "nan"])
def test_bf16_rule_fails_a_planted_fault(fault):
    check_planted_fault("dpcrn", 3, fault)


def test_bf16_rule_refuses_a_non_finite_reference():
    """A NaN in either reference step (se_tpu's com_mag_mse has a NaN
    gradient at an exactly zero estimate bin) is no reference: the rule
    raises, it does not pass or fail the checked step on it."""
    got, ref16, ref32 = bf16_steps("dpcrn", 3)
    k = next(k for k in ref32 if k != "loss" and "running" not in k)
    for which in (0, 1):
        refs = [dict(ref16), dict(ref32)]
        refs[which][k] = np.full_like(refs[which][k], np.nan)
        with pytest.raises(ValueError, match="non-finite"):
            bf16_step_compare(got, *refs)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_bf16_step_keeps_fp32_masters(name):
    check_masters_stay_fp32(name, FAMILIES[name])


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_train_forwards_pass_no_lstm_carry(monkeypatch, name):
    """Every LSTM layer call of an fp32 and a bf16 train step starts from
    zeros (h0, c0 None)."""
    calls = []
    real = recurrent.lstm_layer_kernel

    def spy(x, wx, wh, b, reverse=False, h0=None, c0=None):
        calls.append((h0, c0))
        return real(x, wx, wh, b, reverse, h0, c0)

    monkeypatch.setattr(recurrent, "lstm_layer_kernel", spy)
    for dtype in ("fp32", "bf16"):
        _, init_fn, step_fn, _ = make_train_step(
            TrainConfig(model=name, model_kwargs=FAMILIES[name],
                        compute_dtype=dtype), device="cpu")
        step_fn(init_fn(0), _torch_batch(*_batch()))
    assert calls and all(h0 is None and c0 is None for h0, c0 in calls)


def test_prep_takes_fp32_waveforms_without_grad(monkeypatch):
    """A bf16 step's two STFTs (mix, clean) see fp32 waveforms that do not
    require grad, with grad mode off."""
    seen = []
    real = trainer.stft_auto

    def spy(x, cfg):
        seen.append((x.dtype, x.requires_grad, torch.is_grad_enabled()))
        return real(x, cfg)

    monkeypatch.setattr(trainer, "stft_auto", spy)
    _, init_fn, step_fn, _ = make_train_step(
        TrainConfig(model="dpcrn", compute_dtype="bf16"), device="cpu")
    step_fn(init_fn(0), _torch_batch(*_batch()))
    assert seen == [(torch.float32, False, False)] * 2


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_lstm_function_grads_keep_each_inputs_dtype(x_dtype):
    """The layer's Function (`lstm._layer_call`) with the twin standing in
    for the kernel, bf16 weights, over 40 frames (two backward chunks):
    each input's gradient in its dtype (so a bf16 cast's backward hands
    its fp32 master an fp32 gradient) and within bf16_close (LSTM_FLOOR)
    of the twin's own autograd."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(3, 40, 8, generator=gen).to(x_dtype)
    weights = [(torch.rand(*shape, generator=gen) - 0.5).to(torch.bfloat16)
               for shape in ((8, 48), (12, 48), (48,))]
    up = torch.randn(3, 40, 12, generator=gen)
    got, want = [], []
    for fn, out in ((lambda *a: lstm._layer_call(lstm._reference, *a,
                                                 False, None, None), got),
                    (lstm._reference, want)):
        leaves = [t.clone().requires_grad_() for t in (x, *weights)]
        ys, _ = fn(*leaves)
        assert ys.dtype == torch.float32
        out.extend(torch.autograd.grad(ys, leaves, up))
        assert [g.dtype for g in out] == [t.dtype for t in leaves]
    bf16_close(got, want, floor=LSTM_FLOOR)
