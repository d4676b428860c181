"""se_tpu_torch's training against se_tpu's on the CPU.

- One train step of each ported family against se_tpu's `make_train_step`
  from the same weights (drawn by `fill_tree` from a numpy seed, every BN
  statistic off its default, carried in by `from_jax_variables`) on the
  same batch: the loss, every gradient and the new BN running
  statistics. se_tpu's step keeps its gradients: optax is replaced, in its
  trainer module only, by a chain that returns zero updates and keeps the
  gradients as its state; the port's step leaves them in the parameters'
  `.grad`. JAX's gradient tree maps through `from_jax_variables` (a
  combined LSTM bias becomes `bias_ih`; the port's `bias_hh` is a zero
  buffer, as se_tpu keeps one bias).
  DPCRN, CRN and GCRN at their published widths, LSTMNet at hidden 48,
  DCCRN at kernel_num 8-16 / rnn_units 16, FullSubNet at hidden 32 / 24
  with drop_band (B = 2), Uformer at its published widths with dropout
  neutralised on both sides (the port's rates set to 0; flax's
  nn.Dropout.__call__ patched to the identity by monkeypatch), T = 16
  frames. Tolerances: the loss within 1e-5 relative; every gradient
  tensor within 1e-5 * the step's largest |gradient| entry, absolute:
  some gradients are zero in exact arithmetic (a conv bias before BN with
  batch statistics, the attention key biases, which the softmax ignores)
  and hold round-off on both sides, so a per-tensor scale would compare
  noise; the statistics within 1e-5 * max|statistic|.
- One whole step with the real optimiser (Adam after the global-norm clip)
  of the six families above against se_tpu's: every weight and buffer
  after the step within 1e-5 * max|w| of its tensor. A model that trained
  torch's two LSTM biases as two parameters moved their sum twice as far.
- BatchNorm and ComplexBN in train mode against flax's nn.BatchNorm
  through se_tpu's modules (mutable batch_stats): outputs and running
  statistics within 1e-5.
- The optimiser against optax's clip_by_global_norm(5) + scale_by_adam on
  synthetic gradients, below and above the clip norm, three steps.
- remat "full" and "dots" give the "none" step, dropout on.
- Checkpoints round-trip; `train_epochs` on a manifest of wav files writes
  the checkpoints, both pointers and the loss curve, and a restored model
  enhances exactly as the trained one.
"""

import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import se_tpu.models as jmodels
from se_tpu.data.dataset import ManifestDataset as JManifestDataset
from se_tpu.models.uformer import ComplexBN as JComplexBN
from se_tpu.nn import norms as j_norms
from se_tpu.nn import recurrent as j_recurrent
from se_tpu.nn.norms import BatchNorm as JBatchNorm
from se_tpu.train import trainer as jtrainer
from se_tpu_torch.data import ManifestDataset, write_wav
from se_tpu_torch.eval.enhance import enhance_waveform
from se_tpu_torch.models import get_model
from se_tpu_torch.models.uformer import ComplexBN
from se_tpu_torch.nn import BatchNorm, Dropout
from se_tpu_torch.train import trainer
from se_tpu_torch.train.checkpoint import (
    latest_checkpoint, parse_epoch_step, restore_checkpoint, save_checkpoint,
)
from se_tpu_torch.train.trainer import TrainConfig, make_train_step
from torch_kernel_inputs import fill_tree

j_stft = importlib.import_module("se_tpu.ops.stft")  # the package exports
# a function of that name

N_SAMPLES = 2400  # 16 frames at hop 160 (Uformer and the PRESET_320 models)
FAMILIES = {
    "dpcrn": {}, "crn": {}, "gcrn": {}, "lstm": dict(hidden=48),
    "dccrn": dict(kernel_num=(8, 8, 16, 16, 16, 16), rnn_units=16),
    "fullsubnet": dict(fb_hidden=32, sb_hidden=24),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are small: torch's intra-op threads would only contend
    with the other test workers' processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(b: int = 2, n: int = N_SAMPLES, seed: int = 0):
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((b, n)) * 0.1).astype(np.float32)
    mix = clean + (rng.standard_normal((b, n)) * 0.05).astype(np.float32)
    frames = np.array([n // 160 + 1, n // 160 - 3][:b], np.int32)
    return mix, clean, frames


def _torch_batch(mix, clean, frames):
    return {"mix": torch.from_numpy(mix), "clean": torch.from_numpy(clean),
            "frames": torch.from_numpy(frames.astype(np.int64))}


class _KeepGrads:
    """optax as se_tpu's trainer calls it, but its chain returns zero
    updates and keeps the gradients as its state."""

    clip_by_global_norm = staticmethod(lambda max_norm: None)
    scale_by_adam = staticmethod(lambda: None)

    @staticmethod
    def chain(*parts):
        return optax.GradientTransformation(
            lambda params: jax.tree.map(jnp.zeros_like, params),
            lambda g, state, params=None: (
                jax.tree.map(jnp.zeros_like, g), g))


def _jax_variables(name: str, kw: dict, seed: int) -> dict:
    entry = jmodels.get_model(name)
    model = entry.make(**kw)
    bins = get_model(name).stft.bins
    if entry.io_kind == "waveform":
        args = (np.zeros((1, N_SAMPLES), np.float32),) * 2
    elif entry.io_kind in ("mag_mask", "cirm"):
        args = (np.zeros((1, 16, bins), np.float32),)
    else:
        args = (np.zeros((1, 16, bins, 2), np.float32),)
    return fill_tree(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                     *args), seed)


def _jax_step(monkeypatch, name, kw, variables, batch):
    """se_tpu's train step: (loss, gradient tree, new batch_stats)."""
    monkeypatch.setattr(jtrainer, "optax", _KeepGrads)
    _, _, step_fn, _ = jtrainer.make_train_step(
        jtrainer.TrainConfig(model=name, model_kwargs=kw))
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
    stats = new["extra_vars"].get("batch_stats")
    return float(loss), new["opt_state"], stats


def _port_step(name, kw, variables, batch, dropout=True):
    """The port's train step from `variables`: (model, loss, gradients by
    parameter name)."""
    model, init_fn, step_fn, _ = make_train_step(
        TrainConfig(model=name, model_kwargs=kw), device="cpu")
    state = init_fn(0)
    model.load_state_dict(get_model(name).from_jax_variables(variables))
    if not dropout:
        for mod in model.modules():
            if isinstance(mod, Dropout):
                mod.rate = 0.0
    state, loss = step_fn(state, _torch_batch(*batch))
    grads = {k: p.grad for k, p in model.named_parameters()}
    return model, loss.item(), grads


def _compare(name, model, loss, grads, jloss, jgrads, jstats):
    """The loss, `grads` and `model`'s buffers (its BN statistics after the
    step) against se_tpu's."""
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    tree = {"params": jax.tree.map(np.asarray, jgrads)}
    if jstats is not None:
        tree["batch_stats"] = jax.tree.map(np.asarray, jstats)
    want = {k: v.numpy() for k, v in
            get_model(name).from_jax_variables(tree).items()}
    gmax = max(np.abs(v).max() for k, v in want.items()
               if "running" not in k)
    params = dict(model.named_parameters())
    assert grads.keys() == params.keys()
    for key, g in grads.items():
        w = want[key]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * gmax,
                                   err_msg=key)
    for key, buf in model.named_buffers():
        w = want[key]
        np.testing.assert_allclose(buf.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_train_step_matches_se_tpu(monkeypatch, name):
    kw = FAMILIES[name]
    variables = _jax_variables(name, kw, seed=3)
    batch = _batch()
    jloss, jgrads, jstats = _jax_step(monkeypatch, name, kw, variables,
                                      batch)
    model, loss, grads = _port_step(name, kw, variables, batch)
    _compare(name, model, loss, grads, jloss, jgrads, jstats)


class _Fp64Numpy:
    """jax.numpy, but `float32` is float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_adam_step_fp64(monkeypatch, name, kw, variables, batch) -> dict:
    """se_tpu's whole train step with its optimiser, in fp64 throughout
    (jax's x64 mode; `jnp.float32` read as float64 by the modules that ask
    for fp32 whatever their input: the norms, the STFT, the LSTM): the
    variables after it ({"params", "batch_stats"} as numpy)."""
    to64 = functools.partial(jax.tree.map,
                             lambda a: jnp.asarray(a, jnp.float64))
    with monkeypatch.context() as mp, jax.enable_x64(True):
        for module in (j_norms, j_stft, j_recurrent):
            mp.setattr(module, "jnp", _Fp64Numpy())
        _, _, step_fn, _ = jtrainer.make_train_step(
            jtrainer.TrainConfig(model=name, model_kwargs=kw))
        params = to64(variables["params"])
        extra = {k: to64(v) for k, v in variables.items() if k != "params"}
        tx = optax.chain(optax.clip_by_global_norm(5.0),
                         optax.scale_by_adam())
        state = {"params": params, "extra_vars": extra,
                 "opt_state": tx.init(params),
                 "step": jnp.zeros((), jnp.int32),
                 "lr_scale": jnp.ones((), jnp.float64),
                 "rng": jax.random.PRNGKey(0)}
        mix, clean, frames = batch
        new, _ = step_fn(state, {"mix": to64(mix), "clean": to64(clean),
                                 "frames": jnp.asarray(frames)})
        return jax.tree.map(np.asarray, {"params": new["params"],
                                         **new["extra_vars"]})


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_adam_step_weights_match_se_tpu(monkeypatch, name):
    """One step with the real optimiser on both sides from the same
    weights and batch: every weight and buffer after it within 1e-5 *
    max|w| of its tensor. A model that trains torch's two LSTM biases as
    two parameters moves their sum by 2 lr a step where se_tpu's one bias
    moves lr (Adam's first step moves each weight by lr * g / (|g| +
    eps)). Both steps run in fp64: in fp32 that first step's update
    amplifies round-off where a gradient is zero in exact arithmetic (a
    conv bias before batch-statistics BN: |g| ~ 1e-9 next to eps = 1e-8)
    or within round-off of it."""
    kw = FAMILIES[name]
    variables = _jax_variables(name, kw, seed=5)
    batch = _batch()
    want = get_model(name).from_jax_variables(
        _jax_adam_step_fp64(monkeypatch, name, kw, variables, batch))
    model, init_fn, step_fn, _ = make_train_step(
        TrainConfig(model=name, model_kwargs=kw), device="cpu")
    model.double()
    state = init_fn(0)
    model.load_state_dict(get_model(name).from_jax_variables(variables))
    mix, clean, frames = batch
    step_fn(state, {"mix": torch.from_numpy(mix).double(),
                    "clean": torch.from_numpy(clean).double(),
                    "frames": torch.from_numpy(frames.astype(np.int64))})
    got = model.state_dict()
    assert got.keys() == want.keys()
    for key, w in want.items():
        w = w.double().numpy()
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=key)


def test_uformer_train_step_matches_se_tpu(monkeypatch):
    """Dropout neutralised on both sides; BN batch statistics on; the
    DSConv blocks on their plain checkpointed path (se_tpu's train path)."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    variables = _jax_variables("uformer", {}, seed=4)
    batch = _batch()
    jloss, jgrads, jstats = _jax_step(monkeypatch, "uformer", {}, variables,
                                      batch)
    model, loss, grads = _port_step("uformer", {}, variables, batch,
                                    dropout=False)
    _compare("uformer", model, loss, grads, jloss, jgrads, jstats)


def _bn_arrays(rng, c):
    return (1 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c),
            0.1 * rng.standard_normal(c), rng.uniform(0.5, 1.5, c))


def _load_bn(bn, g, b, m, v):
    bn.load_state_dict({k: torch.tensor(np.float32(a)) for k, a in
                        zip(("weight", "bias", "running_mean",
                             "running_var"), (g, b, m, v))})
    return bn.train()


def test_batchnorm_train_mode_matches_flax(rng):
    x = (rng.standard_normal((3, 5, 4, 16)) * 2 + 0.5).astype(np.float32)
    g, b, m, v = (np.float32(a) for a in _bn_arrays(rng, 16))
    want, new = JBatchNorm().apply(
        {"params": {"bn": {"scale": g, "bias": b}},
         "batch_stats": {"bn": {"mean": m, "var": v}}}, x,
        use_running_average=False, mutable=["batch_stats"])
    bn = _load_bn(BatchNorm(16), g, b, m, v)
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    stats = new["batch_stats"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-5)


def test_complex_bn_train_mode_pools_re_and_im_as_se_tpu(rng):
    re, im = (rng.standard_normal((2, 5, 4, 8)).astype(np.float32) + s
              for s in (0.5, -1.0))
    g, b, m, v = (np.float32(a) for a in _bn_arrays(rng, 8))
    (w_re, w_im), new = JComplexBN().apply(
        {"params": {"bn3d": {"bn": {"scale": g, "bias": b}}},
         "batch_stats": {"bn3d": {"bn": {"mean": m, "var": v}}}}, re, im,
        train=True, mutable=["batch_stats"])
    bn = _load_bn(ComplexBN(8), g, b, m, v)
    got = bn(torch.from_numpy(np.concatenate([re, im], -1))).detach()
    np.testing.assert_allclose(got.numpy(), np.concatenate(
        [np.asarray(w_re), np.asarray(w_im)], -1), atol=1e-5)
    stats = new["batch_stats"]["bn3d"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-5)


@pytest.mark.parametrize("scale", [0.02, 3.0], ids=["below_clip",
                                                     "above_clip"])
def test_adam_matches_optax_chain(scale):
    """Three steps at lr 1e-3 on gradients of global norm ~0.3 (no clip)
    and ~50 (clipped to 5); parameters within 1e-6 absolute (updates of
    ~1e-3 a step, fp32 round-off on both sides)."""
    rng = np.random.default_rng(int(scale * 100))
    shapes = {"a": (4, 7), "b": (7,), "c": (3, 2, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    steps = [{k: (rng.standard_normal(s) * scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    norm = np.sqrt(sum(np.square(g).sum() for g in steps[0].values()))
    assert (norm < 5.0) == (scale < 1.0)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.scale_by_adam())
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    mine = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in mine.items()},
           "nu": {k: torch.zeros_like(v) for k, v in mine.items()}}
    for grads in steps:
        u, st = tx.update(jax.tree.map(jnp.asarray, grads), st, jp)
        jp = jax.tree.map(lambda p, u: p + (-1e-3) * u, jp, u)
        trainer.adam_update(mine, {k: torch.from_numpy(g)
                                   for k, g in grads.items()}, opt, 1e-3, 5.0)
    for k in shapes:
        np.testing.assert_allclose(mine[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0)
    assert opt["count"] == 3


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_plain_step(remat):
    """Uformer with dropout on (one generator seed) and BN batch
    statistics: two steps under `remat` give the weights, BN statistics,
    losses and generator state of the same steps without it (the same ops
    in the same order: equal to 1e-6 relative)."""
    batch = _torch_batch(*_batch(n=1600))
    out = {}
    for policy in ("none", remat):
        model, init_fn, step_fn, _ = make_train_step(
            TrainConfig(model="uformer", remat=policy), device="cpu")
        state = init_fn(0)
        losses = [step_fn(state, batch)[1].item() for _ in range(2)]
        out[policy] = (losses, model.state_dict(),
                       state["generator"].get_state())
    (l0, sd0, g0), (l1, sd1, g1) = out["none"], out[remat]
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for key in sd0:
        torch.testing.assert_close(sd1[key], sd0[key], rtol=1e-6, atol=0)
    assert torch.equal(g0, g1)


def test_checkpoint_restores_the_whole_state(tmp_path):
    """Uformer (dropout on): a saved and restored state takes the same next
    step as the one it came from: weights, BN statistics, Adam's moments,
    step, lr_scale and the dropout generator."""
    batch = _torch_batch(*_batch(n=1600))
    cfg = TrainConfig(model="uformer")
    model, init_fn, step_fn, _ = make_train_step(cfg, device="cpu")
    state = init_fn(0)
    for _ in range(2):
        state, _ = step_fn(state, batch)
    state["lr_scale"] = 0.5
    path = save_checkpoint(str(tmp_path), state, epoch=1, step=state["step"])
    assert os.path.basename(path) == "model.ckpt-1-2"
    assert latest_checkpoint(str(tmp_path)) == path
    assert latest_checkpoint(str(tmp_path), best=True) is None
    assert parse_epoch_step(str(tmp_path)) == (1, 2)

    model2, init2, step2, _ = make_train_step(cfg, device="cpu")
    blank = init2(7)
    restored, found = restore_checkpoint(str(tmp_path), blank)
    assert found and restored["step"] == 2 and restored["lr_scale"] == 0.5
    _, loss_a = step_fn(state, batch)
    _, loss_b = step2(restored, batch)
    assert loss_a.item() == loss_b.item()
    for (key, a), b in zip(model.state_dict().items(),
                           model2.state_dict().values()):
        assert torch.equal(a, b), key


def _write_corpus(root, n_utts=4, n=3200):
    rng = np.random.default_rng(11)
    ids = []
    for d in ("noisy", "clean"):
        os.makedirs(os.path.join(root, d))
    for i in range(n_utts):
        clean = (rng.standard_normal(n - 160 * i) * 0.1).astype(np.float32)
        noise = (rng.standard_normal(n - 160 * i) * 0.03).astype(np.float32)
        write_wav(os.path.join(root, "clean", f"u{i}.wav"), clean, 16000)
        write_wav(os.path.join(root, "noisy", f"u{i}.wav"), clean + noise,
                  16000)
        ids.append(f"u{i}")
    return ids


def test_manifest_dataset_batches_as_se_tpu(tmp_path):
    ids = _write_corpus(str(tmp_path))
    kw = dict(batch_size=3, convention="vb", shuffle=False,
              bucket_samples=1600)
    mine = list(ManifestDataset(str(tmp_path / "noisy"),
                                str(tmp_path / "clean"), ids, **kw))
    want = list(JManifestDataset(str(tmp_path / "noisy"),
                                 str(tmp_path / "clean"), ids, **kw))
    assert len(mine) == len(want) == 2
    for a, b in zip(mine, want):
        for field in ("mix", "clean", "frames", "lengths"):
            np.testing.assert_allclose(getattr(a, field), getattr(b, field),
                                       rtol=1e-6, atol=1e-7)
        assert a.ids == b.ids


def test_train_epochs_writes_checkpoints_and_restores(tmp_path):
    ids = _write_corpus(str(tmp_path))
    ds = ManifestDataset(str(tmp_path / "noisy"), str(tmp_path / "clean"),
                         ids, batch_size=2, convention="vb", shuffle=False,
                         bucket_samples=1600)
    ckpt = str(tmp_path / "CP_dir")
    cfg = TrainConfig(model="lstm", model_kwargs=dict(hidden=16))
    model, state, history = trainer.train_epochs(
        cfg, ds, cv_ds=ds, epochs=2, checkpoint_dir=ckpt, log_every=1,
        device="cpu")
    assert [s for s, _ in history] == [1, 2, 3, 4]
    assert all(np.isfinite(loss) for _, loss in history)
    files = set(os.listdir(ckpt))
    assert {"model.ckpt-0-2", "model.ckpt-1-4", "checkpoint", "best",
            "loss_curve.csv"} <= files
    assert parse_epoch_step(ckpt) == (1, 4)
    with open(os.path.join(ckpt, "loss_curve.csv")) as f:
        assert f.readline().strip() == "step,train_loss"
        assert len(f.readlines()) == 4

    model2, init2, _, _ = make_train_step(cfg, device="cpu")
    restored, found = restore_checkpoint(ckpt, init2(3))
    assert found and restored["step"] == 4
    wav = np.random.default_rng(2).standard_normal((2, 1600)).astype(
        np.float32) * 0.1
    np.testing.assert_array_equal(
        enhance_waveform("lstm", model2, wav, device="cpu"),
        enhance_waveform("lstm", model, wav, device="cpu"))


def test_train_mode_draws_dropout_from_a_generator():
    from se_tpu_torch.models.uformer import Uformer

    x = torch.zeros(1, 1600)
    model = Uformer(device="cpu").train()
    with pytest.raises(ValueError, match="Generator"):
        model(x, x)
    drop = Dropout(0.5).train()
    with pytest.raises(ValueError, match="Generator"):
        drop(x)
    y = drop(torch.ones(4, 1000), torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert Dropout(0.5)(x) is x  # eval mode, where modules start


def test_unported_dtype_and_io_kind_name_their_roadmap_items():
    """DeepXi's io kind trains through its driver; bf16 training, once a
    refusal here, runs on the CPU (tests/test_torch_bf16_train*.py hold it
    against se_tpu's)."""
    model, init_fn, step_fn, _ = make_train_step(
        TrainConfig(model="lstm", compute_dtype="bf16",
                    model_kwargs=dict(hidden=16)), device="cpu")
    state, loss = step_fn(init_fn(0), _torch_batch(*_batch()))
    assert bool(torch.isfinite(loss)) and state["step"] == 1
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        make_train_step(TrainConfig(model="lstm", compute_dtype="fp16"),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="DeepXiDriver"):
        make_train_step(TrainConfig(model="deepxi"), device="cpu")
