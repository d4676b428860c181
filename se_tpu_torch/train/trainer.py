"""Training loop: feature prep per io-kind, train and eval steps, Adam; the
port of se_tpu/train/trainer.py.

Reference semantics kept (SURVEY.md §2.2, §5), as se_tpu keeps them:
- Adam(1e-3) by default (ref LSTM/config.py:13), exactly optax's
  `chain(clip_by_global_norm(5.0), scale_by_adam())` then
  p -= lr * lr_scale * u (se_tpu :92-96, :254-257);
- the frame-mask-aware losses of `se_tpu_torch.train.losses`, each
  family's default loss (`DEFAULT_LOSSES`);
- halving-style `learning_rate_decaying` on a validation plateau
  (ref Uformer/misc.py:76-86) by an lr scale carried in the train state.

The model trains in train mode (`model.train()`: BN batch statistics,
Uformer's dropout, FullSubNet's drop_band); its weights are the train
state's, updated in place. Random draws come from the state's
`torch.Generator`, on the model's device. Features are made under
`torch.no_grad()` through `stft_auto` (the STFT kernel on the card, which
has no gradient). The trainer never changes TF32 flags: fp32 training on
the card that should agree with the CPU needs
`torch.backends.cudnn.allow_tf32 = False` (torch's default is True) and
`torch.backends.cuda.matmul.allow_tf32 = False`, as chip_smoke.py sets.

`compute_dtype="bf16"` is se_tpu's mixed precision (its trainer.py
`forward_loss`): the fp32 master weights stay the model's parameters, and
inside the graph the model runs on their bf16 casts and on its buffers'
(`torch.func.functional_call`), so each master's `.grad` is fp32. The
model's inputs are cast to bf16 and its outputs back to fp32; the BN
statistics it updates (fp32: flax mixes the bf16 old ones with fp32 batch
ones) are written back to its buffers. The features (`_prep`), the
losses, the clip and Adam stay fp32.

`mesh` (a `parallel.make_mesh` over torch.distributed ranks, one process
a rank): every rank calls the step on the same global batch, computes
its contiguous rows, and the step equals one device's step on the global
batch, as se_tpu's over a mesh does (its GSPMD step; tests hold the two
together). Under `parallel.activation_mesh` BN takes the global batch's
statistics, dropout the global mask's rows, drop_band groups rows by
their global index, and each loss divides this rank's numerator by the
global denominator (`train.losses`); the backward's gradients are then
all-reduced (a sum) over the data group, and the clip and Adam run alike
on every rank. A "model" axis above 1 splits each kernel's rows over the
model group (`parallel.map_leading`: Uformer's attention in a train
step); its backward sums the weights' gradients over that group, so the
data group's all-reduce sums whole gradients. The
weights start as `init_fn(seed)` draws them on every rank, broadcast from
rank 0 and checked equal (`parallel.replicate`); the dropout generators
are seeded alike and stay in step. No DDP: it averages gradients by the
world size and re-broadcasts buffers, where this step sums gradients
whose losses already carry the global denominators and keeps BN's
statistics equal by computing them globally. The hybrid io-kind
(DeepXi) trains through its own driver,
`models.deepxi_driver.DeepXiDriver.train`, as in se_tpu (whose
`make_train_step` has no DeepXi branch either).

Spans (utils/profiling.py): `train.step` around `step_fn`, holding
`train.forward` (the forward and the loss, `train.prep` around `_prep`
inside it), `train.backward` (`loss.backward()`; under remat also the
checkpointed forward's rerun) and `train.optimizer` (the gradients, the
mesh's all-reduce, the clip and Adam).
"""

from __future__ import annotations

import csv
import dataclasses
import functools
import os

import numpy as np
import torch
from torch.func import functional_call

from se_tpu_torch.device import resolve_device
from se_tpu_torch.models import get_model
from se_tpu_torch.models.fullsubnet import drop_band, group_rows
from se_tpu_torch.models.registry import ModelEntry
from se_tpu_torch.ops._dtype import to_float
from se_tpu_torch.ops.stft import istft
from se_tpu_torch.ops.stft_fused import stft_auto
from se_tpu_torch.parallel import collectives as C
from se_tpu_torch.parallel.mesh import (
    activation_mesh, replicate, row_offset, shard_batch,
)
from se_tpu_torch.train import losses as L
from se_tpu_torch.train.checkpoint import save_checkpoint
from se_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainConfig:
    model: str
    loss: str = "default"
    learning_rate: float = 1e-3
    compressed: bool = True
    grad_clip: float | None = 5.0
    # Rematerialization (memory <-> recompute): "none" keeps every forward
    # activation for the backward; "dots" keeps only the matmul and conv
    # outputs (aten mm, addmm, bmm, convolution) and recomputes the rest;
    # "full" recomputes the whole forward. All three give the same step.
    remat: str = "none"
    compute_dtype: str = "fp32"
    model_kwargs: dict = dataclasses.field(default_factory=dict)


DEFAULT_LOSSES = {
    "lstm": "mag_mse",
    "crn": "mag_mse",
    "gcrn": "com_mag_mse",
    "dpcrn": "com_mag_mse",
    "fullsubnet": "com_mag_mse",
    "dccrn": "com_mag_mse",
    "ctsnet": "com_mag_mse",
    "g2net": "stagewise_com_mag_mse",
    "taylorsenet": "com_mag_mse",
    "uformer": "uformer",
    "deepxi": "bce",
}

# optax.scale_by_adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# the ops whose outputs remat="dots" keeps
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
        torch.ops.aten.bmm.default, torch.ops.aten.convolution.default)


@torch.no_grad()
def _prep(entry: ModelEntry, mix, clean, compressed: bool):
    """Waveforms -> (mag, lmag, spec, lspec): the (compressed) magnitudes
    and the complex (B, T, F, 2) spectra of mix and clean."""
    cfg = entry.stft
    re, im = stft_auto(mix, cfg)
    lre, lim = stft_auto(clean, cfg)
    mag = torch.sqrt(re * re + im * im)
    lmag = torch.sqrt(lre * lre + lim * lim)
    phase = torch.atan2(im, re)
    lphase = torch.atan2(lim, lre)
    if compressed:
        mag, lmag = torch.sqrt(mag), torch.sqrt(lmag)
    spec = torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)], -1)
    lspec = torch.stack([lmag * torch.cos(lphase), lmag * torch.sin(lphase)],
                        -1)
    return mag, lmag, spec, lspec


def adam_state(params: dict) -> dict:
    """Adam's state for `params` (name -> tensor): count 0, the moments
    zero."""
    return {"count": 0,
            "mu": {n: torch.zeros_like(p) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()}}


def adam_update(params, grads, opt_state: dict, lr: float,
                grad_clip: float | None) -> None:
    """optax `chain(clip_by_global_norm(grad_clip), scale_by_adam())`, then
    p -= lr * u, in place. `params` and `grads`: name -> tensor; the
    global norm runs over every gradient, and the gradients are scaled by
    grad_clip / norm only where norm >= grad_clip."""
    names = list(params)
    if grad_clip:
        norm = torch.sqrt(sum(grads[n].square().sum() for n in names))
        keep = norm < grad_clip
        grads = {n: torch.where(keep, grads[n], grads[n] / norm * grad_clip)
                 for n in names}
    opt_state["count"] += 1
    count = opt_state["count"]
    c1, c2 = 1.0 - ADAM_B1 ** count, 1.0 - ADAM_B2 ** count
    for n in names:
        g, mu, nu = grads[n], opt_state["mu"][n], opt_state["nu"][n]
        mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
        nu.mul_(ADAM_B2).add_(g * g, alpha=1.0 - ADAM_B2)
        u = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
        params[n].sub_(lr * u)


def make_train_step(cfg: TrainConfig, device=None, mesh=None):
    """Returns (model, init_fn(seed) -> state, step_fn(state, batch) ->
    (state, loss), eval_fn(state, batch) -> loss). `device` None means the
    card (raises without one); under `mesh`, this rank's device. A batch
    is `batch_to_torch`'s dict on the model's device, the global batch on
    every rank of `mesh` (its rows divide over the "data" axis); `state`
    holds the model, the optimiser's state ("count", "mu", "nu"), "step",
    "lr_scale" and the dropout "generator". Under `mesh` the losses are
    the global batch's, on every rank, and so are the gradients the step
    leaves in `.grad`."""
    if cfg.compute_dtype not in ("fp32", "bf16"):
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
    if cfg.remat not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    dev = resolve_device(device)
    entry = get_model(cfg.model)
    if entry.io_kind == "hybrid":
        raise NotImplementedError(
            "io kind 'hybrid' trains through its own driver: "
            "models.deepxi_driver.DeepXiDriver.train")
    model = entry.make(**cfg.model_kwargs, device=dev)
    loss_name = cfg.loss if cfg.loss != "default" else \
        DEFAULT_LOSSES[cfg.model]
    net = model if cfg.compute_dtype == "fp32" else \
        functools.partial(_bf16_call, model)

    def forward_loss(batch, generator):
        mix, clean, frames = batch["mix"], batch["clean"], batch["frames"]
        if entry.io_kind == "waveform":
            est, src, est_cplx, src_cplx = net(mix, clean,
                                               generator=generator)
            e, s = torch.stack(est_cplx, -1), torch.stack(src_cplx, -1)
            return (L.uformer_sisnr_loss(est, src)
                    + L.uformer_cplx_mse_loss(e, s)
                    + L.uformer_mag_mse_loss(e, s))

        with span("train.prep"):
            mag, lmag, spec, lspec = _prep(entry, mix, clean,
                                           cfg.compressed)
        if entry.io_kind == "mag_mask":
            return L.mag_mse_loss(net(mag), lmag, frames)

        if entry.io_kind == "cirm":
            mask = net(mag)
            if model.training and mask.shape[2] != spec.shape[2]:
                # FullSubNet's drop_band shrank F and regrouped the batch:
                # the same for the features, labels and frame counts (ref
                # fullsubnet_net_sa/model.py:101-104)
                groups = model.num_groups_in_drop_band
                first = row_offset(frames.shape[0])  # a shard's global row
                spec = drop_band(spec, groups, first)
                lspec = drop_band(lspec, groups, first)
                frames = group_rows(frames, groups, first)
            m_re, m_im = mask[..., 0], mask[..., 1]
            est = torch.stack([m_re * spec[..., 0] - m_im * spec[..., 1],
                               m_re * spec[..., 1] + m_im * spec[..., 0]],
                              -1)
            return L.com_mag_mse_loss(est, lspec, frames)

        # complex_map / complex_mask
        est = net(spec)
        if loss_name == "stagewise_com_mag_mse":
            return L.stagewise_com_mag_mse_loss(list(est), lspec, frames)
        if est.ndim == 5:
            est = est[-1]
        if loss_name == "fusion_snr":
            # DCCRN_SNR's recipe: 0.5 SI-SNR + 0.5 SV-SNR on the
            # resynthesised waveforms (ref DCCRN_SNR/Backup.py:140-147)
            e_re, e_im = est[..., 0], est[..., 1]
            if cfg.compressed:  # undo the mag**0.5 regime before synthesis
                e_mag = torch.sqrt(torch.clamp(e_re * e_re + e_im * e_im,
                                               min=1e-12))
                e_re, e_im = e_mag * e_re, e_mag * e_im
            n = mix.shape[-1]
            est_wav = istft(e_re, e_im, entry.stft, length=n)
            lengths = torch.clamp(frames * entry.stft.hop, max=n)
            return L.fusion_snr_loss(est_wav, clean, lengths)
        return L.com_mag_mse_loss(est, lspec, frames)

    def init_fn(seed: int = 0) -> dict:
        """Weights drawn from `seed` as the constructor draws them, Adam's
        moments zero, step 0, lr_scale 1, the dropout generator seeded."""
        fresh = entry.make(**cfg.model_kwargs, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
        model.load_state_dict(fresh.state_dict())
        if mesh is not None:
            replicate(model, mesh)
        return {"model": model,
                "opt_state": adam_state(dict(model.named_parameters())),
                "step": 0, "lr_scale": 1.0,
                "generator": torch.Generator(dev).manual_seed(seed)}

    if cfg.remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       list(DOTS))
    else:
        from torch.utils.checkpoint import noop_context_fn as context_fn

    def loss_and_grads(batch, generator):
        """The train forward and its backward. Under remat the forward runs
        again in the backward: each run starts the generator from the same
        state (the same dropout masks), and the BN running statistics and
        the generator are left as the first run left them (updated once a
        step)."""
        if cfg.remat == "none":
            with span("train.forward"):
                loss = forward_loss(batch, generator)
            with span("train.backward"):
                loss.backward()
            return loss
        from torch.utils.checkpoint import checkpoint

        start = generator.get_state()

        def run():
            generator.set_state(start)
            return forward_loss(batch, generator)

        with span("train.forward"):
            loss = checkpoint(run, use_reentrant=False,
                              context_fn=context_fn)
        kept = {n: b.clone() for n, b in model.named_buffers()}
        after = generator.get_state()
        with span("train.backward"):  # the checkpointed run's too
            loss.backward()
        with torch.no_grad():  # by name: BN replaces its statistics
            for n, b in model.named_buffers():
                b.copy_(kept[n])
        generator.set_state(after)
        return loss

    def step_fn(state: dict, batch: dict):
        """One step on `batch`: updates the model's weights and BN
        statistics and `state` in place; returns (state, loss), the loss
        a 0-d tensor on the model's device. The step's gradients (before
        the clip) stay in the parameters' `.grad` until the next step."""
        with span("train.step"):
            model.train()
            params = dict(model.named_parameters())
            for p in params.values():
                p.grad = None
            if mesh is None:
                loss = loss_and_grads(batch, state["generator"])
            else:
                with activation_mesh(mesh):
                    loss = loss_and_grads(shard_batch(batch, mesh),
                                          state["generator"])
                loss = C.all_reduce_sum(loss, mesh)
            with span("train.optimizer"):
                grads = {n: p.grad if p.grad is not None
                         else torch.zeros_like(p)
                         for n, p in params.items()}
                if mesh is not None:
                    grads = _all_reduce_grads(params, grads, mesh)
                with torch.no_grad():
                    adam_update(params, grads, state["opt_state"],
                                cfg.learning_rate * state["lr_scale"],
                                cfg.grad_clip)
            state["step"] += 1
            return state, loss.detach()

    def eval_fn(state: dict, batch: dict):
        """The loss in eval mode (running statistics, no dropout); under
        `mesh` the global batch's, each rank computing its rows."""
        was = model.training
        model.eval()
        with torch.no_grad():
            if mesh is None:
                loss = forward_loss(batch, None)
            else:
                with activation_mesh(mesh):
                    loss = forward_loss(shard_batch(batch, mesh), None)
                loss = C.all_reduce_sum(loss, mesh)
        model.train(was)
        return loss

    return model, init_fn, step_fn, eval_fn


def _all_reduce_grads(params: dict, grads: dict, mesh) -> dict:
    """Every gradient summed over the data group (one all-reduce of them
    all, flattened), written back into each parameter's `.grad`."""
    names = list(grads)
    flat = C.all_reduce_sum(torch.cat([grads[n].reshape(-1)
                                       for n in names]), mesh)
    out = {}
    for n, part in zip(names, flat.split([grads[n].numel()
                                          for n in names])):
        out[n] = part.view_as(grads[n])
        params[n].grad = out[n]
    return out


def _bf16(nest):
    """The floating tensors of a nest (tuples and lists) cast to bf16."""
    if isinstance(nest, (tuple, list)):
        return type(nest)(_bf16(x) for x in nest)
    if isinstance(nest, torch.Tensor) and nest.is_floating_point():
        return nest.to(torch.bfloat16)
    return nest


def _bf16_call(model: torch.nn.Module, *args, **kw):
    """`model(*args, **kw)` in se_tpu's bf16 train contract: the floating
    parameters and buffers cast to bf16 inside the graph (the casts'
    backward hands the fp32 masters fp32 gradients), the inputs cast to
    bf16, the outputs widened to fp32. A buffer the forward replaced (BN's
    running statistics, fp32) is copied back into the model's own."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    cast = {n: _bf16(t) for n, t in own.items()}
    state = dict(cast)
    out = functional_call(model, state, _bf16(args), kw)
    with torch.no_grad():
        for n, t in state.items():
            if t is not cast[n]:
                own[n].copy_(t)
    return to_float(out)


def decay_learning_rate(state: dict, rate: float = 0.5) -> dict:
    """Reference-style lr decay on a validation plateau
    (Uformer/misc.py:76-86)."""
    state["lr_scale"] = state["lr_scale"] * rate
    return state


def batch_to_torch(batch, device=None) -> dict:
    """A `data.Batch` -> the step's dict of tensors on `device` (None
    means the card)."""
    dev = resolve_device(device)
    return {"mix": torch.from_numpy(np.asarray(batch.mix)).to(dev),
            "clean": torch.from_numpy(np.asarray(batch.clean)).to(dev),
            "frames": torch.from_numpy(
                np.asarray(batch.frames, np.int64)).to(dev)}


def train_epochs(cfg: TrainConfig, train_ds, cv_ds=None, epochs: int = 1,
                 checkpoint_dir: str | None = None, log_every: int = 50,
                 device=None, mesh=None):
    """Simple epoch loop with best-model tracking and lr decay, from
    `init_fn(0)`; returns (model, state, history), history the (step,
    train loss) pairs logged every `log_every` steps, written to
    `loss_curve.csv` beside the checkpoints. Under `mesh` every rank
    iterates the same global batches and steps as `make_train_step`
    says; the validation loss every rank decides on is rank 0's, rank 0
    alone writes the checkpoints and the curve, and every rank waits for
    them (any rank may restore them after)."""
    model, init_fn, step_fn, eval_fn = make_train_step(cfg, device=device,
                                                       mesh=mesh)
    dev = next(model.parameters()).device
    writer = mesh is None or mesh.rank == 0
    state = init_fn(0)
    best_cv = np.inf
    history = []
    for epoch in range(epochs):
        for batch in train_ds:
            state, loss = step_fn(state, batch_to_torch(batch, dev))
            if state["step"] % log_every == 0:
                history.append((state["step"], float(loss)))
        if cv_ds is not None:
            cv_losses = [float(eval_fn(state, batch_to_torch(b, dev)))
                         for b in cv_ds]
            cv = float(np.mean(cv_losses)) if cv_losses else np.inf
            if mesh is not None:  # one decision on every rank: rank 0's
                cv = float(C.broadcast_(torch.tensor(
                    [cv], dtype=torch.float64, device=dev), mesh)[0])
            if cv < best_cv:
                best_cv = cv
                if checkpoint_dir and writer:
                    save_checkpoint(checkpoint_dir, state, epoch,
                                    state["step"], best=True)
            else:
                state = decay_learning_rate(state)
        if checkpoint_dir and writer:
            save_checkpoint(checkpoint_dir, state, epoch, state["step"])
    if checkpoint_dir and history and writer:
        # the training-loss curve (the reference's loss_dir .mat role, ref
        # LSTM/config.py:10)
        with open(os.path.join(checkpoint_dir, "loss_curve.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["step", "train_loss"])
            w.writerows(history)
    if mesh is not None:
        C.barrier(mesh)
    return model, state, history
