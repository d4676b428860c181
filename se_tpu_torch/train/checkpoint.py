"""Checkpoints with the reference's pointer-file conventions, on
torch.save: the port of se_tpu/train/checkpoint.py (which writes Orbax).

As Uformer/misc.py:16-73: a checkpoint is saved as
`model.ckpt-{epoch}-{step}` with a `checkpoint` pointer file naming the
latest, plus a `best` pointer updated on validation improvement (the
BEST_MODEL/ convention, ref DCCRN/config.py:19-24). A checkpoint holds the
train state of `trainer.make_train_step`: the model's state_dict (BN
running statistics included), the optimiser's state, `step`, `lr_scale`
and the dropout generator's state.
"""

from __future__ import annotations

import os

import torch


def _ckpt_name(epoch: int, step: int) -> str:
    return f"model.ckpt-{epoch}-{step}"


def _write_pointer(checkpoint_dir: str, pointer: str, name: str) -> None:
    tmp = os.path.join(checkpoint_dir, f".{pointer}.tmp")
    with open(tmp, "w") as f:
        f.write(name)
    os.replace(tmp, os.path.join(checkpoint_dir, pointer))


def save_checkpoint(checkpoint_dir: str, state: dict, epoch: int, step: int,
                    best: bool = False) -> str:
    """Write `state` as model.ckpt-{epoch}-{step} and point `checkpoint`
    (and `best` when `best`) at it; returns the file's path."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    name = _ckpt_name(epoch, step)
    path = os.path.abspath(os.path.join(checkpoint_dir, name))
    blob = {"model": state["model"].state_dict(),
            "opt_state": state["opt_state"],
            "step": int(state["step"]),
            "lr_scale": float(state["lr_scale"]),
            "generator": state["generator"].get_state()}
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    _write_pointer(checkpoint_dir, "checkpoint", name)
    if best:
        _write_pointer(checkpoint_dir, "best", name)
    return path


def latest_checkpoint(checkpoint_dir: str, best: bool = False) -> str | None:
    pointer = os.path.join(checkpoint_dir, "best" if best else "checkpoint")
    if not os.path.isfile(pointer):
        return None
    with open(pointer) as f:
        name = f.read().strip()
    return os.path.abspath(os.path.join(checkpoint_dir, name))


def restore_checkpoint(checkpoint_dir: str, target_state: dict,
                       best: bool = False):
    """Restore into `target_state` (its model's weights and buffers, the
    optimiser's state on the model's device, step, lr_scale and the
    generator); returns (state, found)."""
    path = latest_checkpoint(checkpoint_dir, best=best)
    if path is None:
        return target_state, False
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model = target_state["model"]
    model.load_state_dict(blob["model"])
    dev = next(model.parameters()).device
    opt = blob["opt_state"]
    state = dict(target_state)
    state["opt_state"] = {
        "count": opt["count"],
        "mu": {k: v.to(dev) for k, v in opt["mu"].items()},
        "nu": {k: v.to(dev) for k, v in opt["nu"].items()}}
    state["step"] = blob["step"]
    state["lr_scale"] = blob["lr_scale"]
    state["generator"].set_state(blob["generator"])
    return state, True


def parse_epoch_step(checkpoint_dir: str) -> tuple[int, int]:
    path = latest_checkpoint(checkpoint_dir)
    if path is None:
        return 0, 0
    name = os.path.basename(path)  # model.ckpt-{epoch}-{step}
    _, epoch, step = name.rsplit("-", 2)
    return int(epoch), int(step)
