"""The ranks of tests/test_torch_parallel.py: imports torch and
se_tpu_torch only, so that a spawned interpreter never loads JAX.

    python tests/torch_parallel_worker.py DIR WORLD RANK

joins a gloo group of WORLD ranks through the file DIR/store_wWORLD, runs
every case of CASES whose world is WORLD on the CPU over a "data" mesh,
and saves each case's result as DIR/CASE_rankRANK.pt. `run_case(name,
None, DIR)` is the one-process run of the same case on the global batch,
which the test holds the ranks to. A case whose DIR/CASE_weights.pt
exists starts from those weights (the test writes se_tpu's there), the
others from `init_fn(0)`.
"""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import torch

N_SAMPLES = 2400  # 16 frames at hop 160 (the suite's train-step size)

# name: the family, its widths, the global batch's valid frames an
# utterance (unequal, so the ranks' valid counts differ), the world, and
# what else the case runs: an enhance of `enhance` utterances, bf16,
# remat, or the train steps in fp64. Uformer runs at its published widths
# on 16 frames, as the suite's other Uformer train steps. DPCRN at world
# 3 trains in fp64: in fp32 its second step parts from one process by
# 8e-5 of the largest gradient (a decoder weight's: round-off that step
# amplifies), in fp64 by 1.5e-15, so the fp64 step shows the sharding
# exact where the fp32 one cannot.
CASES = {
    "lstm": dict(model="lstm", kw=dict(hidden=48), frames=(16, 14, 12, 15),
                 world=2),
    "dpcrn": dict(model="dpcrn", kw={}, frames=(16, 9, 13, 16), world=2,
                  enhance=3),
    "fullsubnet": dict(model="fullsubnet",
                       kw=dict(fb_hidden=32, sb_hidden=24),
                       frames=(10, 8, 10, 9, 7, 10), world=2),
    "uformer": dict(model="uformer", kw={}, frames=(16, 12), world=2),
    "crn_remat": dict(model="crn", kw={}, frames=(16, 15, 10, 12), world=2,
                      remat="dots"),
    "lstm_bf16_remat": dict(model="lstm", kw=dict(hidden=48),
                            frames=(16, 14, 12, 15), world=2,
                            compute_dtype="bf16", remat="full"),
    "dpcrn_w3": dict(model="dpcrn", kw={}, frames=(16, 11, 9, 16, 14, 12),
                     world=3, enhance=4, fp64=True),
}
STEPS = 2


def make_batch(name: str, seed: int = 0) -> dict:
    """The case's global batch, numpy, from a seed."""
    frames = np.asarray(CASES[name]["frames"], np.int64)
    rng = np.random.default_rng(seed)
    b = len(frames)
    clean = (rng.standard_normal((b, N_SAMPLES)) * 0.1).astype(np.float32)
    mix = clean + (rng.standard_normal((b, N_SAMPLES)) * 0.05).astype(
        np.float32)
    return {"mix": mix, "clean": clean, "frames": frames}


def enhance_input(b: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, N_SAMPLES)) * 0.1).astype(np.float32)


def run_case(name: str, mesh, out_dir: str, resume: dict | None = None
             ) -> dict:
    """The case on the CPU, over `mesh` (None: one process): the enhance
    of `enhance` utterances from the starting weights if the case has it,
    then STEPS train steps, each step's loss, gradients (before the clip)
    and buffers, the train state after the first step ("state1": weights,
    Adam's state, the generator's) and the weights after the last. With
    `resume` (another run's "state1") the steps after the first start
    from it."""
    from se_tpu_torch.eval.enhance import enhance_waveform
    from se_tpu_torch.train.trainer import (
        TrainConfig, adam_state, make_train_step,
    )

    case = CASES[name]
    cfg = TrainConfig(model=case["model"], model_kwargs=case["kw"],
                      compute_dtype=case.get("compute_dtype", "fp32"),
                      remat=case.get("remat", "none"))
    model, init_fn, step_fn, _ = make_train_step(cfg, device="cpu",
                                                 mesh=mesh)
    state = init_fn(0)
    weights = os.path.join(out_dir, f"{name}_weights.pt")
    if os.path.exists(weights):
        model.load_state_dict(torch.load(weights))
    out = {"steps": []}
    if "enhance" in case:
        out["enhance"] = enhance_waveform(
            case["model"], model, enhance_input(case["enhance"]),
            device="cpu", mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(name).items()}
    if case.get("fp64"):
        model.double()
        state["opt_state"] = adam_state(dict(model.named_parameters()))
        batch = {k: v.double() if v.is_floating_point() else v
                 for k, v in batch.items()}
    for step in range(STEPS):
        if step == 1:
            out["state1"] = _snapshot(state)
            if resume is not None:
                _restore(state, resume)
        state, loss = step_fn(state, batch)
        out["steps"].append({
            "loss": float(loss),
            "grads": {k: p.grad.clone() for k, p in
                      model.named_parameters()},
            "buffers": {k: b.clone() for k, b in model.named_buffers()}})
    out["weights"] = {k: v.clone() for k, v in model.state_dict().items()}
    return out


def _snapshot(state: dict) -> dict:
    opt = state["opt_state"]
    return {"model": {k: v.clone() for k, v in
                      state["model"].state_dict().items()},
            "count": opt["count"],
            "mu": {k: v.clone() for k, v in opt["mu"].items()},
            "nu": {k: v.clone() for k, v in opt["nu"].items()},
            "generator": state["generator"].get_state()}


def _restore(state: dict, snap: dict) -> None:
    state["model"].load_state_dict(snap["model"])
    opt = state["opt_state"]
    opt["count"] = snap["count"]
    for key in ("mu", "nu"):
        for k, v in snap[key].items():
            opt[key][k].copy_(v)
    state["generator"].set_state(snap["generator"])


def _extras(mesh) -> dict:
    """What a world-3 group also checks: host_local_batch_to_global
    gives the global batch back from each rank's rows, and
    check_replicated fails where one rank's weight differs."""
    from se_tpu_torch.models import get_model
    from se_tpu_torch.parallel import (
        check_replicated, host_local_batch_to_global, shard_batch,
    )

    batch = make_batch("dpcrn_w3")
    back = host_local_batch_to_global(shard_batch(batch, mesh), mesh)
    gathered = all(np.array_equal(back[k], batch[k]) for k in batch)
    model = get_model("lstm").make(hidden=8, device="cpu")
    check_replicated(model, mesh)
    if mesh.rank == 1:
        with torch.no_grad():
            next(model.parameters()).view(-1)[0] += 1.0
    try:
        check_replicated(model, mesh)
        refused = False
    except RuntimeError as err:
        refused = "ranks [1]" in str(err)
    return {"gathered": gathered, "replicate_refused": refused}


def main(out_dir: str, world: int, rank: int) -> None:
    torch.set_num_threads(1)
    from se_tpu_torch.parallel import initialize_multihost, make_mesh

    store = os.path.join(out_dir, f"store_w{world}")
    backend = initialize_multihost(f"file://{store}", world, rank, "cpu")
    mesh = make_mesh()
    assert backend == "gloo" and mesh.data == world, (backend, mesh)
    for name, case in CASES.items():
        if case["world"] == world:
            torch.save(run_case(name, mesh, out_dir),
                       os.path.join(out_dir, f"{name}_rank{rank}.pt"))
    if world == 3:
        torch.save(_extras(mesh),
                   os.path.join(out_dir, f"extras_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    try:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
