"""The ranks of tests/test_torch_parallel.py and
tests/test_torch_parallel_model.py: imports torch and se_tpu_torch only,
so that a spawned interpreter never loads JAX.

    python tests/torch_parallel_worker.py DIR WORLD RANK [MODEL]

joins a gloo group of WORLD ranks through the file DIR/store_wWORLD (with
MODEL: DIR/store_wWORLDmMODEL), runs every case of CASES whose world is
WORLD on the CPU over a "data" mesh (with MODEL: every case of
MODEL_CASES whose world and model they are, over a {"data": WORLD /
MODEL, "model": MODEL} mesh, and `wrapper_case` of every wrapper of
WRAPPERS), and saves each case's result as DIR/CASE_rankRANK.pt.
`run_case(name, None, DIR)` is the one-process run of the same case on
the global batch, which the test holds the ranks to. A case whose
DIR/CASE_weights.pt exists starts from those weights (the test writes
se_tpu's there), the others from `init_fn(0)`.
"""

from __future__ import annotations

import contextlib
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
# the "model" axis (a model group of two ranks splits each kernel's
# leading axis): Uformer at 2 x 2 with dropout on (its attention mapped in
# the step, its four eval kernels in the decode of 4 utterances: 2 a data
# group); Uformer at 2 x 2 from se_tpu's weights, dropout off, one step
# (against se_tpu's 2 x 2 mesh step); DPCRN at 1 x 2, its LSTM layer calls
# mapped (with their carries) in the steps and in the decode of 3
# utterances (its odd folds take the unmapped fallback)
MODEL_CASES = {
    "uformer_model": dict(model="uformer", kw={}, frames=(16, 12, 14, 16),
                          world=4, model_axis=2, enhance=4),
    "uformer_model_jax": dict(model="uformer", kw={},
                              frames=(16, 12, 14, 16), world=4,
                              model_axis=2, steps=1, dropout=0.0),
    "dpcrn_model": dict(model="dpcrn", kw={}, frames=(16, 9, 13, 16),
                        world=2, model_axis=2, enhance=3),
}
STEPS = 2


def case(name: str) -> dict:
    return CASES[name] if name in CASES else MODEL_CASES[name]


def make_batch(name: str, seed: int = 0) -> dict:
    """The case's global batch, numpy, from a seed."""
    frames = np.asarray(case(name)["frames"], np.int64)
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
    Adam's state, the generator's), the weights after the last, and the
    rows of a rank's share in each mapped kernel call. With
    `resume` (another run's "state1") the steps after the first start
    from it."""
    from se_tpu_torch.eval.enhance import enhance_waveform
    from se_tpu_torch.nn import Dropout
    from se_tpu_torch.train.trainer import (
        TrainConfig, adam_state, make_train_step,
    )

    case_ = case(name)
    cfg = TrainConfig(model=case_["model"], model_kwargs=case_["kw"],
                      compute_dtype=case_.get("compute_dtype", "fp32"),
                      remat=case_.get("remat", "none"))
    model, init_fn, step_fn, _ = make_train_step(cfg, device="cpu",
                                                 mesh=mesh)
    state = init_fn(0)
    weights = os.path.join(out_dir, f"{name}_weights.pt")
    if os.path.exists(weights):
        model.load_state_dict(torch.load(weights))
    if "dropout" in case_:
        for mod in model.modules():
            if isinstance(mod, Dropout):
                mod.rate = case_["dropout"]
    out = {"steps": [], "mapped_rows": []}
    if "enhance" in case_:
        with mapped_rows(out["mapped_rows"]):
            out["enhance"] = enhance_waveform(
                case_["model"], model, enhance_input(case_["enhance"]),
                device="cpu", mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(name).items()}
    if case_.get("fp64"):
        model.double()
        state["opt_state"] = adam_state(dict(model.named_parameters()))
        batch = {k: v.double() if v.is_floating_point() else v
                 for k, v in batch.items()}
    for step in range(case_.get("steps", STEPS)):
        if step == 1:
            out["state1"] = _snapshot(state)
            if resume is not None:
                _restore(state, resume)
        with mapped_rows(out["mapped_rows"]):
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


# the six wrappers se_tpu maps (`shard_map_leading`'s callers), each on
# float64 inputs whose leading axis is `rows` long: (call, inputs, the
# count of mapped leading args). Gradients of every input, the weights'
# (replicated) included
WRAPPERS = ("attention", "dsconv_block", "dsconv_pair", "encoder",
            "decoder", "lstm")


def wrapper_inputs(name: str, rows: int, seed: int = 3):
    """(call, inputs) of wrapper `name` at leading `rows`, float64 from a
    seed, every input requiring grad."""
    from torch_kernel_inputs import (
        att_inputs, dec_params, dsconv_params, enc_params, lstm_inputs,
        pair_inputs, rand,
    )

    from se_tpu_torch.ops import attention, decoder, dsconv, encoder, lstm

    rng = np.random.default_rng(seed)
    if name == "attention":
        arrs = att_inputs(rng, rows, 2, 5)
        call = lambda q, k, v: attention.sdp_attention(q, k, v, 0.25)
    elif name == "dsconv_block":
        arrs = (rand(rng, rows, 5, 4, 16, scale=0.5),
                *dsconv_params(rng, 16, 4, 2))
        call = lambda x, *p: dsconv.dsconv_block(x, p, 2, 1, 2)
    elif name == "dsconv_pair":
        xc, xm, pc, pm = pair_inputs(rng, rows, 5, 4, 8, 4)
        arrs = (xc, xm, *pc, *pm)
        call = lambda xc, xm, *p: dsconv.dsconv_pair_block(
            xc, xm, p[:13], p[13:], 2, 1)
    elif name == "encoder":
        arrs = (rand(rng, rows, 3, 8, 8), rand(rng, rows, 3, 8, 4),
                *enc_params(rng, 4, 6))
        call = lambda xc, xm, *p: encoder.encoder_level(xc, xm, p)
    elif name == "decoder":
        arrs = (rand(rng, rows, 3, 4, 16), rand(rng, rows, 3, 4, 8),
                *dec_params(rng, 8, 4))
        call = lambda xc, xm, *p: decoder.decoder_level(xc, xm, p, True)
    else:  # the layer with a carry: x, h0, c0 mapped, the weights not
        x, wx, wh, b = lstm_inputs(rng, rows, 6, 3, 4)
        arrs = (x, rand(rng, rows, 4), rand(rng, rows, 4), wx, wh, b)
        call = lambda x, h0, c0, wx, wh, b: lstm.lstm_layer_kernel(
            x, wx, wh, b, False, h0, c0)
    inputs = [torch.from_numpy(np.asarray(a)).double().requires_grad_()
              for a in arrs]
    return call, inputs


@contextlib.contextmanager
def mapped_rows(seen: list):
    """While open, each mapped call (`parallel.mesh._MapLeading`) appends
    the rows of a rank's share to `seen`."""
    from se_tpu_torch.parallel import mesh as mesh_mod

    real = mesh_mod._MapLeading.apply

    def spy(spec, *args):
        seen.append(spec.rows)
        return real(spec, *args)

    mesh_mod._MapLeading.apply = spy
    try:
        yield seen
    finally:
        mesh_mod._MapLeading.apply = real


def _flat(out) -> list:
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def wrapper_case(name: str, rows: int, mesh) -> dict:
    """Wrapper `name` at leading `rows` under `activation_mesh(mesh)`
    (None: unmapped): its outputs, the gradients of every input under the
    loss sum(out * w) over the outputs (w drawn from a seed), and the rows
    a rank's share held in each mapped call (`_MapLeading`'s)."""
    from se_tpu_torch.parallel import activation_mesh

    call, inputs = wrapper_inputs(name, rows)
    with mapped_rows([]) as seen, activation_mesh(mesh):
        outs = _flat(call(*inputs))
    rng = np.random.default_rng(11)
    loss = sum((o * torch.from_numpy(rng.standard_normal(tuple(o.shape))))
               .sum() for o in outs)
    loss.backward()
    return {"outputs": [o.detach() for o in outs],
            "grads": [t.grad for t in inputs], "mapped_rows": seen}


def _model_extras(mesh) -> dict:
    """What a model-axis group also checks: this rank's coordinates, its
    shard of a batch and its global row (those of its data coordinate),
    the global batch back from the shards, and check_replicated failing
    where the last rank's weight differs (every rank held to rank 0)."""
    from se_tpu_torch.models import get_model
    from se_tpu_torch.parallel import (
        activation_mesh, check_replicated, host_local_batch_to_global,
        shard_batch,
    )
    from se_tpu_torch.parallel.mesh import row_offset

    batch = {"x": np.arange(4 * mesh.data)}
    rows = shard_batch(batch, mesh)
    with activation_mesh(mesh):
        first = row_offset(4)
    back = host_local_batch_to_global(rows, mesh)
    model = get_model("lstm").make(hidden=8, device="cpu")
    check_replicated(model, mesh)
    last = mesh.size - 1
    if mesh.rank == last:
        with torch.no_grad():
            next(model.parameters()).view(-1)[0] += 1.0
    try:
        check_replicated(model, mesh)
        refused = False
    except RuntimeError as err:
        refused = f"ranks [{last}]" in str(err)
    return {"coords": (mesh.data_index, mesh.model_index),
            "rows": rows["x"].tolist(), "row_offset": first,
            "gathered": bool(np.array_equal(back["x"], batch["x"])),
            "replicate_refused": refused}


def main(out_dir: str, world: int, rank: int, model: int = 0) -> None:
    torch.set_num_threads(1)
    from se_tpu_torch.parallel import initialize_multihost, make_mesh

    tag = f"w{world}m{model}" if model else f"w{world}"
    store = os.path.join(out_dir, f"store_{tag}")
    backend = initialize_multihost(f"file://{store}", world, rank, "cpu")
    if model:
        mesh = make_mesh({"data": world // model, "model": model})
        cases = {n: c for n, c in MODEL_CASES.items()
                 if (c["world"], c["model_axis"]) == (world, model)}
    else:
        mesh = make_mesh()
        cases = {n: c for n, c in CASES.items() if c["world"] == world}
    assert backend == "gloo" and mesh.size == world, (backend, mesh)
    for name in cases:
        torch.save(run_case(name, mesh, out_dir),
                   os.path.join(out_dir, f"{name}_rank{rank}.pt"))
    if model:
        torch.save({(name, rows): wrapper_case(name, rows, mesh)
                    for name in WRAPPERS for rows in (4, 3)},
                   os.path.join(out_dir, f"wrappers_{tag}_rank{rank}.pt"))
        torch.save(_model_extras(mesh),
                   os.path.join(out_dir, f"extras_{tag}_rank{rank}.pt"))
    if world == 3:
        torch.save(_extras(mesh),
                   os.path.join(out_dir, f"extras_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    try:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
             *(int(a) for a in sys.argv[4:5]))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
