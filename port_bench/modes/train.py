"""Train cells: the port's training step, `make_train_step`'s
`step_fn`, on (B, N) mix and clean batches from a pool made on the
device at set-up, back to back; each step ends in `loss.item()`.

Set-up builds the step once, loads the benchmark's weights, and drives
it through its first three steps on three distinct batches through the
window's own call; the window goes on from that same state. `correct`
compares those three steps with the plain reference's: the first step's
loss, the first gradient as Adam gets it (its first moment after one step
over 1 - b1: the clipped gradient) and the parameters' change after
three steps, the last two leaf by leaf (`gaps`).
"""

from __future__ import annotations

import math

import numpy as np

from port_bench import harness
from port_bench.reference.common import FP32, Precision

CHECKED_STEPS = 3
# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone: left out of the change
STILL_LEAF = 1e-3


class Program:
    def __init__(self, cell: harness.Cell, seed: int, device):
        import torch

        from se_tpu_torch.train import trainer

        cfg, tr = cell.config, cell.traffic
        self.cell, self.device = cell, device
        tcfg = trainer.TrainConfig(model=cfg["family"],
                                   model_kwargs=dict(cfg["model"]),
                                   **cfg["train_config"])
        model, init_fn, self.step_fn, _ = trainer.make_train_step(
            tcfg, device=device)
        self.state = init_fn(harness.torch_seed(seed))
        gen = harness.generator(seed, device)
        self.sd = harness.seeded_state(model, gen, device)
        model.load_state_dict(self.sd)
        n = round(tr["utterance_s"] * cfg["sample_rate"])
        shape = (tr["pool"], tr["batch"], n)
        clean = torch.randn(shape, generator=gen, device=device) \
            .mul_(tr["level"])
        noise = torch.randn(shape, generator=gen, device=device) \
            .mul_(tr["level"] * tr["noise_ratio"])
        frames = torch.full((tr["batch"],), n // cfg["stft"]["hop"] + 1,
                            dtype=torch.int64, device=device)
        self.pool = [{"mix": clean[k] + noise[k], "clean": clean[k],
                      "frames": frames} for k in range(tr["pool"])]
        self.items_per_call = tr["batch"] * n / cfg["sample_rate"]
        self.shape = {"batch": tr["batch"], "samples": n}
        names = [k for k, _ in model.named_parameters()]
        b1 = trainer.ADAM_B1
        self.losses = []
        for k in range(CHECKED_STEPS):
            self.state, loss = self.step_fn(self.state, self.pool[k])
            self.losses.append(loss.item())
            if k == 0:
                mu = self.state["opt_state"]["mu"]
                self.grad1 = {n: (mu[n] / (1.0 - b1)).clone() for n in names}
        self.params = {n: p.detach().clone()
                       for n, p in model.named_parameters()}

    def call(self, i: int) -> bool:
        batch = self.pool[(CHECKED_STEPS + i) % len(self.pool)]
        self.state, loss = self.step_fn(self.state, batch)
        return math.isfinite(loss.item())

    def free(self) -> None:
        self.state = self.step_fn = None

    def reference(self, p: Precision = FP32) -> dict:
        return self.cell.reference().train_steps(
            self.sd, self.pool[:CHECKED_STEPS], self.cell.config, p)

    def compare(self, outputs: dict | None = None,
                detail: dict | None = None) -> list:
        """[(number, value)]: the three gaps of `outputs` (by default the
        program's first steps) from the reference's."""
        prog = outputs or {"losses": self.losses, "grad1": self.grad1,
                           "params": self.params}
        return gaps(prog, self.reference(), self.sd, detail)


def _norm(t) -> float:
    return float(t.double().norm())


def gaps(prog: dict, ref: dict, start: dict, detail: dict | None = None
         ) -> list:
    """The first step's loss gap |l - l_ref| / |l_ref|, and leaf by leaf
    the gap of the first gradient's norm and of the change's norm from
    the reference's, over the larger of the reference leaf's norm and the
    median leaf's; the change over the leaves whose reference gradient is
    at least STILL_LEAF of the median leaf's. The later steps' losses are
    not compared: Adam's first update moves every element by about the
    learning rate whatever its gradient's size, so elements whose gradient
    is round-off move apart between any two fp32 runs and the later
    losses part by more than a lower precision's first loss does."""
    loss1_gap = abs(prog["losses"][0] - ref["losses"][0]) \
        / abs(ref["losses"][0])
    names = list(ref["grad1"])
    g_ref = {n: _norm(ref["grad1"][n]) for n in names}
    g_med = float(np.median(list(g_ref.values())))
    g_gaps = {n: abs(_norm(prog["grad1"][n]) - g_ref[n])
              / max(g_ref[n], g_med) for n in names}
    moved = [n for n in names if g_ref[n] >= STILL_LEAF * g_med]
    d_ref = {n: _norm(ref["params"][n] - start[n]) for n in moved}
    d_med = float(np.median(list(d_ref.values())))
    c_gaps = {n: abs(_norm(prog["params"][n] - start[n]) - d_ref[n])
              / max(d_ref[n], d_med) for n in moved}
    if detail is not None:
        def diff(a, b):
            return _norm(a - b) / max(_norm(b), 1e-30)

        g_diff = [diff(prog["grad1"][n], ref["grad1"][n]) for n in names]
        detail.update({
            "step_loss_gaps": [abs(a - b) / abs(b) for a, b in
                               zip(prog["losses"], ref["losses"])],
            "grad_gap_leaf": max(g_gaps, key=g_gaps.get),
            "change_gap_leaf": max(c_gaps, key=c_gaps.get),
            "grad_diff_median_leaf": float(np.median(g_diff)),
            "still_leaves": sorted(set(names) - set(moved))})
    return [("loss1_gap", loss1_gap), ("grad_gap", max(g_gaps.values())),
            ("change_gap", max(c_gaps.values()))]
