"""Enhance cells: closed-loop calls of the port's decode entry,
`se_tpu_torch.eval.enhance.enhance_waveform`, on (B, N) float32 numpy
batches from a pool made at set-up, back to back.

`correct` compares the returned waveforms of a sample of the window's
calls, drawn from the seed (a reservoir over every call), utterance by
utterance with the plain reference: ||est - ref|| / ||ref||, the worst
utterance against the cell's limit.
"""

from __future__ import annotations

import math

import numpy as np

from port_bench import harness
from port_bench.reference.common import FP32, Precision


class Program:
    def __init__(self, cell: harness.Cell, seed: int, device):
        import torch

        import se_tpu_torch.models  # noqa: F401  (registers the families)
        from se_tpu_torch.models.registry import get_model

        cfg, tr = cell.config, cell.traffic
        self.cell, self.device = cell, device
        self.family = cfg["family"]
        gen = harness.generator(seed, device)
        self.model = get_model(self.family).make(**cfg["model"],
                                                 device=device)
        self.sd = harness.seeded_state(self.model, gen, device)
        self.model.load_state_dict(self.sd)
        n = round(tr["utterance_s"] * cfg["sample_rate"])
        pool = torch.randn((tr["pool"], tr["batch"], n), generator=gen,
                           device=device).mul_(tr["level"])
        self.pool = pool.cpu().numpy()
        self.items_per_call = tr["batch"] * n / cfg["sample_rate"]
        self.shape = {"batch": tr["batch"], "samples": n}
        self.kept: list = []
        self.rng = np.random.default_rng(harness.torch_seed(seed))
        for _ in range(tr["warmup_calls"]):
            self._enhance(self.pool[0])

    def _enhance(self, x: np.ndarray) -> np.ndarray:
        from se_tpu_torch.eval import enhance

        return enhance.enhance_waveform(self.family, self.model, x,
                                        device=self.device)

    def call(self, i: int) -> bool:
        out = self._enhance(self.pool[i % len(self.pool)])
        size = self.cell.traffic["check_calls"]
        if len(self.kept) < size:
            self.kept.append((i, out))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < size:
                self.kept[j] = (i, out)
        return bool(np.isfinite(out).all())

    def free(self) -> None:
        """Drop the program's model (its packs and caches with it)."""
        self.model = None

    def reference(self, i: int, p: Precision = FP32) -> np.ndarray:
        """The reference's output for call i's batch, in blocks of rows."""
        import torch

        ref = self.cell.reference()
        x = torch.from_numpy(self.pool[i % len(self.pool)])
        step = self.cell.traffic["ref_block"]
        with torch.no_grad():
            return np.concatenate([
                ref.enhance(self.sd, x[a:a + step].to(self.device),
                            self.cell.config, p).cpu().numpy()
                for a in range(0, x.shape[0], step)])

    def compare(self, outputs: list | None = None,
                detail: dict | None = None) -> list:
        """[(number, value)]: the worst call's relative error of
        `outputs` ((call, waveforms) pairs; by default the kept ones)
        against the reference, ||est - ref|| / ||ref|| over the call's
        batch."""
        worst, utt = 0.0, []
        for i, out in self.kept if outputs is None else outputs:
            ref = self.reference(i).astype(np.float64)
            diff = out.astype(np.float64) - ref
            rel = float(np.linalg.norm(diff) / max(np.linalg.norm(ref),
                                                    1e-30))
            worst = max(worst, rel if math.isfinite(rel) else math.inf)
            utt += list(np.linalg.norm(diff, axis=-1)
                        / np.maximum(np.linalg.norm(ref, axis=-1), 1e-30))
        if detail is not None:
            detail.update({"utterance_rel_err_max": float(np.max(utt)),
                           "utterance_rel_err_median":
                               float(np.median(utt))})
        return [("worst_call_rel_err", worst)]
