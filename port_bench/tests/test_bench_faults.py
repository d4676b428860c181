"""A whole run on the CPU (the look for a chip skipped) with the timed
path broken underneath: `correct` comes out false for each fault the
cell can have, and true for the sound run. One chip: no exchange
between chips to leave out."""

import numpy as np
import pytest

from port_bench.tests._tiny import run_tiny


def test_bench_sound_runs_are_correct():
    for name in ("fullsubnet-enhance-b32", "fullsubnet-train-b32"):
        res, checks, _ = run_tiny(name)
        assert res["correct"], checks


@pytest.mark.parametrize("name", ["fullsubnet-enhance-b32",
                                  "uformer-enhance-b64"])
def test_bench_altered_answer_is_caught(name, monkeypatch):
    """One utterance of every call altered where it is produced."""
    from se_tpu_torch.eval import enhance

    orig = enhance.enhance_waveform

    def altered(*args, **kw):
        out = orig(*args, **kw)
        out[0] *= 1.01
        return out

    monkeypatch.setattr(enhance, "enhance_waveform", altered)
    res, checks, _ = run_tiny(name)
    assert not res["correct"], checks


def test_bench_unchanged_state_is_caught(monkeypatch):
    """A step that returns its state unchanged: no update at all."""
    from se_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "adam_update", lambda *a, **k: None)
    res, checks, _ = run_tiny("fullsubnet-train-b32")
    assert not res["correct"]
    assert dict((n, v) for n, v, _ in checks)["change_gap"] == \
        pytest.approx(1.0)


def test_bench_half_batch_is_caught(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from se_tpu_torch.train import losses

    orig = losses.com_mag_mse_loss

    def half(esti, label, frames):
        n = esti.shape[0] // 2
        return orig(esti[:n], label[:n], frames[:n])

    monkeypatch.setattr(losses, "com_mag_mse_loss", half)
    res, checks, _ = run_tiny("fullsubnet-train-b32")
    assert not res["correct"], checks


def test_bench_non_finite_output_fails(monkeypatch):
    from se_tpu_torch.eval import enhance

    orig = enhance.enhance_waveform

    def broken(*args, **kw):
        out = orig(*args, **kw)
        out[-1, -1] = np.nan
        return out

    monkeypatch.setattr(enhance, "enhance_waveform", broken)
    res, _, _ = run_tiny("fullsubnet-enhance-b32")
    assert not res["correct"] and res["failed"] == res["attempted"]
