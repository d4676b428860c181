"""Package rules of se_tpu_torch: it imports nothing of JAX or se_tpu, its
entry points run on the card unless asked for the CPU, and what it has not
ported says so."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from se_tpu_torch.eval import enhance
from se_tpu_torch.models import available_models, get_model
from se_tpu_torch.models.dccrn import DCCRN
from se_tpu_torch.models.fullsubnet import FullSubNet
from se_tpu_torch.models.registry import ModelEntry
from se_tpu_torch.models.uformer import Uformer
from se_tpu_torch.nn import LSTM
from se_tpu_torch.ops.stft import PRESET_320

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "se_tpu"}


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax_flax_or_se_tpu():
    files = sorted((ROOT / "se_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "lstm_dispatch_sweep.py",
              ROOT / "lstm_bf16_sweep.py", ROOT / "bf16_ring_sweep.py",
              ROOT / "kernel_digest.py",
              ROOT / "tests" / "torch_parallel_worker.py",
              ROOT / "parallel_cards.py"]
    assert len(files) > 10
    pkg = ROOT / "se_tpu_torch"
    for new in ("train/losses.py", "train/trainer.py", "train/checkpoint.py",
                "data/wav.py", "data/dataset.py", "ops/_autograd.py",
                "models/ctsnet.py", "models/taylorsenet.py",
                "models/g2net.py", "models/tcm_parts.py", "models/deepxi.py",
                "models/deepxi_inp_tgt.py", "models/deepxi_driver.py",
                "eval/gains.py", "eval/metrics.py", "ops/stdct.py",
                "eval/streaming.py", "eval/pesq.py", "eval/composite.py",
                "eval/hasqi.py", "utils/config.py", "utils/profiling.py",
                "cli.py", "__main__.py", "parallel/mesh.py",
                "parallel/collectives.py", "ops/features.py", "ops/mel.py",
                "runtime/native.py"):
        assert pkg / new in files, new
    for path in files:
        bad = _imported_roots(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Uformer()
    model = Uformer(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        enhance.enhance_waveform("uformer", model,
                                 np.zeros(1600, np.float32))


def test_enhance_refuses_weights_on_another_device():
    model = Uformer(device="meta")
    with pytest.raises(ValueError, match="meta"):
        enhance.enhance_waveform("uformer", model,
                                 np.zeros(1600, np.float32), device="cpu")


def test_unported_io_kind_names_its_roadmap_item():
    """The hybrid io-kind (DeepXi) has no branch in the decode driver, as
    in se_tpu: it raises and names the function that decodes DeepXi."""
    entry = ModelEntry("deepxi", make=None, stft=PRESET_320,
                       io_kind="hybrid")
    with pytest.raises(ValueError, match="models.deepxi.enhance"):
        enhance._enhance(entry, None, torch.zeros(1, 1600), 1600)


def test_fullsubnet_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FullSubNet(fb_hidden=4, sb_hidden=4)
    model = FullSubNet(fb_hidden=4, sb_hidden=4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        enhance.enhance_waveform("fullsubnet", model,
                                 np.zeros(1600, np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        LSTM.zero_carry(1, 4, 1)


def test_registry_holds_uformer():
    entry = get_model("uformer")
    assert entry.io_kind == "waveform" and entry.make is Uformer
    assert available_models() == ["crn", "ctsnet", "dccrn", "deepxi",
                                  "dpcrn", "fullsubnet", "g2net", "gcrn",
                                  "lstm", "taylorsenet", "uformer"]
    with pytest.raises(KeyError, match="uformer"):
        get_model("no_such_model")
    assert not hasattr(enhance, "_NOT_PORTED")  # every io-kind is ported


def test_dccrn_entry_points_raise_without_cuda(monkeypatch):
    narrow = dict(kernel_num=(4, 4, 4, 4, 4, 4), rnn_units=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DCCRN(**narrow)
    model = DCCRN(**narrow, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        enhance.enhance_waveform("dccrn", model, np.zeros(1600, np.float32))


@pytest.mark.parametrize("name", ["crn", "dpcrn", "gcrn", "lstm"])
def test_recurrent_zoo_constructors_raise_without_cuda(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(name).make()


def test_trainer_runs_on_the_card_by_default(monkeypatch):
    from se_tpu_torch.train.trainer import TrainConfig, make_train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(TrainConfig(model="lstm",
                                    model_kwargs=dict(hidden=4)))
