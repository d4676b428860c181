"""Package rules of se_tpu_torch: it imports nothing of JAX or se_tpu, its
entry points run on the card unless asked for the CPU, and what it has not
ported says so."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from se_tpu_torch.eval import enhance
from se_tpu_torch.models import get_model
from se_tpu_torch.models.registry import ModelEntry
from se_tpu_torch.models.uformer import Uformer
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
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
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
    entry = ModelEntry("fullsubnet", make=None, stft=PRESET_320,
                       io_kind="cirm")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        enhance._enhance(entry, None, torch.zeros(1, 1600), 1600)


def test_registry_holds_uformer():
    entry = get_model("uformer")
    assert entry.io_kind == "waveform" and entry.make is Uformer
    with pytest.raises(KeyError, match="uformer"):
        get_model("dccrn")
