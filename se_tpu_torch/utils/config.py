"""Typed configuration system with per-model presets.
A copy of se_tpu/utils/config.py: `get_model` from the port's registry,
and a family's constructor arguments read from its signature (the port's
models are torch modules, not dataclasses).

Replaces the reference's flat per-model `config.py` modules and argparse
blocks (ref SURVEY.md §5 "Config / flag system") with one dataclass carrying
exactly the knobs the reference exposes: front-end win/fft/hop, compression
exponent, dataset paths/manifests, batch, epochs, lr, loss type, masking
mode, norm variant (instance vs cumulative), causality.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
from typing import Any

from se_tpu_torch.models.registry import get_model


@dataclasses.dataclass
class ExperimentConfig:
    model: str = "gcrn"
    variant: str | None = None          # e.g. "cln"/"in", "snr", "cprs"
    # front-end (defaults come from the model's registry preset)
    win_size: int | None = None
    win_shift: int | None = None
    fft_num: int | None = None
    compressed: bool = True             # mag**0.5 regime
    # data (ref LSTM/config.py:8-9 json_dir/file_path)
    json_dir: str = ""
    file_path: str = ""
    dataset: str = "vb"                 # "vb" | "wsj"
    chunk_length: int = 8 * 16000       # ref Uformer/config.py:7
    fs: int = 16000
    # training (ref LSTM/config.py:11-13)
    batch_size: int = 16
    epochs: int = 50
    lr: float = 1e-3
    loss: str = "default"
    # model knobs
    masking_mode: str = "E"             # DCCRN E/C/R
    norm: str = "cln"                   # cln | in
    is_causal: bool = True
    model_kwargs: dict = dataclasses.field(default_factory=dict)
    # outputs (ref LSTM/config.py:10,14-15)
    loss_dir: str = "./LOSS"
    check_point_path: str = "./CP_dir"
    model_best_path: str = "./BEST_MODEL"

    def __post_init__(self):
        entry = get_model(self.model)
        stft = entry.stft
        if self.win_size is None:
            self.win_size = stft.win_length
        if self.win_shift is None:
            self.win_shift = stft.hop
        if self.fft_num is None:
            self.fft_num = stft.fft

    def resolved_model_kwargs(self) -> dict[str, Any]:
        kw = dict(self.model_kwargs)
        entry = get_model(self.model)
        if "norm" in inspect.signature(entry.make).parameters and \
                "norm" not in kw:
            kw["norm"] = self.norm
        if self.model == "dccrn":
            kw.setdefault("masking_mode", self.masking_mode)
            if self.variant == "snr":
                kw.setdefault("snr_variant", True)
        if self.model == "uformer" and self.variant == "cprs":
            kw.setdefault("compressed", True)
        return kw

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls(**json.load(f))


# Presets mirroring each reference config.py (BASELINE.md Table D).
PRESETS: dict[str, ExperimentConfig] = {}


def register_preset(name: str, **kw) -> None:
    PRESETS[name] = ExperimentConfig(**kw)


for _name in ("lstm", "crn", "gcrn", "dpcrn", "ctsnet", "g2net", "taylorsenet"):
    register_preset(_name, model=_name)
register_preset("fullsubnet", model="fullsubnet")
register_preset("dccrn", model="dccrn", batch_size=16)      # DCCRN/config.py:21
register_preset("dccrn_snr", model="dccrn", variant="snr")
register_preset("uformer", model="uformer", variant="cprs")
register_preset("ctsnet_in", model="ctsnet", norm="in")
register_preset("g2net_in", model="g2net", norm="in")
register_preset("taylorsenet_in", model="taylorsenet", norm="in")
register_preset("deepxi", model="deepxi", compressed=False)


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return dataclasses.replace(PRESETS[name])
