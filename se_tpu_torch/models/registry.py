"""Name -> (model constructor, STFT preset, io-kind) registry
(se_tpu/models/registry.py). io-kind "waveform" means waveform in,
waveform out, STFT in the graph."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from se_tpu_torch.ops.stft import StftConfig


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    make: Callable[..., Any]
    stft: StftConfig
    io_kind: str
    # JAX {"params", "batch_stats"} tree (numpy) -> the port's state_dict
    from_jax_variables: Callable[[dict], dict] | None = None
    variants: tuple[str, ...] = ()


_REGISTRY: dict[str, ModelEntry] = {}


def register(entry: ModelEntry) -> None:
    _REGISTRY[entry.name] = entry


def get_model(name: str) -> ModelEntry:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def available_models() -> list[str]:
    return sorted(_REGISTRY)
