"""se_tpu's {"params", "batch_stats"} trees (numpy or jax arrays, read as
numpy) -> entries of the port's state_dicts, one helper per layer kind.
The inverse of se_tpu/utils/torch_compat.py, so the port's state_dict
goes back through se_tpu's `from_reference_state_dict` to the same tree.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))  # a contiguous copy


def put_lstm(sd: dict, prefix: str, tree: dict) -> None:
    """se_tpu.nn.LSTM's l{k}[_rev]_{wx,wh,b} -> torch.nn.LSTM's names.
    se_tpu keeps one combined bias: it becomes `bias_ih`, `bias_hh` is 0."""
    for key in tree:
        if not key.endswith("_wx"):
            continue
        j_sfx = key[:-3]
        t_sfx = j_sfx.replace("_rev", "_reverse")
        sd[f"{prefix}.weight_ih_{t_sfx}"] = tensor(np.asarray(tree[key]).T)
        sd[f"{prefix}.weight_hh_{t_sfx}"] = tensor(
            np.asarray(tree[f"{j_sfx}_wh"]).T)
        bias = tensor(tree[f"{j_sfx}_b"])
        sd[f"{prefix}.bias_ih_{t_sfx}"] = bias
        sd[f"{prefix}.bias_hh_{t_sfx}"] = torch.zeros_like(bias)


def put_dense(sd: dict, prefix: str, tree: dict) -> None:
    sd[f"{prefix}.weight"] = tensor(np.asarray(tree["kernel"]).T)
    sd[f"{prefix}.bias"] = tensor(tree["bias"])


def put_conv(sd: dict, prefix: str, tree: dict, transpose: bool = False,
             freq_first: bool = False) -> None:
    """se_tpu's (kt, kf, I, O) kernel -> (O, I, ka, kb), or (I, O, ka, kb)
    for a transposed conv, with (ka, kb) = (kf, kt) when `freq_first`."""
    k = np.asarray(tree["kernel"])
    if freq_first:
        k = k.transpose(1, 0, 2, 3)
    sd[f"{prefix}.weight"] = tensor(k.transpose((2, 3, 0, 1) if transpose
                                                else (3, 2, 0, 1)))
    sd[f"{prefix}.bias"] = tensor(tree["bias"])


def put_batchnorm(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    sd[f"{prefix}.weight"] = tensor(params["bn"]["scale"])
    sd[f"{prefix}.bias"] = tensor(params["bn"]["bias"])
    sd[f"{prefix}.running_mean"] = tensor(stats["bn"]["mean"])
    sd[f"{prefix}.running_var"] = tensor(stats["bn"]["var"])


def put_layernorm(sd: dict, prefix: str, tree: dict) -> None:
    sd[f"{prefix}.weight"] = tensor(tree["scale"])
    sd[f"{prefix}.bias"] = tensor(tree["bias"])


def put_prelu(sd: dict, prefix: str, tree: dict) -> None:
    """flax nn.PReLU's scalar `negative_slope` -> torch.nn.PReLU's (1,)."""
    sd[f"{prefix}.weight"] = tensor(tree["negative_slope"]).reshape(1)


def put_channel_prelu(sd: dict, prefix: str, tree: dict) -> None:
    """se_tpu's own PReLU(channels): `weight` (C,), as torch.nn.PReLU(C)."""
    sd[f"{prefix}.weight"] = tensor(tree["weight"])


def put_tcm_norm(sd: dict, prefix: str, tree: dict, trailing: int) -> None:
    """se_tpu's CumulativeLayerNorm{1,2}d (`gain`, `bias` (C,)) -> the
    reference's (1, C) + (1,) * trailing; its InstanceNorm{1,2}d (`scale`,
    `bias`) -> torch's weight, bias (C,)."""
    if "gain" in tree:
        for key in ("gain", "bias"):
            sd[f"{prefix}.{key}"] = tensor(tree[key]).reshape(
                (1, -1) + (1,) * trailing)
    else:
        sd[f"{prefix}.weight"] = tensor(tree["scale"])
        sd[f"{prefix}.bias"] = tensor(tree["bias"])


def put_conv1d(sd: dict, prefix: str, tree: dict) -> None:
    """se_tpu's nn.Dense kernel (I, O) or CausalConv1d kernel (k, I, O) ->
    torch.nn.Conv1d's weight (O, I, k); the bias where it has one."""
    k = np.asarray(tree["kernel"])
    if k.ndim == 2:
        k = k[None]
    sd[f"{prefix}.weight"] = tensor(k.transpose(2, 1, 0))
    if "bias" in tree:
        sd[f"{prefix}.bias"] = tensor(tree["bias"])


def put_share_sep(sd: dict, prefix: str, tree: dict) -> None:
    """se_tpu's ShareSepConv `weight` (k,) -> the reference's (1, 1, k)."""
    sd[f"{prefix}.weight"] = tensor(tree["weight"]).reshape(1, 1, -1)


def put_flax_layernorm(sd: dict, prefix: str, tree: dict) -> None:
    """flax nn.LayerNorm's `scale` and `bias`, each where it has one ->
    `weight`, `bias` (C,) (OnePassLayerNorm's names)."""
    if "scale" in tree:
        sd[f"{prefix}.weight"] = tensor(tree["scale"])
    if "bias" in tree:
        sd[f"{prefix}.bias"] = tensor(tree["bias"])
