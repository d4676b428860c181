"""Uformer's operations and bytes.

`model_flops`: the reference's FLOPs an enhance call, counted on the meta
device. `unet_levels`: the twelve U-net levels of a call as (kind, rows
T, F_in, F_out, per-component input channels, output channels): an
encoder level's (5, 2) conv, stride 2 along F, from F_in to F_in / 2; a
decoder level's transposed conv from F_in to 2 F_in, on [skip, x]. Each
level runs its complex branch (a complex conv: four real ones) and its
real branch: 2 B T F 10 (4 Cin Cout + Cin Cout) FLOPs, F the output's
width for a conv and the input's for a transposed conv. Bytes: both
branches' inputs, weights and outputs once (fp32)."""

from __future__ import annotations

from port_bench.flops.common import counted, least_seconds, meta_state

F32 = 4
TAPS = 10  # (5, 2)


def frames(cfg: dict, samples: int) -> int:
    return 1 + samples // cfg["stft"]["hop"]


def unet_levels(cfg: dict, batch: int, samples: int) -> list:
    ch = cfg["channels"]
    f0 = cfg["stft"]["n_fft"] // 2  # the DC bin stripped
    rows = batch * frames(cfg, samples)
    out = []
    for i in range(len(ch) - 1):
        f_in = f0 >> i
        out.append(("encoder", rows, f_in, f_in // 2, ch[i], ch[i + 1]))
    deep = len(ch) - 1
    for i in range(deep):
        f_in = f0 >> (deep - i)
        out.append(("decoder", rows, f_in, 2 * f_in, 2 * ch[deep - i],
                    ch[deep - 1 - i]))
    return out


def level_flops(kind, rows, f_in, f_out, cin, cout) -> float:
    width = f_out if kind == "encoder" else f_in
    return 2.0 * rows * width * TAPS * 5 * cin * cout


def level_bytes(kind, rows, f_in, f_out, cin, cout) -> float:
    weights = TAPS * 5 * cin * cout + 3 * 4 * cout
    return F32 * (rows * f_in * 3 * cin + weights + rows * f_out * 3 * cout)


def rooflines(cfg: dict, shape: dict, peak_flops: float,
              peak_bytes: float) -> dict:
    levels = unet_levels(cfg, shape["batch"], shape["samples"])
    return {"unet": sum(least_seconds(level_flops(*lv), level_bytes(*lv),
                                      peak_flops, peak_bytes)
                        for lv in levels)}


def model_flops(mode: str, cfg: dict, sd: dict, shape: dict) -> float:
    import torch

    from port_bench.reference import uformer as ref

    if mode != "enhance":
        raise ValueError(f"no {mode} count for Uformer")
    wav = torch.empty(shape["batch"], shape["samples"], device="meta")
    return counted(ref.enhance, meta_state(sd), wav, cfg)
