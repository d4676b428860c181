"""FullSubNet's operations and bytes.

`model_flops`: the reference's FLOPs a call (enhance) or a step (train:
the forward and the backward to every trained weight), counted on the
meta device. `lstm_layers`: the four LSTM layer calls of one enhance
call, (rows, frames, In, H): the full band on B rows, the sub band on
B F rows, each over T + look-ahead frames. A layer call computes 2 rows
T (In + H) 4H FLOPs and moves x, the weights and bias, y and the final
carries once (fp32), whichever kernel runs it."""

from __future__ import annotations

from port_bench.flops.common import counted, least_seconds, meta_state

F32 = 4


def frames(cfg: dict, samples: int) -> int:
    return 1 + samples // cfg["stft"]["hop"]


def lstm_layers(cfg: dict, batch: int, samples: int) -> list:
    m = cfg["model"]
    t = frames(cfg, samples) + m["look_ahead"]
    f = m["num_freqs"]
    sb_in = 2 * m["sb_num_neighbors"] + 1 + 2 * m["fb_num_neighbors"] + 1
    fb, sb = m["fb_hidden"], m["sb_hidden"]
    return [(batch, t, f, fb), (batch, t, fb, fb),
            (batch * f, t, sb_in, sb), (batch * f, t, sb, sb)]


def layer_flops(rows: int, t: int, n_in: int, h: int) -> float:
    return 2.0 * rows * t * (n_in + h) * 4 * h


def layer_bytes(rows: int, t: int, n_in: int, h: int) -> float:
    return F32 * (rows * t * n_in + (n_in + h) * 4 * h + 4 * h
                  + rows * t * h + 2 * rows * h)


def rooflines(cfg: dict, shape: dict, peak_flops: float,
              peak_bytes: float) -> dict:
    """layer -> the least seconds its calls in one enhance call take."""
    layers = lstm_layers(cfg, shape["batch"], shape["samples"])
    return {"lstm": sum(least_seconds(layer_flops(*c), layer_bytes(*c),
                                      peak_flops, peak_bytes)
                        for c in layers)}


def model_flops(mode: str, cfg: dict, sd: dict, shape: dict) -> float:
    import torch

    from port_bench.reference import fullsubnet as ref

    state = meta_state(sd)
    b, n = shape["batch"], shape["samples"]
    if mode == "enhance":
        wav = torch.empty(b, n, device="meta")
        return counted(ref.enhance, state, wav, cfg)
    batch = {"mix": torch.empty(b, n, device="meta"),
             "clean": torch.empty(b, n, device="meta"),
             "frames": torch.full((b,), frames(cfg, n), device="meta")}
    names = [k for k in state if ref.trainable(k)]
    params = {k: v.requires_grad_(ref.trainable(k)) for k, v in state.items()}

    def step():
        value = ref.loss(params, batch, cfg)
        torch.autograd.grad(value, [params[k] for k in names])

    return counted(step)
