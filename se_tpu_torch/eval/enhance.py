"""Enhancement (decode) entry point: the port of se_tpu/eval/enhance.py for
io-kinds "waveform" (Uformer: STFT, network and iSTFT in the model),
"mag_mask" (LSTM, CRN: magnitude in, magnitude out, noisy phase reused),
"complex_map" (GCRN, DCCRN, CTSNet, TaylorSENet, G2Net: complex spectrum
in and out; G2Net's stages stacked first, the last taken), "complex_mask"
(DPCRN: its mask applied inside the model) and "cirm" (FullSubNet:
magnitude in, complex ratio mask out).

Per-utterance RMS gain c = sqrt(n / energy) is applied before the model and
removed after it (for G2Net the other way round, as its reference does).
Every spectral branch takes its STFT from `ops.stft_fused.stft_auto`: the
fused CUDA kernel on the card. The "hybrid" io-kind (DeepXi) has no branch
here, as in se_tpu: it decodes through `models.deepxi.enhance` (and
`models.deepxi_driver.DeepXiDriver.infer_dir`), with no RMS gain.

`dtype=torch.bfloat16` runs the network in bf16 with se_tpu's casts
(se_tpu/eval/enhance.py `_enhance_jit`): every floating parameter and
buffer rounded to bf16 (BN statistics too), in a copy of the caller's
module made once and kept until a weight changes (`bf16_model`). Uformer
takes its waveform in bf16 and its graph stays bf16 (its four kernels'
bf16 variants on the card); its estimate comes back fp32. The spectral
branches keep the STFT, the magnitude and the phase in fp32 and round the
magnitude to bf16. The magnitude families (LSTMNet, CRN, FullSubNet) take
it in bf16, and each layer computes in its input's and weights' promoted
dtype (`ops._dtype.promoted`), as flax's do: bf16 until an LSTM, whose
output is fp32. A complex spectrum built from the bf16 magnitude and the
fp32 phase is fp32 (JAX and torch promote alike), so the complex families
(GCRN, DCCRN, DPCRN, CTSNet, TaylorSENet, G2Net) run fp32 arithmetic on
bf16-rounded weights, as flax promotes its bf16 parameters to an fp32
input. Every LSTM keeps bf16 weights, whatever its input: they pick the
LSTM kernels' bf16 variants, which round h to bf16 for the recurrent
product as se_tpu's `h.astype(wh.dtype)` does (ops/lstm.py). Ten
families run in bf16 (`ModelEntry.bf16`); DeepXi raises (`BF16_TODO`).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F

from se_tpu_torch.device import resolve_device, weight_key
from se_tpu_torch.models.registry import ModelEntry, get_model
from se_tpu_torch.nn.recurrent import LSTM
from se_tpu_torch.ops.stft import istft
from se_tpu_torch.ops.stft_fused import stft_auto
from se_tpu_torch.parallel.collectives import all_gather_rows
from se_tpu_torch.parallel.mesh import (
    activation_mesh, check_replicated, shard_batch,
)
from se_tpu_torch.utils.profiling import span

# why a family whose entry has no `bf16` (DeepXi, the hybrid io-kind)
# decodes in fp32 only: se_tpu's has no bf16 decode to port
BF16_TODO = ("se_tpu's DeepXi `enhance` takes no dtype "
             "(se_tpu/models/deepxi.py:611): DeepXi decodes in fp32")


def model_device(model: torch.nn.Module, device=None) -> torch.device:
    """The device a decode of `model` runs on: `device` (None means the
    card; raises when CUDA is absent), which must hold the weights."""
    dev = resolve_device(device)
    wdev = next(model.parameters()).device
    if wdev.type != dev.type or (dev.index is not None and wdev != dev):
        raise ValueError(f"model weights are on {wdev}, asked to run on {dev}")
    return dev


def _magphase(re, im):
    return torch.sqrt(re * re + im * im), torch.atan2(im, re)


def _spectral(entry: ModelEntry, model: torch.nn.Module, wav: torch.Tensor,
              length: int, compressed: bool, dtype=None) -> torch.Tensor:
    """The spectral branches of se_tpu's `_enhance_jit`: STFT, the
    (compressed) magnitude and phase, the model, decompression, iSTFT;
    with `dtype` the magnitude rounded to it, the phase fp32, the model's
    output widened to fp32."""
    cfg, kind = entry.stft, entry.io_kind
    mag, phase = _magphase(*stft_auto(wav, cfg))
    if compressed:
        mag = mag ** 0.5
    if dtype is not None:
        mag = mag.to(dtype)

    if kind == "mag_mask":  # the estimate is a magnitude: noisy phase
        est = model(mag)
        if compressed:
            est = est ** 2
        est = _widen(est, dtype)
        out_re, out_im = est * torch.cos(phase), est * torch.sin(phase)
    elif kind in ("complex_map", "complex_mask"):
        spec = torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)],
                           dim=-1)
        est = model(spec)
        if est.ndim == 5:  # multi-stage (G2Net): the last stage
            est = est[-1]
        est = _widen(est, dtype)
        est_mag, est_phase = _magphase(est[..., 0], est[..., 1])
        if compressed:
            est_mag = est_mag ** 2
        out_re = est_mag * torch.cos(est_phase)
        out_im = est_mag * torch.sin(est_phase)
    else:  # cirm: the mask multiplies the (compressed) complex feature
        feat_re = _widen(mag, dtype) * torch.cos(phase)
        feat_im = _widen(mag, dtype) * torch.sin(phase)
        mask = _widen(model(mag), dtype)
        m_re, m_im = mask[..., 0], mask[..., 1]
        out_re = m_re * feat_re - m_im * feat_im
        out_im = m_re * feat_im + m_im * feat_re
        if compressed:
            est_mag, est_phase = _magphase(out_re, out_im)
            est_mag = est_mag ** 2
            out_re = est_mag * torch.cos(est_phase)
            out_im = est_mag * torch.sin(est_phase)
    return istft(out_re, out_im, cfg, length=length)


def _widen(x: torch.Tensor, dtype) -> torch.Tensor:
    """x in fp32 after a bf16 network (`dtype` not None), else as it is."""
    return x if dtype is None else x.float()


def compute_dtype(entry: ModelEntry, dtype) -> torch.dtype | None:
    """The network dtype of an enhance call: None for fp32 (None or
    torch.float32), torch.bfloat16 for a family whose entry has `bf16`;
    raise for any other family or dtype before any work is done."""
    if dtype is None or dtype == torch.float32:
        return None
    if dtype != torch.bfloat16:
        raise ValueError(f"enhance runs in float32 or bfloat16, got {dtype}")
    if not entry.bf16:
        raise NotImplementedError(
            f"{entry.name}: no bf16 enhance yet: {BF16_TODO}")
    return dtype


def _store_dtype(entry: ModelEntry) -> torch.dtype:
    """The dtype the bf16-rounded weights are kept in, but for the LSTMs'
    (bf16 always: `bf16_model`): that of the model's input, to which flax
    promotes them (bf16 for Uformer's waveform and a magnitude input, fp32
    for a complex spectrum)."""
    return torch.float32 if entry.io_kind in ("complex_map",
                                              "complex_mask") \
        else torch.bfloat16


def bf16_model(entry: ModelEntry, model: torch.nn.Module) -> torch.nn.Module:
    """A copy of `model` with every floating parameter and buffer rounded
    to bf16 (kept in `_store_dtype`; an LSTM's in bf16, whose dtype picks
    its kernels' bf16 variants), made once and kept on `model` until one
    of its weights moves or changes in place; `model` is not touched. The
    copy starts with no kernel packs (they are made for its own
    weights)."""
    store = _store_dtype(entry)
    key = (store, weight_key([model]))
    hit = model.__dict__.pop("_bf16_copy", None)  # not copied into the copy
    if hit is not None and hit[0] == key:
        model.__dict__["_bf16_copy"] = hit
        return hit[1]
    memo = {id(mod.__dict__["_weight_cache"]): {}  # fp32 packs stay behind
            for mod in model.modules() if "_weight_cache" in mod.__dict__}
    twin = copy.deepcopy(model, memo).to(torch.bfloat16).to(store).eval()
    for mod in twin.modules():
        if isinstance(mod, LSTM):
            mod.to(torch.bfloat16)
    model.__dict__["_bf16_copy"] = (key, twin)
    return twin


@torch.no_grad()
def _enhance(entry: ModelEntry, model: torch.nn.Module, wav: torch.Tensor,
             length: int, compressed: bool = True,
             dtype=None) -> torch.Tensor:
    """se_tpu's `_enhance_jit` for the ported io-kinds: fp32, or with
    `dtype` (torch.bfloat16) its casts around `model`, whose weights are
    already rounded (`bf16_model`). Returns fp32."""
    if entry.io_kind in ("mag_mask", "complex_map", "complex_mask", "cirm"):
        return _spectral(entry, model, wav, length, compressed, dtype)
    if entry.io_kind != "waveform":  # "hybrid"; se_tpu raises alike
        raise ValueError(f"io kind {entry.io_kind!r} needs a dedicated "
                         "driver (DeepXi's: models.deepxi.enhance)")
    if dtype is not None:
        wav = wav.to(dtype)
    est, _, _, _ = model(wav, wav)
    est = _widen(est, dtype)
    pad = length - est.shape[-1]
    if pad > 0:
        est = F.pad(est, (0, pad))
    return est[..., :length]


def enhance_waveform(name: str, model: torch.nn.Module, wav: np.ndarray,
                     compressed: bool = True, device=None,
                     dtype=None, mesh=None) -> np.ndarray:
    """Enhance a batch (B, N) or one (N,) waveform with `model`, a module
    of family `name` whose weights already live on `device` (None means the
    card; raises when CUDA is absent). `compressed` selects the mag**0.5
    regime of the spectral io-kinds; Uformer ignores it (its regime is a
    constructor argument). `dtype`: None or torch.float32 (fp32), or
    torch.bfloat16 for a family whose entry has `bf16` (se_tpu's bf16 decode;
    the caller's module keeps its fp32 weights). Returns float32 numpy of
    the input shape.

    `mesh`: a `parallel.make_mesh` over torch.distributed ranks, every
    rank calling with the same batch and a module whose weights it checks
    equal to rank 0's (`parallel.check_replicated`). The batch is padded
    with zero rows to a multiple of the "data" size, each rank enhances
    its contiguous rows on its own device (a "model" axis above 1 splits
    each kernel's rows over the model group: `parallel.map_leading`), and
    the rows are gathered to every rank and trimmed: every rank returns
    what one device returns
    for the whole batch (se_tpu/eval/enhance.py's mesh path; tests hold
    it to the one-process decode and to se_tpu's).

    Spans (utils/profiling.py): `enhance` around the whole, holding
    `enhance.gain`, `enhance.h2d`, `enhance.model` (`_enhance`; under
    `mesh` also the gather), `enhance.d2h` and `enhance.ungain` in that
    order."""
    with span("enhance"):
        entry = get_model(name)
        dtype = compute_dtype(entry, dtype)
        dev = model_device(model, device)
        single = wav.ndim == 1
        x = np.atleast_2d(np.asarray(wav, np.float32))
        n = x.shape[-1]

        # per-utterance RMS gain; a family may invert it
        # (entry.inverted_gain)
        with span("enhance.gain"):
            energy = np.sum(np.square(x), axis=-1, keepdims=True)
            c = np.sqrt(n / np.maximum(energy, 1e-12)).astype(np.float32)
            inverted = entry.inverted_gain
            x_in = x / c if inverted else x * c
        model.eval()
        net = model if dtype is None else bf16_model(entry, model)
        rows = x_in
        if mesh is not None:
            check_replicated(model, mesh)
            pad = (-x_in.shape[0]) % mesh.data
            rows = shard_batch(np.pad(x_in, ((0, pad), (0, 0))), mesh)
        with span("enhance.h2d"):
            rows = torch.from_numpy(rows).to(dev)
        with span("enhance.model"):
            if mesh is None:
                est = _enhance(entry, net, rows, n, compressed, dtype)
            else:
                with activation_mesh(mesh):  # the kernels split over "model"
                    est = _enhance(entry, net, rows, n, compressed, dtype)
                est = all_gather_rows(est, mesh)[:x_in.shape[0]]
        with span("enhance.d2h"):
            est = est.cpu().numpy()
        with span("enhance.ungain"):
            est = est * c if inverted else est / c
            return est[0] if single else est
