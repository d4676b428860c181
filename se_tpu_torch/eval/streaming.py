"""Streaming and bounded-memory enhancement: the port of
se_tpu/eval/streaming.py.

1. `enhance_windowed`, for every family with an `enhance_waveform` branch:
   the utterance is cut into windows of left context + chunk + one frame,
   which run `max_batch` at a time through the offline decode (`_enhance`)
   with no carried state; each window keeps its chunk. Memory is bounded by
   the window, and the error by the models' memory against the context.

2. `CausalStreamer` (CRN, GCRN, DPCRN) and `LstmStreamer` (LSTMNet, the
   same scheme without replay): exact low-latency streaming. The model's
   LSTM state is carried from chunk to chunk (the models' `forward(x,
   carry=, split=)`); the analysis frames
   and the overlap-add synthesis are kept on the host in float64 numpy
   with librosa's center (reflect) padding at the stream's head and tail,
   so a stream reproduces the offline decode to float tolerance.
   Algorithmic latency: frame_len + chunk_frames * hop samples.

The streamers' analysis and synthesis are products with the windowed DFT
bases (`ops.stft._forward_basis`, `_inverse_basis`), as se_tpu computes
them outside any kernel; the models inside run the LSTM kernels on the
card. Every entry point takes the port's model where se_tpu takes its
variables, and runs where the model's weights live (`device`, None means
the card).
"""

from __future__ import annotations

import numpy as np
import torch

from se_tpu_torch.eval.enhance import (
    _enhance, _magphase, bf16_model, compute_dtype, enhance_waveform,
    model_device,
)
from se_tpu_torch.models.registry import get_model
from se_tpu_torch.ops.stft import StftConfig, _const, _padded_window


# --------------------------------------------------------- windowed (zoo-wide)

def enhance_windowed(name: str, model: torch.nn.Module, wav: np.ndarray,
                     chunk_seconds: float = 4.0, context_seconds: float = 2.0,
                     sr: int = 16000, compressed: bool = True, dtype=None,
                     max_batch: int = 16, device=None) -> np.ndarray:
    """Enhance one (N,) waveform in bounded memory with `model` (family
    `name`, weights on `device`; None means the card).

    Windows of `context + chunk + right` samples advance by `chunk`;
    outputs keep the `chunk` after the context. The right context covers
    the iSTFT's edge (one STFT frame). The windows are independent and run
    `max_batch` at a time; the tail batch is padded with silent windows to
    `max_batch`, as se_tpu keeps one compiled shape. `dtype`:
    enhance_waveform's (torch.bfloat16 for the families whose entry has
    `bf16`: the windows run the model's bf16 copy, `bf16_model`)."""
    entry = get_model(name)
    dtype = compute_dtype(entry, dtype)
    dev = model_device(model, device)
    x = np.asarray(wav, np.float32)
    n = x.shape[-1]
    chunk = int(chunk_seconds * sr)
    left = int(context_seconds * sr)
    right = entry.stft.frame_len

    # per-utterance RMS gain as in the offline decode
    c = np.sqrt(n / np.maximum(np.sum(np.square(x)), 1e-12)).astype(np.float32)
    inverted = entry.inverted_gain
    x_in = x / c if inverted else x * c

    n_windows = -(-n // chunk)
    xp = np.zeros(left + n_windows * chunk + right, np.float32)
    xp[left:left + n] = x_in
    win_len = left + chunk + right
    windows = np.stack([xp[s:s + win_len]
                        for s in np.arange(n_windows) * chunk])

    model.eval()
    net = model if dtype is None else bf16_model(entry, model)
    outs = []
    for i in range(0, n_windows, max_batch):
        batch = windows[i:i + max_batch]
        real = batch.shape[0]
        batch = np.pad(batch, ((0, max_batch - real), (0, 0)))
        est = _enhance(entry, net, torch.from_numpy(batch).to(dev),
                       win_len, compressed, dtype)
        outs.append(est[:real, left:left + chunk].cpu().numpy())
    out = np.concatenate(outs, axis=0).reshape(-1)[:n]
    return out * c if inverted else out / c


# ------------------------------------------------------------ exact streaming

def _analysis(cfg: StftConfig, samples: torch.Tensor, n_frames: int):
    """((n_frames - 1) * hop + frame_len,) samples -> the (n_frames, F)
    magnitude and phase of their frames."""
    frames = samples.unfold(0, cfg.frame_len, cfg.hop)[:n_frames]
    spec = torch.matmul(frames, _const("forward", cfg, samples.device))
    return _magphase(spec[:, :cfg.bins], spec[:, cfg.bins:])


def _synthesis(cfg: StftConfig, re: torch.Tensor, im: torch.Tensor):
    """(k, F) spectrum -> (k, frame_len) synthesis frames (windowed, before
    the overlap-add and the envelope)."""
    return torch.matmul(torch.cat([re, im], dim=-1),
                        _const("inverse", cfg, re.device))


@torch.no_grad()
def _causal_stream_step(model, cfg: StftConfig, samples: torch.Tensor, carry,
                        n_frames: int, split: int, k_out: int,
                        compressed: bool, kind: str):
    """`samples` ((n_frames - 1) * hop + frame_len,) -> (k_out, frame_len)
    synthesis frames of the LAST k_out window positions, and the carry
    checkpointed after `split` frames (CausalStreamer's left-context
    replay)."""
    mag, phase = _analysis(cfg, samples, n_frames)
    if compressed:
        mag = torch.sqrt(mag)
    if kind == "mag_mask":
        est, carry = model(mag[None], carry=carry, split=split)
        est_mag, est_phase = est[0], phase
    else:  # complex_map (GCRN) / complex_mask (DPCRN)
        feats = torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)],
                            dim=-1)
        est, carry = model(feats[None], carry=carry, split=split)
        est_mag, est_phase = _magphase(est[0, ..., 0], est[0, ..., 1])
    if compressed:
        est_mag = est_mag * est_mag
    re, im = est_mag * torch.cos(est_phase), est_mag * torch.sin(est_phase)
    return _synthesis(cfg, re[-k_out:], im[-k_out:]), carry


class CausalStreamer:
    """Exact streaming decode of the causal conv-recurrent families (crn,
    gcrn, dpcrn), with LEFT-CONTEXT REPLAY for their causal convs.

    Each chunk runs the model over [R history frames + k new frames]. The
    causal convs see R frames back (`model.replay_frames`: CRN and DPCRN
    10, GCRN 0), so their outputs at the k new positions are exact. The
    time-LSTMs carry their state exactly: the model's `split` checkpoints
    it after the window's first k frames, the state at the next window's
    start, while the replayed frames' LSTM outputs are recomputed from the
    previous checkpoint. The first chunk has no history: k frames, split
    k - R. The last chunk of a flush runs only the frames that remain.

    Host side, in absolute sample coordinates (head padding included):
    librosa's center (reflect) padding at the head and the tail, and the
    overlap-add with its squared-window envelope in float64. Reproduces the
    offline `enhance_waveform` to float tolerance; algorithmic latency
    frame_len + chunk_frames * hop (the replay adds compute, not latency).

    The offline decode's per-utterance RMS gain needs the whole
    utterance: pass `gain` where it is known, else it is estimated from
    the first samples and frozen (a deviation inherent to streaming)."""

    def __init__(self, name: str, model: torch.nn.Module,
                 compressed: bool = True, chunk_frames: int = 16,
                 gain: float | None = None, device=None):
        r = int(getattr(model, "replay_frames", 0))
        if chunk_frames < r:
            raise ValueError(f"chunk_frames must be >= replay_frames ({r})")
        entry = get_model(name)
        self.name, self.cfg, self.kind = name, entry.stft, entry.io_kind
        self.model = model.eval()
        self.device = model_device(model, device)
        self.compressed = compressed
        self.k, self.r = chunk_frames, r
        self.gain = gain
        self.carry = model.zero_carry(1, device=self.device)

        cfg = self.cfg
        self._lpad = cfg.fft // 2
        self._head = np.zeros(0, np.float32)  # raw samples before the start
        self._pending = np.zeros(0, np.float32)  # gained, head pad included
        self._pend_frame = 0      # frame index of _pending[0]
        self._started = False
        self._frame_pos = 0       # next frame index to produce
        self._n_in = 0            # raw samples received
        self._ola = np.zeros(0, np.float64)
        self._env = np.zeros(0, np.float64)
        self._ola_base = 0        # absolute coordinate of _ola[0]
        self._emitted = 0         # raw (cropped) samples already returned
        w = _padded_window(cfg)[:cfg.frame_len]
        self._wsq = (w * w).astype(np.float64)
        self._tail = np.zeros(0, np.float32)  # last lpad + 1 gained samples

    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed raw samples; returns whatever output is final."""
        if not self._take(samples):
            return np.zeros(0, np.float32)
        cfg = self.cfg
        out = []
        # frames [frame_pos, frame_pos + k) need samples up to `need`
        while ((self._frame_pos + self.k - 1) * cfg.hop + cfg.frame_len
               <= self._pend_frame * cfg.hop + len(self._pending)):
            self._run(self.k)
            # samples before the next frame's start are final
            out.append(self._emit(self._frame_pos * cfg.hop))
        return np.concatenate(out) if out else np.zeros(0, np.float32)

    def flush(self) -> np.ndarray:
        """Reflect-pad the tail, run the remaining frames of the offline
        decode's 1 + n // hop, return the rest."""
        if not self._started:
            # shorter than the head's padding: the stream never got going,
            # the offline decode takes it whole
            if len(self._head) == 0:
                return np.zeros(0, np.float32)
            return enhance_waveform(self.name, self.model, self._head,
                                    compressed=self.compressed,
                                    device=self.device)
        # librosa center at the end: padded[lpad + n + i] = gained
        # x[n - 2 - i]
        t = self._tail
        refl = t[-2:-2 - self._lpad:-1] if len(t) >= 2 \
            else np.zeros(0, np.float32)
        if len(refl) < self._lpad:
            refl = np.pad(refl, (0, self._lpad - len(refl)))
        self._pending = np.concatenate([self._pending, refl])
        total = 1 + self._n_in // self.cfg.hop
        while self._frame_pos < total:
            self._run(min(self.k, total - self._frame_pos))
        return self._emit(self._lpad + self._n_in)

    def _take(self, samples: np.ndarray) -> bool:
        """Append raw `samples`; False while the stream has too few to
        start (the head's reflect padding needs lpad + 1). The gain, unless
        given, comes from the samples the stream starts with and stays."""
        samples = np.asarray(samples, np.float32)
        self._n_in += len(samples)
        if self._started:
            gained = samples * self.gain
            self._pending = np.concatenate([self._pending, gained])
            self._tail = np.concatenate(
                [self._tail, gained])[-(self._lpad + 1):]
            return True
        self._head = np.concatenate([self._head, samples])
        if len(self._head) < self._lpad + 1:
            return False
        if self.gain is None:
            e = np.sum(np.square(self._head))
            self.gain = float(np.sqrt(len(self._head) / max(e, 1e-12)))
        head = self._head * self.gain
        # librosa center: reflect-pad fft // 2 at the head
        self._pending = np.concatenate([head[1:self._lpad + 1][::-1], head])
        self._tail = head[-(self._lpad + 1):]
        self._started = True
        self._head = None
        return True

    def _run(self, k: int) -> None:
        """Produce frames [frame_pos, frame_pos + k) and keep the replay
        history: the pending samples from frame frame_pos - R on."""
        cfg = self.cfg
        first = self._frame_pos == 0
        start = 0 if first else self._frame_pos - self.r
        n_frames = k if first else self.r + k
        split = self.k - self.r if first else self.k
        lo = (start - self._pend_frame) * cfg.hop
        need = (n_frames - 1) * cfg.hop + cfg.frame_len
        chunk = self._pending[lo:lo + need]
        if len(chunk) < need:
            chunk = np.pad(chunk, (0, need - len(chunk)))
        synth, self.carry = _causal_stream_step(
            self.model, cfg, torch.from_numpy(chunk).to(self.device),
            self.carry, n_frames, split, k, self.compressed, self.kind)
        self._absorb(synth.cpu().numpy().astype(np.float64), self._frame_pos)
        self._frame_pos += k
        keep_from = max(0, self._frame_pos - self.r)
        drop = (keep_from - self._pend_frame) * cfg.hop
        if drop > 0:
            self._pending = self._pending[drop:]
            self._pend_frame = keep_from

    def _absorb(self, synth: np.ndarray, first_frame: int) -> None:
        """Overlap-add (k, frame_len) synthesis frames from `first_frame`
        and their squared-window envelope."""
        cfg = self.cfg
        k, flen = synth.shape
        lo = first_frame * cfg.hop
        hi = lo + (k - 1) * cfg.hop + flen
        grow = hi - (self._ola_base + len(self._ola))
        if grow > 0:
            self._ola = np.concatenate([self._ola, np.zeros(grow)])
            self._env = np.concatenate([self._env, np.zeros(grow)])
        for j in range(k):
            s = lo + j * cfg.hop - self._ola_base
            self._ola[s:s + flen] += synth[j]
            self._env[s:s + flen] += self._wsq

    def _emit(self, upto_abs: int) -> np.ndarray:
        """Finalize the samples in absolute coordinates [emitted + lpad,
        upto_abs): divided by the envelope and the gain."""
        start_abs = self._emitted + self._lpad
        if upto_abs <= start_abs:
            return np.zeros(0, np.float32)
        s = start_abs - self._ola_base
        e = upto_abs - self._ola_base
        seg, env = self._ola[s:e], self._env[s:e]
        out = np.where(env > 1e-11, seg / np.maximum(env, 1e-11), seg)
        self._ola, self._env = self._ola[e:], self._env[e:]
        self._ola_base = upto_abs
        self._emitted += len(out)
        return (out / self.gain).astype(np.float32)


class LstmStreamer(CausalStreamer):
    """Exact streaming decode of LSTMNet (`lstm`: magnitude in, the noisy
    phase out): reproduces `enhance_waveform("lstm", ...)` to float
    tolerance, the three LSTM layers' state carried across chunks of
    `chunk_frames` frames. LSTMNet has no conv to replay (its
    `replay_frames` is 0), so a chunk is its k new frames alone: se_tpu's
    LstmStreamer is the causal scheme without replay."""

    def __init__(self, model: torch.nn.Module, compressed: bool = True,
                 chunk_frames: int = 16, gain: float | None = None,
                 device=None):
        super().__init__("lstm", model, compressed, chunk_frames, gain,
                         device)
