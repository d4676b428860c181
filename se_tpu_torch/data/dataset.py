"""JSON-manifest dataset with bucketed padding and per-host sharding: a
copy of se_tpu/data/dataset.py (numpy only; the port imports nothing of
se_tpu), which `se_tpu_torch.train.trainer.train_epochs` reads.

Replicates the reference pipeline semantics (ref Uformer/data.py:22-253):
- `files.json` is a flat list of utterance ids (no extension);
- name conventions: "wsj" (clean id = mix id.split('_')[0]) and "vb"
  (same id in both dirs) — ref data.py:123-131;
- read wav pair, resample to 16 kHz, RMS-normalize with
  c = sqrt(N / sum(x^2)) applied to BOTH mix and clean (ref data.py:136),
  random crop to `chunk_length` (8 s), pad to batch max;
- one dataset item = one minibatch; shuffling happens at minibatch
  granularity (ref data.py:74-75).

Deltas kept from se_tpu (ref SURVEY.md §7.1 step 4, BASELINE.json):
- padded lengths are rounded up to a bucket multiple (`bucket_samples`);
- `shard(host_id, num_hosts)` slices the minibatch list for multi-host data
  parallelism;
- IO runs in a background thread with prefetch; an error there is
  raised in the consumer.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import random
import threading
from typing import Iterator

import numpy as np

from se_tpu_torch.data.wav import read_wav, resample


def rms_gain(x: np.ndarray) -> float:
    """c = sqrt(N / sum(x^2)) (ref Uformer/data.py:136)."""
    energy = float(np.sum(np.square(x, dtype=np.float64)))
    return float(np.sqrt(len(x) / max(energy, 1e-12)))


@dataclasses.dataclass
class Batch:
    """One padded minibatch."""

    mix: np.ndarray     # (B, N) float32
    clean: np.ndarray   # (B, N) float32
    frames: np.ndarray  # (B,) int32 valid frame counts
    lengths: np.ndarray  # (B,) int32 valid sample counts
    ids: list


class ManifestDataset:
    def __init__(
        self,
        mix_dir: str,
        clean_dir: str,
        manifest: str | list,
        batch_size: int = 16,
        chunk_length: int = 8 * 16000,
        target_sr: int = 16000,
        convention: str = "wsj",
        win_size: int = 320,
        win_shift: int = 160,
        bucket_samples: int = 16000,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 2,
    ):
        if isinstance(manifest, str):
            with open(manifest) as f:
                ids = json.load(f)
        else:
            ids = list(manifest)
        self.mix_dir = mix_dir
        self.clean_dir = clean_dir
        self.chunk_length = chunk_length
        self.target_sr = target_sr
        self.convention = convention
        self.win_size = win_size
        self.win_shift = win_shift
        self.bucket_samples = bucket_samples
        self.shuffle = shuffle
        self.rng = random.Random(seed)
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.minibatches = [
            ids[i : i + batch_size] for i in range(0, len(ids), batch_size)
        ]
        self._shard = (0, 1)

    def shard(self, host_id: int, num_hosts: int) -> "ManifestDataset":
        """Per-host input sharding: host i takes minibatches i::num_hosts."""
        self._shard = (host_id, num_hosts)
        return self

    def __len__(self) -> int:
        host, n = self._shard
        return len(self.minibatches[host::n]) if n > 1 else len(self.minibatches)

    def _clean_name(self, utt_id: str) -> str:
        if self.convention == "wsj":
            return utt_id.split("_")[0]
        return utt_id  # vb: same name

    def _load_utt(self, utt_id: str):
        mix, sr = read_wav(os.path.join(self.mix_dir, f"{utt_id}.wav"))
        clean, sr_c = read_wav(
            os.path.join(self.clean_dir, f"{self._clean_name(utt_id)}.wav")
        )
        if mix.ndim > 1:
            mix = mix[:, 0]
        if clean.ndim > 1:
            clean = clean[:, 0]
        mix = resample(mix, sr, self.target_sr)
        clean = resample(clean, sr_c, self.target_sr)
        c = rms_gain(mix)
        mix = mix * c
        clean = clean[: len(mix)] * c
        if len(mix) > self.chunk_length:
            start = self.rng.randint(0, len(mix) - self.chunk_length)
            mix = mix[start : start + self.chunk_length]
            clean = clean[start : start + self.chunk_length]
        return mix, clean

    def _collate(self, ids: list) -> Batch:
        pairs = [self._load_utt(u) for u in ids]
        lengths = np.array([len(m) for m, _ in pairs], np.int32)
        max_len = int(lengths.max())
        if self.bucket_samples:
            max_len = -(-max_len // self.bucket_samples) * self.bucket_samples
        b = len(pairs)
        mix = np.zeros((b, max_len), np.float32)
        clean = np.zeros((b, max_len), np.float32)
        for i, (m, c) in enumerate(pairs):
            mix[i, : len(m)] = m
            clean[i, : len(c)] = c
        frames = (lengths - self.win_size + self.win_size) // self.win_shift + 1
        return Batch(mix=mix, clean=clean, frames=frames.astype(np.int32),
                     lengths=lengths, ids=ids)

    def __iter__(self) -> Iterator[Batch]:
        host, n_hosts = self._shard
        order = list(range(len(self.minibatches)))
        if self.shuffle:
            self.rng.shuffle(order)
        if n_hosts > 1:
            order = order[host::n_hosts]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        failed = []

        def producer():
            try:
                for idx in order:
                    q.put(self._collate(self.minibatches[idx]))
            except Exception as exc:  # re-raised in the consumer below
                failed.append(exc)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if failed:
            raise failed[0]
