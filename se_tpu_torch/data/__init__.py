"""Data pipeline of the port: wav I/O, JSON manifests, bucketed batching
(copies of se_tpu/data)."""

from se_tpu_torch.data.dataset import Batch, ManifestDataset, rms_gain
from se_tpu_torch.data.wav import read_wav, resample, write_wav

__all__ = ["Batch", "ManifestDataset", "read_wav", "resample", "rms_gain",
           "write_wav"]
