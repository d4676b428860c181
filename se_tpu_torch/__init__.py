"""se_tpu_torch: PyTorch/CUDA port of se_tpu for NVIDIA Hopper.

Mirrors se_tpu's module layout. Activations keep se_tpu's NHWC layout
(B, T, F, C) at every public function. Entry points run on the card unless
the caller passes ``device="cpu"``; on a CPU tensor each kernel wrapper runs
its plain PyTorch twin, on a CUDA tensor it launches its hand-written CUDA
kernel (se_tpu_torch/csrc) or raises. Models start in eval mode, their
enhancement path; `model.train()` selects se_tpu's `train=True` (BN batch
statistics, dropout, FullSubNet's drop_band), which `se_tpu_torch.train`
drives. Every kernel wrapper is differentiable (`ops/_autograd.py`) but
the STFT kernel's, which raises on an input that requires grad.
"""

__version__ = "0.1.0"
