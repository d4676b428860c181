"""Fused STFT (framing + window + FFT): the port of
se_tpu/ops/pallas_stft.py (`stft_pallas`, kernel `_kernel`; dispatcher
`stft_auto`).

On a CUDA tensor `stft_fused` launches csrc/stft.cu, which reads each
frame straight from the waveform with the convention's padding (as
`pad_signal` makes it: reflected ends for `center`, then zeros) applied at
the load, so neither a padded copy nor the frames tensor is written
(`stft_pallas` pads outside its `pallas_call`; on an H100 a separate pad
kernel took 24-37% of the device time at B = 256, chip_smoke.py phase
3), windows it and takes its real FFT in shared memory: n real points as
an n/2-point complex FFT in radix stages (`radix_plan`), then a
real-split pass. On a CPU tensor it runs `_reference`, the plain twin
(`ops.stft.basis_product`: framing, then one matmul with the windowed
DFT basis; `ops.stft.stft` in fp32).

A bf16 waveform launches the bf16 variant, `se_stft_basis_bf16`
(counted as `stft_bf16`), which computes what `stft_pallas` computes on
one (pallas_stft.py:102, :61-62, :115): the frames times the window x DFT
basis rounded to bf16 (`_bf16_basis`), each product of two bf16 values
exact and summed in fp32, the spectrum fp32. An FFT has no basis to
round, so a widened fp32 FFT would part from it by that rounding. The
twin is the same product in torch. se_tpu's own jnp `stft` returns the
bf16 spectrum (its output cast to x's dtype, se_tpu/ops/stft.py:194-205),
and so does the port's `ops.stft.stft`: the kernel and its twin follow
`stft_pallas`, fp32, whichever path se_tpu would take.

`stft_auto` sends a 2-D input to the kernel where frame_len % hop == 0
(`takes_kernel`, decided from shapes alone), as the TPU entry's contract
reads; the rest (other ranks, Uformer's 512/160) take the plain `stft`.
The kernel takes every n_fft up to 2 * MAX_POINTS (a frame's two buffers
in one block's shared memory): `radix_plan` factors any such n, radices
2, 4 and 5 unrolled in the kernel and any other prime as a generic stage;
past it `stft_fused` raises. `stft_auto` drops the JAX dispatcher's k =
frame_len / hop >= 3 threshold, a TPU v5e measurement; chip_smoke.py
measures the kernel against the plain path and torch.stft on the card at
k = 2 and 4.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from se_tpu_torch.ops import _build
from se_tpu_torch.ops.stft import StftConfig, _const, num_frames, stft
# the kernels' plain twin: on fp32 `stft` itself, on bf16 `stft_pallas`'s
# product (a bf16 basis, fp32 sums and spectrum)
from se_tpu_torch.ops.stft import basis_product as _reference

RADICES = (4, 2, 5)  # the kernel's unrolled butterflies, in plan order
MAX_POINTS = 8192    # complex points a frame: two buffers of 64 KB each


def fft_points(n: int) -> int:
    """The complex FFT length the kernel runs for a real n-point FFT: n/2
    for an even n (the real-split form), n for an odd one."""
    return n // 2 if n % 2 == 0 else n


@functools.lru_cache(maxsize=None)
def radix_plan(n: int) -> tuple[int, ...] | None:
    """The radices of the `fft_points(n)`-point complex FFT the kernel runs
    for a real n-point FFT: 4s, 2s and 5s first (the unrolled butterflies),
    then the other prime factors, ascending (512 -> (4, 4, 4, 4), 320 ->
    (4, 4, 2, 5), 384 -> (4, 4, 4, 3), 258 -> (3, 43)); None where it
    takes no such n (n < 1, or more than MAX_POINTS points)."""
    m = fft_points(n)
    if n < 1 or m > MAX_POINTS:
        return None
    plan = []
    for r in RADICES:
        while m % r == 0:
            plan.append(r)
            m //= r
    p = 3
    while m > 1:
        while m % p == 0:
            plan.append(p)
            m //= p
        p += 2
    return tuple(plan)


@functools.lru_cache(maxsize=None)
def twiddle_table(n: int) -> np.ndarray:
    """(L, 2) float32 [cos, sin] rows, built in float64: for each stage of
    `radix_plan(n)` with radix R after Ns points, an unrolled one's (R in
    RADICES) exp(-2 pi i r k / (Ns R)) at row k (R - 1) + r - 1 of its
    (Ns, R - 1) block (k < Ns, 1 <= r < R), a generic one's Ns R roots
    exp(-2 pi i m / (Ns R)); then, for an even n, W^k = exp(-2 pi i k / n)
    for k = 0 .. n/2, the real-split pass."""
    plan = radix_plan(n)
    if plan is None:
        raise ValueError(f"fused stft: no radix plan for n_fft {n}")
    blocks, ns = [], 1
    for r in plan:
        if r in RADICES:
            ang = np.outer(np.arange(ns), np.arange(1, r)).reshape(-1)
        else:
            ang = np.arange(ns * r)
        blocks.append(-2.0 * np.pi * ang / (ns * r))
        ns *= r
    if n % 2 == 0:
        blocks.append(-2.0 * np.pi * np.arange(n // 2 + 1) / n)
    ang = np.concatenate(blocks) if blocks else np.zeros(0)
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


BF16_K_TILE = 32  # the bf16 kernel's K stage: frame_len padded to it


@functools.lru_cache(maxsize=None)
def _bf16_basis(cfg: StftConfig, device: torch.device) -> torch.Tensor:
    """The bf16 variant's basis on `device`, made once: the window x DFT
    basis rounded to bf16, as `stft_pallas` rounds it to a bf16 waveform's
    dtype, transposed to (2F, Kp) (the kernel's B operand, K inner) and
    zero past frame_len to Kp, a multiple of BF16_K_TILE."""
    basis = _const("forward", cfg, device).to(torch.bfloat16).t()
    pad = -cfg.frame_len % BF16_K_TILE
    return torch.nn.functional.pad(basis, (0, pad)).contiguous()


@functools.lru_cache(maxsize=None)
def _kernel_consts(cfg: StftConfig, device: torch.device):
    """What a launch for `cfg` reads besides the waveform, made once on
    `device`: the window, the twiddle table and the plan's radices (int32)."""
    plan = radix_plan(cfg.fft)
    return (_const("window", cfg, device),
            torch.from_numpy(twiddle_table(cfg.fft)).to(device),
            torch.tensor(plan, dtype=torch.int32, device=device))


def takes_kernel(x: torch.Tensor, cfg: StftConfig) -> bool:
    """Whether `stft_auto` sends x to the kernel (on a CUDA device): a 2-D
    waveform and frame_len % hop == 0. Shapes only: holds for a tensor on
    any device, `meta` included."""
    return x.ndim == 2 and cfg.frame_len % cfg.hop == 0


def stft_fused(x: torch.Tensor, cfg: StftConfig):
    """(B, n) fp32 or bf16 waveform -> ((B, T, F) real, (B, T, F) imag),
    fp32 either way (a bf16 waveform: the bf16 basis product). Raises on
    an input that requires grad under grad mode: as se_tpu's `stft_pallas`
    the kernel has no gradient (the trainer makes its features under
    `torch.no_grad()`), and an output without one would drop it."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("stft_fused has no gradient: call it under "
                         "torch.no_grad() or on a tensor that does not "
                         "require grad (the plain ops.stft.stft has one)")
    if cfg.frame_len % cfg.hop != 0:  # the TPU entry's contract
        raise ValueError(f"fused stft needs frame_len % hop == 0, got "
                         f"{cfg.frame_len} and {cfg.hop}")
    if radix_plan(cfg.fft) is None:
        raise ValueError(f"fused stft: no radix plan for n_fft {cfg.fft} "
                         f"(over {MAX_POINTS} complex points a frame)")
    if x.device.type == "cpu":
        return _reference(x, cfg)
    if x.ndim != 2:
        raise ValueError(f"stft kernel: expected (B, n), got {tuple(x.shape)}")
    b, n = x.shape
    pad = cfg.fft // 2 if cfg.convention == "center" else 0
    if pad and pad >= n:  # torch's reflect padding refuses it too
        raise ValueError(f"stft kernel: reflect padding {pad} needs more "
                         f"than {pad} samples, got {n}")
    x = x.contiguous()
    dtype = _build.launch_dtype("stft", x)
    _build.check(x, (b, n), "x", dtype)
    t_frames = num_frames(n, cfg)
    bins = cfg.bins
    out = torch.empty(b, t_frames, 2 * bins, device=x.device)
    if dtype == torch.bfloat16:
        basis_t = _bf16_basis(cfg, x.device)
        _build.launch("se_stft_basis_bf16", x, basis_t, out, b, n, pad,
                      t_frames, cfg.frame_len, basis_t.shape[1], cfg.hop,
                      2 * bins)
    else:
        win, tw, radices = _kernel_consts(cfg, x.device)
        _build.launch("se_stft_fwd", x, win, tw, radices, out, b, n, pad,
                      t_frames, cfg.frame_len, cfg.fft, cfg.hop,
                      len(radices))
    _build.LAUNCHES[_build.variant("stft", dtype)] += 1
    return out[..., :bins], out[..., bins:]


def stft_auto(x: torch.Tensor, cfg: StftConfig):
    """`stft_fused` where `takes_kernel` (on the CPU that is its plain
    twin), the plain `stft` otherwise (other ranks, frame_len % hop != 0 as
    Uformer's center 512/160)."""
    if takes_kernel(x, cfg):
        return stft_fused(x, cfg)
    return stft(x, cfg)
