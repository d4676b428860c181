#!/usr/bin/env python3
"""Drive se_tpu_torch's main paths on one NVIDIA GPU, and hold every CUDA
kernel of those paths against its plain PyTorch twin. The paths are the
enhancement of eleven model families: Uformer (waveform), FullSubNet
(cirm), DCCRN and GCRN (complex_map), LSTMNet and CRN (mag_mask), DPCRN
(complex_mask), the TCM families CTSNet, TaylorSENet and G2Net
(complex_map: cuDNN's convs and torch ops around the STFT kernel), and
DeepXi (hybrid: `models.deepxi.enhance`; "deepxi" the shipped ResNetV2,
"deepxi_reslstm" the ResLSTM variant on the LSTM kernels); and training
every family in fp32 (DeepXi through its driver's step) and the ten
families of the trainer in bf16 (fp32 master weights); streaming decode
(LSTMNet, CRN, GCRN and DPCRN
carrying their LSTM state chunk after chunk; Uformer's windowed decode);
the command line; and data parallelism (two ranks on the one card).

    python3 chip_smoke.py [--kernels lstm,...] [--families fullsubnet,...]

With no options, every kernel and every family; the options narrow
phases 3 and 7a to some kernels and phases 4-6, 7b-7d and 8-10 to some
families, for comparing two versions of the package (run the script in
each tree). `--families lstm,crn,gcrn,dpcrn,uformer` runs every stream
and the command line.

Phases, one JSON line per result:
  1. env:    the card (nvidia-smi name and power limit), torch and CUDA;
             TF32 off for matmuls and cuDNN; bf16 GEMMs reduce in fp32.
  2. build:  nvcc builds se_tpu_torch/csrc/*.cu (timed): each kernel's
             registers and spills (ptxas -v); the bf16 ring kernels'
             registers, spills, shared bytes and blocks an SM as the
             runtime reports them (`kernel_resources`).
  3. kernel: each kernel at every shape one forward at B = 4 x 4 s gives
             it (Uformer: T = 401; FullSubNet: T = 253; DCCRN: T = 501;
             the PRESET_320 models: T = 401), against its twin on the same
             CUDA inputs: max abs error within 1e-4 * max(1, max|twin|),
             kernel and twin times (CUDA events, median of 5 runs after
             warm-up in the cases a row sums, of 3 after 1 in the
             per-case lines; the twin's of 3 after 1, in the cases its
             row sums), the bound from the shapes
             (operations at the card's fp32-accurate tensor-core rate,
             bytes at HBM's; the larger), and as a yardstick the
             port never calls F.scaled_dot_product_attention (attention),
             cuDNN's LSTM (lstm), torch.addmm (lstm_project) and
             torch.stft, cuFFT (stft, center cases). The single DSConv
             block (the module forward of DSConvCplx / DSConvReal; the
             stage runs the pair entry) is checked at the shapes the stage
             gives it; attention on the design `att_design` gives each call
             (named in its line), the F-attention also on the other, at B =
             4 and 32 and at L = 8-32; the LSTM layer also in
             reverse and with a ragged batch and a non-zero carry, at phase
             5's B = 32 and 256 on both designs, and on the sub band at
             T = 506 and 1012; the small fold's two kernels (lstm_project,
             lstm_recur) also alone, and the recurrence's planned grid
             against the kernel's shared memory and occupancy; each
             encoder and decoder level on the design it takes (named in
             its line), encoder levels 0-2 and decoder levels 4 and 5 also
             on the other; the DSConv pair stage at its eight dilation
             pairs and at B = 32; the STFT also with pad_end and valid
             framing, at n_fft 384 and 2048 (a generic radix-3 stage; past
             the default shared memory), and its center presets at B = 32
             and 256. The attention, block, encoder, pair stage, STFT and
             bf16 lines that their row sums carry the device time by kernel
             (`device_ms`, torch.profiler) beside the CUDA-event time (and
             torch.stft's beside the STFT's).
             A kernel's row of the table sums the cases of one forward,
             named in its "note": the shapes of the other paths are the
             per-case lines. The bf16 variants of Uformer's four kernels
             (rows attention_bf16, dsconv_pair_bf16, encoder_bf16,
             decoder_bf16: the seven bf16 entries) at the same shapes,
             B = 4 and 32, in bf16 with bf16-rounded weights, against
             the bf16 twin: |err| <= 2^-7 |twin| + 1e-6 max|twin|
             elementwise (attention: at most 1e-3 of the elements past
             it, each by no more than one P element's rounding flip,
             `att_flip_slack`), and, reported, against the fp32 twin on
             the same bf16 values; their bound at bf16 bytes and 989
             TFLOP/s (the pair's fp32-operand products at 329.7: three
             bf16 pieces of the fp32 operand, the fewest exact), their
             device time by kernel; yardstick F.scaled_dot_product_
             attention in bf16. The bf16 LSTM (rows lstm_bf16,
             lstm_project_bf16, lstm_recur_bf16: bf16 weights, x fp32 or
             bf16, XP, h, c and y fp32) at the bf16 forwards' shapes
             (FullSubNet's sub band on the step; LSTMNet 161 -> 1024 with
             bf16 x and 1024 -> 1024 with fp32 x on the small fold;
             DPCRN's intra over T = 4 and inter; ...): the recurrences
             against the twin stepped along the kernel's own y (1e-4 *
             max(1, max|twin|)) and free-running within bf16_compare with
             one bf16 ulp of the largest output as the floor (LSTM_FLOOR:
             each side rounds its own h, so h flips now and then), the
             projection within bf16_compare; their bound at each product's
             rate (989 TFLOP/s bf16 x bf16, 329.7 fp32 x bf16) and their
             bytes; yardsticks cuDNN's LSTM in bf16 (the layer; for the
             small fold's two kernels together, once a layer shape in the
             recurrence row: one call computes what the pair computes) and
             torch.addmm on the widened operands;
             the recurrence's plan also for its bf16 kernel, and the
             row's device time a frame (`us_per_frame`). The single
             DSConv block (row dsconv_bf16) at its 16 shapes in bf16 with
             bf16 weights, each width at B = 32, and Cin 12, Cm 8 (the
             widened route), against its bf16 twin (the same bf16 rule;
             its bound at 329.7 TFLOP/s, fp32 operands against bf16
             weights), and the STFT's
             basis product (row stft_bf16: a bf16 waveform, the bf16
             window x DFT basis, fp32 out) at DCCRN's 512/128 at B = 4 and
             the three center presets at B = 32 against its twin within
             1e-4 * max(1, max|twin|) (fp32 out; and the bf16 rule,
             reported), its bound at 989 TFLOP/s and bf16 in / fp32 out
             bytes, torch.stft on the widened waveform its yardstick.
  4. main:   each family from a seed at its published widths, BN
             statistics and affines moved off their defaults,
             `enhance_waveform` on B = 4 x 4 s on the card with the launch
             counts set to 0 just before and read just after: every kernel
             of the path must have launched (counts in MAIN_PATHS; the
             TCM families the STFT kernel once and no other), the
             output must be finite and within 1e-3 * max|cpu| of the same
             weights run on the CPU (utterance 0); the TCM families run in
             their decode variant (norm "cln", the cumulative norms, every
             norm affine and PReLU slope moved off its default) and also in
             their InstanceNorm variant (norm "in"), each against the CPU;
             DeepXi with every LayerNorm scale and bias off its default and
             its DBNormalCDF map fitted once on the CPU
             (`deepxi_xi_map`), the same on both sides.
 4c. entry: the single DSConv block's and the bf16 STFT's paths, the op
             and module entry points a user calls (no model runs them):
             Uformer's 16 DSConvCplx / DSConvReal modules (phase 4's
             weights) in eval on B = 4 x 401 x 4 inputs, in fp32 and as
             bf16 copies on bf16 inputs, and `stft_auto` on DCCRN's
             512/128 with a bf16 B = 4 x 4 s waveform, each with the
             counts set to 0 just before and read just after: 16 launches
             of dsconv, of dsconv_bf16, one of stft_bf16 and no fp32 STFT
             (ENTRY_PATHS); each output against its twin (phase 3's rules).
 4b. main bf16: Uformer, the TCM families and the six LSTM
             families through `enhance_waveform(dtype=torch.bfloat16)` on
             the same B = 4 batch, counts set to 0 just before: Uformer
             launches the bf16 variants 4 / 8 / 6 / 6 times and no fp32
             kernel, the TCM families the fp32 STFT once and nothing else,
             the LSTM families the fp32 STFT and their phase-4 LSTM
             launches in the bf16 variants, no fp32 LSTM launch
             (BF16_PATHS); utterance 0 against the same weights on the
             CPU in bf16 and fp32: the card within twice the CPU bf16's
             own distance from the CPU fp32 of both. bf16 GEMMs sum in
             fp32 (allow_bf16_reduced_precision_reduction off, phase 1).
  5. speed:  fp32 enhance throughput of every family at B = 32 and B = 256
             x 4 s, median audio-seconds/s of 3 timed calls (2 where one
             call takes over 20 s, said so in the line), with peak device
             memory; where the B = 256 batch takes the tensor-core LSTM
             step (LSTM, CRN, DPCRN), its last utterance against the CPU
             on that utterance alone, within 1e-3 * max|cpu|; DeepXi's
             lines also carry the operations of one utterance
             (torch.utils.flop_counter, plus the LSTM kernels' count) and
             the rate they make. The bf16 families of phase 4b also in
             bf16, in turn with their fp32 lines (LSTM's, CRN's and
             DPCRN's B = 256 utterance by phase 4b's bf16 rule).
  6. profile: torch.profiler over one enhance call of each family at
             B = 32: device time by kernel name and the device's busy share
             of the wall time; Uformer's must show each of its kernels by
             name (PROFILE_KERNELS, PROFILE_GATED; DeepXi's report theirs);
             a profile that misses one, as torch.profiler's dropped events
             do now and then, is taken again, up to PROFILE_ATTEMPTS in
             all. Uformer and the LSTM families also in bf16, their bf16
             kernels by name (PROFILE_KERNELS_BF16).
  7. train:  (a) each kernel wrapper's autograd Function at a B = 4
             phase-3 case of each design (attention on both designs, the
             LSTM layer on both designs forward and reverse, its
             projection and recurrence alone, encoder and decoder levels
             on both designs, the single block complex and real, the pair
             stage) against its twin's own autograd on the same CUDA
             inputs and upstream gradients: every input gradient in its
             input's dtype and within 1e-4 * max(1, max|twin grad|), one
             launch a forward; the STFT kernel raises on an input that
             requires grad. The bf16 Functions the same way (attention on
             both designs, the LSTM step with an fp32 and a bf16 x, the
             projection, the recurrence; bf16 weights) within
             bf16_compare (the recurrences with LSTM_FLOOR). R11's
             yardstick: the LSTM layers' forward + backward through the
             Function against cuDNN's (torch.nn.LSTM) at FullSubNet's
             training sub band (Bf = 4,096, T = 253, both layers) and
             DPCRN's inter LSTM (Bf = 128, T = 401): ms, peak GB and the
             twin's recompute share.
             (b, c) Uformer, FullSubNet (B = 4: its sub band then takes
             the step), DCCRN (com_mag_mse and fusion_snr), GCRN, CRN,
             LSTMNet, DPCRN, CTSNet, TaylorSENet and G2Net at their
             published widths, B = 2 x 4 s: one train step on the card and
             one on the CPU from the
             same weights, dropout rates 0, BN batch statistics on: the
             loss within 1e-4 relative, every gradient within 1e-3 *
             max|cpu grad| of its tensor, the BN statistics after the step
             within 1e-3 * max|cpu|, the step's launches (TRAIN_PATHS);
             then the step under remat and three steps with dropout on and
             `enhance_waveform` of the trained weights against the CPU
             (1e-3 * max|cpu|), with the default loss only.
             DeepXi: one step of its driver (`DeepXiDriver.train_step`:
             the MagXi example, BCE, elementwise clip, Adam) at B = 2 x 4 s
             on the card and on the CPU (fp32, fp64), with 7b's loss and
             gradient tolerances and the step's launches.
             (e) bf16: one `TrainConfig(compute_dtype="bf16")` step of
             each of the ten families at B = 2 (FullSubNet 4) x 4 s,
             dropout 0, on the card with its launches (BF16_TRAIN_PATHS:
             no fp32 attention or LSTM launch) and on the CPU in bf16,
             from the same weights on 7b's batch, against 7b's CPU fp32
             step: `bf16_step_compare` (each tensor
             within twice the CPU bf16's distance from the CPU fp32 plus
             one bf16 ulp of the step's largest gradient, capped at a
             quarter of the tensor's own scale but for scalars and
             tensors the CPU's bf16 step does not resolve; PERF.md 2).
             The CPU's steps and enhances of (b, c, e) run in worker
             processes (`cpu_workers`) while this one runs the card's
             sides; each check is made once its CPU side is in.
             (d) train throughput at B = 32 x 4 s, dropout on: one
             warm-up step, the median of 3 in audio-s/s (the script's
             time limit), peak device memory, every step's
             loss (finite); Uformer and FullSubNet also in bf16; the
             device time by kernel of one fp32 step (top 10) and the busy
             share, but for DPCRN, DCCRN, GCRN, CRN and LSTMNet.
  8. stream: (a, b) LstmStreamer (a 3 s utterance plus 77 samples in
             0.1 s pieces) and CausalStreamer for CRN, GCRN and DPCRN (1.5
             s in tests/test_streaming.py's pieces), chunks of 16 frames,
             at published widths from a seed, the gain passed in: the
             stream on the card against the card's own offline
             `enhance_waveform` and against the same stream on the CPU,
             each within 1e-3 * max|ref|, with the LSTM kernels launched
             (STREAM_PATHS; counts set to 0 just before each stream); (c)
             Uformer's `enhance_windowed` at its defaults (4 s chunks, 2 s
             context, max_batch 16) over 8.5 s against the CPU at
             max_batch 2, with its four kernels launched, and in bf16
             (its four bf16 variants, no fp32 kernel; its distance from
             the fp32 decode); (d) the median
             wall time of a push that completes one chunk (0.16 s of
             audio), its real-time factor and the launches a chunk, for
             each streamer; in turns with it the same pushes with the
             LSTM weights packed once (`_PackedOnce`, ROADMAP R10) and
             their paired difference; the device busy share of a chunk;
             and Uformer's windowed audio-s/s over 60 s
             (15 windows, one batch), fp32 and bf16 in turns, each beside
             the card. Phase 3 holds
             the LSTM kernels at these streams' shapes, each call with a
             carry (STREAM_LSTM_CALLS), and a chain of three carried calls
             across both designs (`check_carry_chain`).
  9. cli:    `python -m se_tpu_torch` as subprocesses in a temporary
             directory with two seeded 1 s pairs and a manifest: train
             DPCRN (one step), enhance from its checkpoint, stream exact
             (LSTMNet) and windowed (GCRN), score; each must exit 0, the
             enhanced wavs match the restored model's in-process decode
             within 1e-3 * max + one 16-bit step, every CSV column is
             finite; each command's wall seconds (train, then `train
             --data-parallel` (a world of one, NCCL), each alone on the
             card, then both streams and enhance side by side, then
             score); the two trains, both the CLI's `main` under
             cuDNN's deterministic algorithms (`CLI_DETERMINISTIC`, as
             7b's remat steps), have checkpoints that agree
             (`checkpoints_agree`: gradients by phase 7b's rule, weights
             within 1e-5 x max but where Adam's first step moved a
             round-off gradient by +-lr).
 10. parallel: data parallelism, two ranks (processes, this script run
             with --parallel-rank) on the one card in a gloo group
             (its collectives on CUDA tensors checked; two more try NCCL
             there, reported): Uformer's and DPCRN's sharded decodes at
             B = 4 x 4 s against the one-process card decode (phase 4's
             rule), au-s/s of both; one sharded fp32 train step of DPCRN
             (B = 4) and FullSubNet (B = 8) against the one-process card
             step (phase 7b's rules); each rank's launches. Then the
             "model" axis on the same ranks, a {"data": 1, "model": 2}
             mesh (parallel_cards.py: {"data": 2, "model": 2} on four
             cards): Uformer's decode of the same batch, each rank its
             kernels on half of each call's rows (attention 4, pair 8,
             encoder 6, decoder 6; the rows each kernel took counted
             against the unmapped decode's), against the one-process card
             decode (1e-5 * max|ref|), and one Uformer train step at B =
             2 a data group (its attention mapped) against the
             one-process card step by phase 7b's rules.
Then the kernel table as one JSON line (a row's "launches" are those of the
phase-4 forward its note names, "launches_all_paths" those of all twelve,
"launches_train_step" those of one train step of each trained family and
loss, and of each bf16 step,
"launches_stream" those of each phase-8 path, "launches_parallel" those of
each rank's part of each phase-10 path; its
"backward" names the twin whose VJP it recomputes, "grad_max_abs_err"
phase 7a's error) and, last, the device line. Any
failure exits non-zero; without a CUDA device, or without the se_tpu_torch
package beside this file, it exits 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SR, HOP, SECONDS, B_MAIN = 16000, 160, 4, 4
T_FRAMES = SECONDS * SR // HOP + 1  # 401
# FullSubNet: 512/256 STFT, 251 frames + a look-ahead of 2, 257 bins
FSN_T, FSN_F = SECONDS * SR // 256 + 1 + 2, 257
FSN_LAYERS = ((FSN_F, 512), (512, 512), (32, 384), (384, 384))  # (In, H)
DCCRN_T = SECONDS * SR // 128 + 1  # 501: 512/128 center framing
DEEPXI_T = -(-SECONDS * SR // 256)  # 250: 512/256 pad_end framing
SLOW_CALL_S = 20.0
KERNELS = (1, 8, 16, 32, 64, 128, 128)
DILATIONS = (1, 2, 4, 8, 16, 32, 64, 128)
# H100 SXM peaks (NVIDIA data sheet). Operations: fp32-accurate products
# on the tensor cores, 495 TFLOP/s TF32 in three passes (3xTF32), the least
# time this card takes for an fp32 operation count by any route (the
# CUDA cores' fp32 peak is 67 TFLOP/s). Bytes: HBM3.
PEAK_FP32_ACCURATE_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12
# dense bf16 on the tensor cores (NVIDIA data sheet): the bound of a
# product of two bf16 operands, which the bf16 kernels run in one TF32
# pass
PEAK_BF16_FLOPS = 989e12
# an fp32 operand against a bf16-valued one, fp32-accurate: the fewest
# exact products are three bf16 ones, the fp32 operand split in three bf16
# pieces (the bf16 LSTM step, tc_common.cuh split_bf16x3), 329.7 TFLOP/s;
# two TF32 passes (the bf16 one is exact in TF32, the fp32 one split hi +
# lo: the bf16 DSConv pair and the bf16 projection) reach 247.5
PEAK_FP32_BF16_FLOPS = 989e12 / 3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 10, rounds: int = 5, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> dict:
    """Device time a call by kernel name (torch.profiler over `reps` calls
    after a warm-up), the largest first: what a call's CUDA-event time
    holds besides the launch path on the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((evt.device_time_total / 1e3 / reps, evt.key[:60])
                   for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA), reverse=True)
    return {key: ms for ms, key in rows}


def ops_seconds(flops, peak: float) -> float:
    """The least time of a case's operations: flops / peak, or for a case
    whose products run at two rates (the bf16 LSTM: an fp32 x against bf16
    weights, and the bf16-rounded h against them) the sum over its
    (flops, peak) pairs."""
    if isinstance(flops, tuple):
        return sum(f / p for f, p in flops)
    return flops / peak


def total_flops(flops) -> float:
    return sum(f for f, _ in flops) if isinstance(flops, tuple) else flops


def bound(flops, nbytes: float,
          peak: float = PEAK_FP32_ACCURATE_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = ops_seconds(flops, peak), nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    """Bytes of tensors (and tuples of them), each at its element size."""
    total = 0
    for t in tensors:
        total += sum(x.numel() * x.element_size() for x in t) \
            if isinstance(t, tuple) else t.numel() * t.element_size()
    return total


def valid_taps(n: int, positions) -> int:
    """Count the (position, tap) pairs whose input index lies in [0, n);
    `positions` yields (position, [input index of each tap])."""
    return sum(1 for _, idx in positions for i in idx if 0 <= i < n)


# --------------------------------------------------------- the kernel cases

def attention_cases(gen, dev):
    """The four calls of Uformer's B = 4 forward, each on the design
    `att_design` gives it (named in the label), the F-attention's L = 4
    also on the flash design it does not take; then L = 8, 16 and 32 at
    the F-attention's N H on both designs (what att_design rests on), and
    the four calls at phase 5's B = 32. Yardstick:
    F.scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F

    from se_tpu_torch.ops import attention

    def shapes(b, t, f):
        return ((b * f, 8, t), (b * f, 1, t), (b * t, 8, f), (b * t, 1, f))

    cases = [(n, h, l, B_MAIN, True) for n, h, l in shapes(B_MAIN,
                                                           T_FRAMES, 4)]
    cases += [(B_MAIN * T_FRAMES, 8, l, B_MAIN, False) for l in (8, 16, 32)]
    cases += [(n, h, l, 32, False) for n, h, l in shapes(32, T_FRAMES, 4)]
    for n, h, l, b, in_row in cases:
        q, k, v = (torch.randn(n, h, l, 16, generator=gen).to(dev) * 0.5
                   for _ in range(3))
        flops = 4.0 * n * h * l * l * 16
        label = f"attention B={b} {n}x{h}x{l}x16"
        design = attention.att_design(n * h, l)
        library = (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
            q, k, v, scale=0.25))
        yield (f"{label} design={design}", (q, k, v, 0.25, None), flops,
               nbytes(q, k, v, q), library, in_row)
        if l <= attention.SMALL_L_MAX:  # either design takes it
            other = "flash_tc" if design == "small_l" else "small_l"
            yield (f"{label} design={other} (not taken)",
                   (q, k, v, 0.25, other), flops, nbytes(q, k, v, q), None,
                   False)


def _att_kernel(q, k, v, scale, design):
    """sdp_attention as Uformer calls it, or one design forced."""
    from se_tpu_torch.ops import attention

    if design is None:
        return attention.sdp_attention(q, k, v, scale)
    return attention._launch(q, k, v, scale, design)


def _att_twin(q, k, v, scale, design):
    from se_tpu_torch.ops import attention

    return attention._reference(q, k, v, scale)


def dsconv_params(gen, cin, tot, dev):
    import torch

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    return (r(1, cin, scale=0.1, shift=1.0), r(1, cin, scale=0.1),
            r(cin, tot, scale=cin ** -0.5), r(1, tot, scale=0.1),
            torch.full((1, 1), 0.25, device=dev),
            r(9 * tot, tot, scale=(9 * tot) ** -0.5), r(1, tot, scale=0.1),
            r(9 * tot, tot, scale=(9 * tot) ** -0.5), r(1, tot, scale=0.1),
            r(1, tot, scale=0.1, shift=1.0), r(1, tot, scale=0.1),
            r(tot, cin, scale=tot ** -0.5), r(1, cin, scale=0.1))


def dsconv_cases(gen, dev):
    """The 16 block shapes of Uformer's B = 4 forward (its eight dilation
    pairs, complex and real), each block's weights packed once, as
    DSConvCplx and DSConvReal keep them."""
    import torch

    from se_tpu_torch.ops import dsconv

    b, t, f = B_MAIN, T_FRAMES, 4
    n = len(DILATIONS)
    for ncomp, cin, tot in ((2, 256, 64), (1, 128, 32)):
        params = dsconv_params(gen, cin, tot, dev)
        packed = dsconv.pack_block_weights(params, ncomp)
        x = torch.randn(b, t, f, cin, generator=gen).to(dev)
        for i, d1 in enumerate(DILATIONS):
            d2 = DILATIONS[n - i - 1]
            yield (f"dsconv ncomp={ncomp} {b}x{t}x{f}x{cin} d=({d1},{d2})",
                   (x, params, d1, d2, ncomp, packed),
                   dsconv_flops(b, t, f, cin, tot, d1, d2),
                   nbytes(x, params, x), None, True)


def _block_kernel(x, params, d1, d2, ncomp, packed):
    from se_tpu_torch.ops import dsconv

    return dsconv.dsconv_block(x, params, d1, d2, ncomp, packed=packed)


def _block_twin(x, params, d1, d2, ncomp, packed):
    from se_tpu_torch.ops import dsconv

    return dsconv._reference(x, params, d1, d2, ncomp)


def level_params(gen, shapes, dev):
    import torch

    out = []
    for shape in shapes:
        if shape == (1, 1):
            out.append(torch.full((1, 1), 0.2, device=dev))
        elif len(shape) > 2:
            fan = shape[-2] * (10 if len(shape) == 4 else 5)
            out.append((torch.randn(*shape, generator=gen) * fan ** -0.5)
                       .to(dev))
        else:
            out.append((torch.randn(*shape, generator=gen) * 0.1 + 1.0)
                       .to(dev))
    return tuple(out)


def encoder_cases(gen, dev):
    """The six levels of Uformer's B = 4 forward, each on the design
    `level_design` gives it (the tensor-core levels with their weights
    packed once, as Uformer keeps them; named in the label), then levels
    0-2 also on the design they do not take: the times are what
    `level_design`'s choice rests on."""
    import torch

    from se_tpu_torch.ops import encoder

    b, t = B_MAIN, T_FRAMES
    t_taps = 2 * t - 1
    for i in range(6):
        f, cin, cout = 256 >> i, KERNELS[i], KERNELS[i + 1]
        shapes = ((2, 5, 2 * cin, 2 * cout), (1, 2 * cout), (1, 2 * cout),
                  (1, 2 * cout), (1, 1), (2, 5, cin, cout), (1, cout),
                  (1, cout), (1, cout), (1, 1))
        params = level_params(gen, shapes, dev)
        xc = torch.randn(b, t, f, 2 * cin, generator=gen).to(dev)
        xm = torch.randn(b, t, f, cin, generator=gen).to(dev)
        f_taps = valid_taps(f, ((fo, [2 * fo + j - 2 for j in range(5)])
                                for fo in range(f // 2)))
        flops = 2.0 * b * t_taps * f_taps * 5 * cin * cout
        out_bytes = b * t * (f // 2) * 3 * cout * 4
        design = encoder.level_design(cin)
        packed = encoder.pack_encoder_weights(params) if design == "tc" \
            else None
        label = f"encoder level {i} {b}x{t}x{f}x{cin}->{cout}"
        moved = nbytes(xc, xm, params) + out_bytes
        yield (f"{label} design={design}", (xc, xm, params, packed, None),
               flops, moved, None, True)
        if i <= 2:  # the shallow levels on the design they do not take
            other = "cuda_core" if design == "tc" else "tc"
            yield (f"{label} design={other} (not taken)",
                   (xc, xm, params, None, other), flops, moved, None, False)


def _encoder_kernel(xc, xm, params, packed, design):
    """encoder_level as Uformer calls it, or one design forced."""
    from se_tpu_torch.ops import encoder

    if design is None:
        return encoder.encoder_level(xc, xm, params, packed=packed)
    return encoder._launch(xc, xm, params, design, packed)


def _encoder_twin(xc, xm, params, packed, design):
    from se_tpu_torch.ops import encoder

    return encoder._reference(xc, xm, params)


def decoder_cases(gen, dev):
    """The six levels of Uformer's B = 4 forward, each on the design
    `level_design` gives it (the tensor-core levels with their weights
    packed once, as Uformer keeps them; named in the label), then levels
    4 and 5 (Cout 8 and 1) also on the design they do not take: the times
    are what `level_design`'s choice rests on."""
    import torch

    from se_tpu_torch.ops import decoder

    b, t = B_MAIN, T_FRAMES
    t_taps = 2 * t - 1
    for i in range(6):
        f, cc, cout = 4 << i, 2 * KERNELS[6 - i], KERNELS[5 - i]
        shapes = ((6, 2 * cc, 2 * cout), (4, 2 * cc, 2 * cout),
                  (1, 2 * cout), (1, 2 * cout), (1, 2 * cout), (1, 1),
                  (6, cc, cout), (4, cc, cout), (1, cout), (1, cout),
                  (1, cout), (1, 1))
        params = level_params(gen, shapes, dev)
        xc = torch.randn(b, t, f, 2 * cc, generator=gen).to(dev)
        xm = torch.randn(b, t, f, cc, generator=gen).to(dev)
        f_taps = valid_taps(f, ((q, [q + j - 1 for j in range(3)])
                                for q in range(f)))
        f_taps += valid_taps(f, ((q, [q + j for j in range(2)])
                                 for q in range(f)))
        flops = 2.0 * b * t_taps * f_taps * 5 * cc * cout
        out_bytes = b * t * 2 * f * 3 * cout * 4
        design = decoder.level_design(cc, cout)
        packed = decoder.pack_decoder_weights(params) if design == "tc" \
            else None
        label = f"decoder level {i} {b}x{t}x{f}x{cc}->{cout}"
        moved = nbytes(xc, xm, params) + out_bytes
        yield (f"{label} design={design}",
               (xc, xm, params, i < 5, packed, None), flops, moved, None,
               True)
        if i >= 4:  # the narrow levels on the design they do not take
            other = "cuda_core" if design == "tc" else "tc"
            yield (f"{label} design={other} (not taken)",
                   (xc, xm, params, i < 5, None, other), flops, moved, None,
                   False)


def _decoder_kernel(xc, xm, params, has_bn, packed, design):
    """decoder_level as Uformer calls it, or one design forced."""
    from se_tpu_torch.ops import decoder

    if design is None:
        return decoder.decoder_level(xc, xm, params, has_bn, packed=packed)
    return decoder._launch(xc, xm, params, has_bn, design, packed)


def _decoder_twin(xc, xm, params, has_bn, packed, design):
    from se_tpu_torch.ops import decoder

    return decoder._reference(xc, xm, params, has_bn)


def dsconv_flops(b, t, f, cin, tot, d1, d2) -> float:
    """The two 1x1 convs on every row; the dilated 3x3 convs only on the
    taps that land inside (T, F), zero padding being no work."""
    f_taps = valid_taps(f, ((ff, [ff - 1, ff, ff + 1]) for ff in range(f)))
    t_taps = sum(valid_taps(t, ((tt, [tt - d, tt, tt + d])
                                for tt in range(t)))
                 for d in (d1, d2))
    return 2.0 * b * (t * f * 2 * cin * tot + t_taps * f_taps * tot * tot)


def pair_cases(gen, dev):
    """The eight stages of Uformer's B = 4 forward (its dilation pairs),
    with both blocks' weights packed once, as Uformer keeps them; then one
    stage at phase 5's B = 32."""
    import torch

    from se_tpu_torch.ops import dsconv

    t, f = T_FRAMES, 4
    n = len(DILATIONS)
    pc = dsconv_params(gen, 256, 64, dev)
    pm = dsconv_params(gen, 128, 32, dev)
    packed = dsconv.pack_pair_weights(pc, pm)
    stages = [(B_MAIN, d1, DILATIONS[n - i - 1], True)
              for i, d1 in enumerate(DILATIONS)] + [(32, 1, 128, False)]
    for b, d1, d2, in_row in stages:
        xc = torch.randn(b, t, f, 256, generator=gen).to(dev)
        xm = torch.randn(b, t, f, 128, generator=gen).to(dev)
        # both blocks; the fusion's ~10 flops a channel are left out
        flops = (dsconv_flops(b, t, f, 256, 64, d1, d2)
                 + dsconv_flops(b, t, f, 128, 32, d1, d2))
        yield (f"dsconv_pair {b}x{t}x{f}x(256+128) d=({d1},{d2})",
               (xc, xm, pc, pm, d1, d2, packed), flops,
               nbytes(xc, xm, pc, pm, xc, xm), None, in_row)


def _pair_kernel(xc, xm, pc, pm, d1, d2, packed):
    from se_tpu_torch.ops import dsconv

    return dsconv.dsconv_pair_block(xc, xm, pc, pm, d1, d2, packed=packed)


def _pair_twin(xc, xm, pc, pm, d1, d2, packed):
    from se_tpu_torch.ops import dsconv

    return dsconv._pair_reference(xc, xm, pc, pm, d1, d2)


# ------------------------------------------------ the bf16 kernel cases

def _bf16_params(params):
    """A level's tuple as Uformer's bf16 copy gives it: conv weights bf16,
    the tail vectors fp32 holding bf16 values."""
    import torch

    return tuple(p.to(torch.bfloat16) if p.dim() > 2
                 else p.to(torch.bfloat16).float() for p in params)


def bf16_attention_cases(gen, dev):
    """The four calls of Uformer's B = 4 forward in bf16, each on the
    design `att_design` gives it, then the four at phase 5's B = 32.
    Yardstick: F.scaled_dot_product_attention in bf16."""
    import torch
    import torch.nn.functional as F

    from se_tpu_torch.ops import attention

    for b in (B_MAIN, 32):
        for n, h, l in ((b * 4, 8, T_FRAMES), (b * 4, 1, T_FRAMES),
                        (b * T_FRAMES, 8, 4), (b * T_FRAMES, 1, 4)):
            q, k, v = ((torch.randn(n, h, l, 16, generator=gen) * 0.5)
                       .to(dev).to(torch.bfloat16) for _ in range(3))
            design = attention.att_design(n * h, l)
            library = (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, scale=0.25))
            yield (f"attention bf16 B={b} {n}x{h}x{l}x16 design={design}",
                   (q, k, v, 0.25, None), 4.0 * n * h * l * l * 16,
                   nbytes(q, k, v, q), library, b == B_MAIN)


def bf16_encoder_cases(gen, dev):
    """The six levels of Uformer's B = 4 forward in bf16, each on the
    design `level_design` gives it (packed once from the bf16 weights, in
    bf16, as Uformer's bf16 copy keeps them), then at B = 32."""
    import torch

    from se_tpu_torch.ops import encoder

    for b in (B_MAIN, 32):
        t = T_FRAMES
        for i in range(6):
            f, cin, cout = 256 >> i, KERNELS[i], KERNELS[i + 1]
            shapes = ((2, 5, 2 * cin, 2 * cout), (1, 2 * cout),
                      (1, 2 * cout), (1, 2 * cout), (1, 1),
                      (2, 5, cin, cout), (1, cout), (1, cout), (1, cout),
                      (1, 1))
            params = _bf16_params(level_params(gen, shapes, dev))
            xc = torch.randn(b, t, f, 2 * cin, generator=gen).to(dev)
            xm = torch.randn(b, t, f, cin, generator=gen).to(dev)
            xc, xm = xc.to(torch.bfloat16), xm.to(torch.bfloat16)
            f_taps = valid_taps(f, ((fo, [2 * fo + j - 2 for j in range(5)])
                                    for fo in range(f // 2)))
            flops = 2.0 * b * (2 * t - 1) * f_taps * 5 * cin * cout
            design = encoder.level_design(cin, torch.bfloat16)
            packed = encoder.pack_encoder_weights(params) \
                if design == "tc" else None  # bf16, as Uformer keeps it
            moved = nbytes(xc, xm, params) + b * t * (f // 2) * 3 * cout * 2
            yield (f"encoder bf16 level {i} B={b} {b}x{t}x{f}x{cin}->{cout} "
                   f"design={design}", (xc, xm, params, packed, None), flops,
                   moved, None, b == B_MAIN)


def widened_case(kind: str):
    """Fail unless a case of `kind` ("decoder", "dsconv_pair", "dsconv")
    that a bf16 generator has just yielded ran the widened route: call
    before the yield, and the returned check after it (the generator
    resumes once phase 3 is done with the case)."""
    from se_tpu_torch.ops import _build

    key = f"{kind}_bf16_widened"
    before = _build.LAUNCHES[key]

    def check(label: str) -> None:
        if _build.LAUNCHES[key] == before:
            fail(f"{label}: no {key} launch")
    return check


def bf16_decoder_cases(gen, dev):
    """The six levels of Uformer's B = 4 forward in bf16, each on its
    design, then at B = 32; then a level of Cc = 12 (not a multiple of 8:
    se_tpu's other widths), which must take the widened route."""
    import torch

    from se_tpu_torch.ops import decoder
    from se_tpu_torch.ops._dtype import pack_dtype

    for b in (B_MAIN, 32):
        t = T_FRAMES
        for i in range(6):
            f, cc, cout = 4 << i, 2 * KERNELS[6 - i], KERNELS[5 - i]
            shapes = ((6, 2 * cc, 2 * cout), (4, 2 * cc, 2 * cout),
                      (1, 2 * cout), (1, 2 * cout), (1, 2 * cout), (1, 1),
                      (6, cc, cout), (4, cc, cout), (1, cout), (1, cout),
                      (1, cout), (1, 1))
            params = _bf16_params(level_params(gen, shapes, dev))
            xc = torch.randn(b, t, f, 2 * cc, generator=gen).to(dev)
            xm = torch.randn(b, t, f, cc, generator=gen).to(dev)
            xc, xm = xc.to(torch.bfloat16), xm.to(torch.bfloat16)
            f_taps = valid_taps(f, ((q, [q + j - 1 for j in range(3)])
                                    for q in range(f)))
            f_taps += valid_taps(f, ((q, [q + j for j in range(2)])
                                     for q in range(f)))
            flops = 2.0 * b * (2 * t - 1) * f_taps * 5 * cc * cout
            design = decoder.level_design(cc, cout)
            packed = decoder.pack_decoder_weights(params) \
                if design == "tc" else None
            moved = nbytes(xc, xm, params) + b * t * 2 * f * 3 * cout * 2
            yield (f"decoder bf16 level {i} B={b} {b}x{t}x{f}x{cc}->{cout} "
                   f"design={design}", (xc, xm, params, i < 5, packed, None),
                   flops, moved, None, b == B_MAIN)
    b, t, f, cc, cout = B_MAIN, T_FRAMES, 16, 12, 16
    shapes = ((6, 2 * cc, 2 * cout), (4, 2 * cc, 2 * cout), (1, 2 * cout),
              (1, 2 * cout), (1, 2 * cout), (1, 1), (6, cc, cout),
              (4, cc, cout), (1, cout), (1, cout), (1, cout), (1, 1))
    params = _bf16_params(level_params(gen, shapes, dev))
    xc = torch.randn(b, t, f, 2 * cc, generator=gen).to(dev)
    xm = torch.randn(b, t, f, cc, generator=gen).to(dev)
    xc, xm = xc.to(torch.bfloat16), xm.to(torch.bfloat16)
    f_taps = valid_taps(f, ((q, [q + j - 1 for j in range(3)])
                            for q in range(f)))
    f_taps += valid_taps(f, ((q, [q + j for j in range(2)])
                             for q in range(f)))
    design = decoder.level_design(cc, cout, torch.bfloat16)
    label = f"decoder bf16 widened {b}x{t}x{f}x{cc}->{cout} design={design}"
    check = widened_case("decoder")
    packed = decoder.pack_decoder_weights(params, pack_dtype(params[0],
                                                             design))
    yield (label, (xc, xm, params, True, packed, None),
           2.0 * b * (2 * t - 1) * f_taps * 5 * cc * cout,
           nbytes(xc, xm, params) + b * t * 2 * f * 3 * cout * 2, None,
           False)
    check(label)


def bf16_pair_cases(gen, dev):
    """The eight stages of Uformer's B = 4 forward in bf16 (weights
    rounded to bf16, packed once), then one stage at B = 32; then stages of
    C = 12 and of Cm 4 + 4 a block (not multiples of 8 and 16: se_tpu's
    other widths), which must take the widened route."""
    import torch

    from se_tpu_torch.ops import dsconv
    from se_tpu_torch.ops._dtype import pack_dtype

    t, f = T_FRAMES, 4
    n = len(DILATIONS)
    pc = tuple(p.to(torch.bfloat16) for p in dsconv_params(gen, 256, 64,
                                                            dev))
    pm = tuple(p.to(torch.bfloat16) for p in dsconv_params(gen, 128, 32,
                                                           dev))
    packed = dsconv.pack_pair_weights(pc, pm)
    stages = [(B_MAIN, d1, DILATIONS[n - i - 1], True)
              for i, d1 in enumerate(DILATIONS)] + [(32, 1, 128, False)]
    for b, d1, d2, in_row in stages:
        xc = torch.randn(b, t, f, 256, generator=gen).to(dev)
        xm = torch.randn(b, t, f, 128, generator=gen).to(dev)
        xc, xm = xc.to(torch.bfloat16), xm.to(torch.bfloat16)
        flops = (dsconv_flops(b, t, f, 256, 64, d1, d2)
                 + dsconv_flops(b, t, f, 128, 32, d1, d2))
        yield (f"dsconv_pair bf16 {b}x{t}x{f}x(256+128) d=({d1},{d2})",
               (xc, xm, pc, pm, d1, d2, packed), flops,
               nbytes(xc, xm, pc, pm, xc, xm), None, in_row)
    b = B_MAIN
    for c, cm in ((12, 16), (64, 4)):
        pc = tuple(p.to(torch.bfloat16)
                   for p in dsconv_params(gen, 2 * c, 2 * cm, dev))
        pm = tuple(p.to(torch.bfloat16) for p in dsconv_params(gen, c, cm,
                                                               dev))
        xc = torch.randn(b, t, f, 2 * c, generator=gen).to(dev)
        xm = torch.randn(b, t, f, c, generator=gen).to(dev)
        xc, xm = xc.to(torch.bfloat16), xm.to(torch.bfloat16)
        design = dsconv.pair_design(c, 2 * cm, cm, torch.bfloat16)
        label = (f"dsconv_pair bf16 widened {b}x{t}x{f}x({2 * c}+{c}) "
                 f"Cm=({2 * cm}+{cm}) d=(1,2) design={design}")
        check = widened_case("dsconv_pair")
        packed = dsconv.pack_pair_weights(pc, pm, pack_dtype(pc[2], design))
        yield (label, (xc, xm, pc, pm, 1, 2, packed),
               dsconv_flops(b, t, f, 2 * c, 2 * cm, 1, 2)
               + dsconv_flops(b, t, f, c, cm, 1, 2),
               nbytes(xc, xm, pc, pm, xc, xm), None, False)
        check(label)


def bf16_dsconv_cases(gen, dev):
    """The 16 block shapes of `dsconv_cases` in bf16: weights rounded to
    bf16 (as a bf16 copy of DSConvCplx / DSConvReal holds them) and packed
    once, x bf16; then each width at phase 5's B = 32."""
    import torch

    from se_tpu_torch.ops import dsconv

    t, f = T_FRAMES, 4
    n = len(DILATIONS)
    for ncomp, cin, tot in ((2, 256, 64), (1, 128, 32)):
        params = tuple(p.to(torch.bfloat16)
                       for p in dsconv_params(gen, cin, tot, dev))
        packed = dsconv.pack_block_weights(params, ncomp)
        blocks = [(B_MAIN, d1, DILATIONS[n - i - 1], True)
                  for i, d1 in enumerate(DILATIONS)] + [(32, 1, 128, False)]
        for b, d1, d2, in_row in blocks:
            x = torch.randn(b, t, f, cin, generator=gen).to(dev).to(
                torch.bfloat16)
            yield (f"dsconv bf16 ncomp={ncomp} {b}x{t}x{f}x{cin} "
                   f"d=({d1},{d2})", (x, params, d1, d2, ncomp, packed),
                   dsconv_flops(b, t, f, cin, tot, d1, d2),
                   nbytes(x, params, x), None, in_row)


def bf16_dsconv_widened_cases(gen, dev):
    """A bf16 block of Cin 12 and Cm 8 (not multiples of 8 and 16: se_tpu's
    other widths), which must take the widened route."""
    import torch

    from se_tpu_torch.ops import dsconv

    b, t, f, cin, tot = B_MAIN, T_FRAMES, 4, 12, 8
    params = tuple(p.to(torch.bfloat16)
                   for p in dsconv_params(gen, cin, tot, dev))
    x = torch.randn(b, t, f, cin, generator=gen).to(dev).to(torch.bfloat16)
    design = dsconv.block_design(cin, tot, torch.bfloat16)
    label = (f"dsconv bf16 widened ncomp=1 {b}x{t}x{f}x{cin} Cm={tot} "
             f"d=(1,2) design={design}")
    check = widened_case("dsconv")
    yield (label, (x, params, 1, 2, 1, dsconv.pack_block_weights(params, 1)),
           dsconv_flops(b, t, f, cin, tot, 1, 2), nbytes(x, params, x), None,
           False)
    check(label)


def bf16_stft_cases(gen, dev):
    """The bf16 basis product: DCCRN's 512/128 call at B = 4 (the row),
    then the three center presets at phase 5's B = 32, on a bf16 waveform.
    The bound is the product's: 2 frame_len 2F flops a frame at 989
    TFLOP/s (two bf16 operands), the bf16 waveform and basis in and the
    fp32 spectrum out. Yardstick: torch.stft (cuFFT) on the widened
    waveform."""
    import torch

    from se_tpu_torch.ops import stft as plain
    from se_tpu_torch.ops.windows import get_window

    center = (("DCCRN 512/128 k=4", plain.PRESET_512_128),
              ("FullSubNet 512/256 k=2", plain.PRESET_512_256),
              ("PRESET_320 320/160 k=2", plain.PRESET_320))
    cases = [(*center[0], B_MAIN, True)]
    cases += [(label, cfg, 32, False) for label, cfg in center]
    for label, cfg, batch, in_row in cases:
        x = torch.randn(batch, SECONDS * SR, generator=gen).mul(0.1).to(
            dev).to(torch.bfloat16)
        t_len, n2 = plain.num_frames(x.shape[1], cfg), 2 * cfg.bins
        flops = 2.0 * batch * t_len * cfg.frame_len * n2
        moved = nbytes(x) + 2 * cfg.frame_len * n2 + 4 * batch * t_len * n2
        win = torch.from_numpy(get_window(cfg.window, cfg.win_length,
                                          cfg.periodic)).to(dev)
        library = (lambda cfg=cfg, win=win, x=x: torch.stft(
            x.float(), cfg.fft, cfg.hop, cfg.win_length, win, center=True,
            pad_mode="reflect", return_complex=True))
        yield (f"stft bf16 {label} {batch}x{x.shape[1]}", (x, cfg), flops,
               moved, library, in_row)


def lstm_weights(gen, dev, in_dim, h):
    """wx (In, 4H), wh (H, 4H), b (4H) U(+-1/sqrt(H)) as torch's init."""
    import torch

    return tuple((torch.rand(*shape, generator=gen) * 2 - 1).mul(h ** -0.5)
                 .to(dev) for shape in ((in_dim, 4 * h), (h, 4 * h),
                                        (4 * h,)))


def lstm_cases(gen, dev):
    """The four layer calls of a FullSubNet forward at B = 4 (full band
    Bf = 4, sub band Bf = 4 * 257), each also in reverse, and a ragged
    sub-band batch with a non-zero carry; then the layer shapes of the
    other families at B = 4, 32 and 256 on both designs (DPCRN's intra
    LSTM, T = 4, on the tensor-core step also at B = 4 and 5; DeepXi's
    ResLSTM, 512 -> 512 over 250 frames, the small fold), DCCRN's
    small fold in reverse and with a carry, and the sub band at T = 506 and
    1012 (the error against T). The row sums the two sub-band calls, the
    rest are per-case lines. Yardstick: cuDNN's LSTM with the same
    weights."""
    import torch

    def case(label, bf, t_len, in_dim, h, reverse=False, carry=False,
             in_row=False):
        x = torch.randn(bf, t_len, in_dim, generator=gen).to(dev)
        wx, wh, b = lstm_weights(gen, dev, in_dim, h)
        h0 = c0 = None
        if carry:
            h0, c0 = (torch.randn(bf, h, generator=gen).mul(0.5).to(dev)
                      for _ in range(2))
        lib = torch.nn.LSTM(in_dim, h, batch_first=True).to(dev)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(wx.t())
            lib.weight_hh_l0.copy_(wh.t())
            lib.bias_ih_l0.copy_(b)
            lib.bias_hh_l0.zero_()
        xl = x.flip(1) if reverse else x
        state = None if h0 is None else (h0[None], c0[None])
        flops = 2.0 * t_len * bf * (in_dim + h) * 4 * h
        moved = nbytes(x, wx, wh, b) + 4 * bf * h * (t_len + 2) + \
            (nbytes(h0, c0) if carry else 0)
        label = (f"lstm {label} {bf}x{t_len}x{in_dim}->{h}"
                 + (" reverse" if reverse else "") + (" carry" if carry
                                                      else ""))
        return (label, (x, wx, wh, b, reverse, h0, c0), flops, moved,
                lambda: lib(xl, state), in_row)

    b = B_MAIN
    for bf, (in_dim, h) in zip((b, b, b * FSN_F, b * FSN_F), FSN_LAYERS):
        for reverse in (False, True):
            # the row sums the sub band, the calls that take lstm_step_tc
            yield case("FullSubNet", bf, FSN_T, in_dim, h, reverse,
                       in_row=bf > b and not reverse)
    yield case("FullSubNet", b * FSN_F + 3, FSN_T, 384, 384, carry=True)
    for label, bf, t_len, in_dim, h, reverse, carry in (
            ("DCCRN clstm0", 2 * b, DCCRN_T, 512, 128, False, False),
            ("DCCRN clstm1", 2 * b, DCCRN_T, 128, 128, False, False),
            ("DCCRN clstm1", 2 * b, DCCRN_T, 128, 128, True, False),
            ("DCCRN clstm1", 2 * b, DCCRN_T, 128, 128, False, True),
            ("LSTMNet lstm1", b, T_FRAMES, 161, 1024, False, False),
            ("LSTMNet lstm2 / CRN", b, T_FRAMES, 1024, 1024, False, False),
            ("GCRN glstm", b, T_FRAMES, 512, 512, False, False),
            # T = 4 < SHORT_T: the tensor-core step, B = 4 and 5
            ("DPCRN intra", b * T_FRAMES, 4, 128, 64, False, False),
            ("DPCRN intra", b * T_FRAMES, 4, 128, 64, True, False),
            ("DPCRN intra B=5", 5 * T_FRAMES, 4, 128, 64, False, False),
            ("DPCRN inter", b * 4, T_FRAMES, 128, 128, False, False),
            ("DeepXi ResLSTM", b, DEEPXI_T, 512, 512, False, False),
            # phase 5's B = 32: the small fold ...
            ("LSTMNet lstm2 / CRN B=32", 32, T_FRAMES, 1024, 1024, False,
             False),
            ("GCRN glstm B=32", 32, T_FRAMES, 512, 512, False, False),
            ("DCCRN clstm0 B=32", 64, DCCRN_T, 512, 128, False, False),
            ("DPCRN inter B=32", 128, T_FRAMES, 128, 128, False, False),
            ("DeepXi ResLSTM B=32", 32, DEEPXI_T, 512, 512, False, False),
            # ... and the tensor-core step
            ("FullSubNet B=32", 32 * FSN_F, FSN_T, 384, 384, False, False),
            ("DPCRN intra B=32", 32 * T_FRAMES, 4, 128, 64, False, False),
            # phase 5's B = 256: the small fold ...
            ("GCRN glstm B=256", 256, T_FRAMES, 512, 512, False, False),
            ("DPCRN inter B=256", 1024, T_FRAMES, 128, 128, False, False),
            ("DeepXi ResLSTM B=256", 256, DEEPXI_T, 512, 512, False, False),
            # ... and the tensor-core step at H = 1024
            ("LSTMNet lstm1 B=256", 256, T_FRAMES, 161, 1024, False, False),
            ("LSTMNet lstm2 / CRN B=256", 256, T_FRAMES, 1024, 1024, False,
             False),
            # the sub band over longer inputs: error against T
            ("FullSubNet T=506", b * FSN_F, 2 * FSN_T, 384, 384, False,
             False),
            ("FullSubNet T=1012", b * FSN_F, 4 * FSN_T, 384, 384, False,
             False),
            # phase 8's streams, each call with a carry: Bf = 1 (the
            # DPCRN fold Bf = F = 4), T = 16 on the persistent design and
            # the first chunk's splits (6, 10) on the tensor-core step
            *STREAM_LSTM_CALLS):
        yield case(label, bf, t_len, in_dim, h, reverse, carry)


# (label, Bf, T, In, H, reverse, carry): the layer calls of phase 8's
# streams at chunk_frames 16 (CausalStreamer's first chunk splits at 16 -
# R: 6 for CRN and DPCRN, R = 10; the later chunks run R + 16 = 26 frames
# split at 16, then 10)
STREAM_LSTM_CALLS = (
    ("stream LSTMNet lstm1", 1, 16, 161, 1024, False, True),
    ("stream LSTMNet lstm1", 1, 6, 161, 1024, False, True),
    ("stream LSTMNet lstm2 / CRN", 1, 16, 1024, 1024, False, True),
    ("stream LSTMNet lstm2", 1, 6, 1024, 1024, False, True),
    ("stream CRN", 1, 10, 1024, 1024, False, True),
    ("stream GCRN glstm", 1, 16, 512, 512, False, True),
    ("stream DPCRN inter", 4, 16, 128, 128, False, True),
    ("stream DPCRN inter", 4, 10, 128, 128, False, True))


def check_carry_chain(dev) -> None:
    """A stream's carries, chunk after chunk: three layer calls, each fed
    the (h_T, c_T) the call before returned (T = 16, 6, 16 at Bf = 1, 1024
    -> 1024: persistent, tensor-core step, persistent; T = 10, 16, 10 at
    DPCRN's Bf = 4, 128 -> 128), against the twin's chain; and each
    returned carry again after the later calls ran, which must not have
    overwritten it (the kernels return h_T as a view of their state
    buffer: `_state` copies h0 and clones c0 into fresh buffers)."""
    import torch

    from se_tpu_torch.ops import lstm

    gen = torch.Generator().manual_seed(7)
    for bf, h, lens in ((1, 1024, (16, 6, 16)), (4, 128, (10, 16, 10))):
        wx, wh, b = lstm_weights(gen, dev, h, h)
        xs = [torch.randn(bf, t, h, generator=gen).to(dev) for t in lens]
        h0, c0 = (torch.randn(bf, h, generator=gen).mul(0.5).to(dev)
                  for _ in range(2))
        err, scale, kept = 0.0, 1.0, []
        state, twin_state = (h0, c0), (h0, c0)
        with torch.no_grad():
            for x in xs:
                ys, state = lstm.lstm_layer_kernel(x, wx, wh, b, False,
                                                   *state)
                want, twin_state = lstm._reference(x, wx, wh, b, False,
                                                   *twin_state)
                kept.append((state, tuple(t.clone() for t in state)))
                for g, w in ((ys, want), *zip(state, twin_state)):
                    err = max(err, float((g - w).abs().max()))
                    scale = max(scale, float(w.abs().max()))
            torch.cuda.synchronize()
            moved = max(float((t - c).abs().max())
                        for carry, copy_ in kept
                        for t, c in zip(carry, copy_))
        tol = 1e-4 * scale
        emit({"phase": "kernel", "kernel": "lstm",
              "case": f"carry chain {bf}x{lens}x{h}->{h}",
              "max_abs_err": err, "tol": tol,
              "returned_carry_overwritten_by": moved})
        if not err <= tol or moved != 0.0:
            fail(f"lstm carry chain Bf = {bf}, T = {lens}: error {err} > "
                 f"{tol} or a returned carry changed by {moved}")


LSTMNET_LAYERS = (("lstm1", 161), ("lstm2", 1024), ("lstm3", 1024))


def lstm_project_cases(gen, dev):
    """The small fold's projection (XP = x . Wx + b over Bf T rows) at the
    three layer calls of LSTMNet's B = 4 forward, then at DCCRN's, GCRN's
    and LSTMNet's B = 32 shapes. Yardstick: torch.addmm (cuBLAS)."""
    import torch

    def case(label, bf, t_len, in_dim, h, in_row):
        x = torch.randn(bf, t_len, in_dim, generator=gen).to(dev)
        wx, _, b = lstm_weights(gen, dev, in_dim, h)
        x2 = x.view(bf * t_len, in_dim)
        return (f"lstm_project {label} {bf}x{t_len}x{in_dim}->{4 * h}",
                (x, wx, b), 2.0 * bf * t_len * in_dim * 4 * h,
                nbytes(x, wx, b) + 4 * bf * t_len * 4 * h,
                lambda: torch.addmm(b, x2, wx), in_row)

    for label, in_dim in LSTMNET_LAYERS:
        yield case(f"LSTMNet {label}", B_MAIN, T_FRAMES, in_dim, 1024, True)
    for label, bf, t_len, in_dim, h in (
            ("DCCRN clstm0", 2 * B_MAIN, DCCRN_T, 512, 128),
            ("DCCRN clstm0 B=32", 64, DCCRN_T, 512, 128),
            ("GCRN glstm B=32", 32, T_FRAMES, 512, 512),
            ("LSTMNet lstm1 B=32", 32, T_FRAMES, 161, 1024)):
        yield case(label, bf, t_len, in_dim, h, False)


def lstm_recur_cases(gen, dev):
    """The small fold's persistent recurrence over a given XP at the three
    layer calls of LSTMNet's B = 4 forward, then DCCRN's (also in reverse
    and with a carry), GCRN's and LSTMNet's B = 32 and DPCRN's intra at
    B = 4 (1604 rows, four row chunks a block). No single PyTorch call
    computes the recurrence alone."""
    import torch

    def case(label, bf, t_len, h, in_row=False, reverse=False, carry=False):
        xp = torch.randn(bf, t_len, 4 * h, generator=gen).to(dev)
        _, wh, _ = lstm_weights(gen, dev, h, h)
        h0 = c0 = None
        if carry:
            h0, c0 = (torch.randn(bf, h, generator=gen).mul(0.5).to(dev)
                      for _ in range(2))
        moved = nbytes(xp, wh) + 4 * bf * h * (t_len + 2) + \
            (nbytes(h0, c0) if carry else 0)
        return (f"lstm_recur {label} {bf}x{t_len}x{h}"
                + (" reverse" if reverse else "") + (" carry" if carry
                                                     else ""),
                (xp, wh, reverse, h0, c0), 2.0 * bf * t_len * h * 4 * h,
                moved, None, in_row)

    for label, _ in LSTMNET_LAYERS:
        yield case(f"LSTMNet {label}", B_MAIN, T_FRAMES, 1024, in_row=True)
    yield case("DCCRN clstm", 2 * B_MAIN, DCCRN_T, 128)
    yield case("DCCRN clstm", 2 * B_MAIN, DCCRN_T, 128, reverse=True)
    yield case("DCCRN clstm", 2 * B_MAIN, DCCRN_T, 128, carry=True)
    yield case("DCCRN clstm B=32", 64, DCCRN_T, 128)
    yield case("GCRN glstm B=32", 32, T_FRAMES, 512)
    yield case("LSTMNet B=32", 32, T_FRAMES, 1024)
    yield case("DPCRN intra", B_MAIN * T_FRAMES, 4, 64)


def cudnn_lstm_bf16(dev, in_dim, h, wx, wh, b, bf, t_len, reverse=False,
                    h0=None, c0=None):
    """cuDNN's bf16 LSTM layer (torch.nn.LSTM) on the same bf16 weights
    and a bf16 x of (bf, t_len, in_dim), as a call to time: a yardstick of
    time only (it rounds elsewhere)."""
    import torch

    lib = torch.nn.LSTM(in_dim, h, batch_first=True).to(dev).to(
        torch.bfloat16)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(wx.t())
        lib.weight_hh_l0.copy_(wh.t())
        lib.bias_ih_l0.copy_(b)
        lib.bias_hh_l0.zero_()
    lib.flatten_parameters()  # else every call compacts the weights first
    x = torch.randn(bf, t_len, in_dim, device=dev).to(torch.bfloat16)
    state = None if h0 is None else (h0[None].to(torch.bfloat16),
                                     c0[None].to(torch.bfloat16))
    return lambda: lib(x.flip(1) if reverse else x, state)


def _bf16_lstm_case(gen, dev, bf, t_len, in_dim, h, x_bf16, carry=False):
    """x (fp32 or bf16), the weights rounded to bf16 (as the families' bf16
    copies hold them), and a carry."""
    import torch

    x = torch.randn(bf, t_len, in_dim, generator=gen).to(dev)
    x = x.to(torch.bfloat16) if x_bf16 else x
    wx, wh, b = (w.to(torch.bfloat16)
                 for w in lstm_weights(gen, dev, in_dim, h))
    h0 = c0 = None
    if carry:
        h0, c0 = (torch.randn(bf, h, generator=gen).mul(0.5).to(dev)
                  for _ in range(2))
    return x, wx, wh, b, h0, c0


def _x_peak(x) -> float:
    """The rate of x . W against bf16 weights: 989 TFLOP/s for a bf16 x,
    989 / 3 for an fp32 one (three bf16 pieces, the fewest exact
    products)."""
    import torch

    return PEAK_BF16_FLOPS if x.dtype == torch.bfloat16 \
        else PEAK_FP32_BF16_FLOPS


def bf16_lstm_cases(gen, dev):
    """The bf16 layer as `lstm_layer_kernel` dispatches it: FullSubNet's
    two sub-band calls of a B = 4 bf16 forward (the tensor-core step, fp32
    x; the row sums them), then per-case lines: the sub band in reverse,
    with a ragged batch and a carry, and at phase 5's B = 32; DPCRN's intra
    BiLSTM over T = 4 (the step) both ways; LSTMNet's first layer at B = 256
    (the step, bf16 x, In = 161: padded to 168 once by the wrapper);
    FullSubNet's full band (the small fold, bf16 x). Operations: x . Wx at
    989 TFLOP/s (bf16 x) or 989 / 3 (fp32 x: three bf16 pieces), round(h)
    . Wh at 989. Yardstick: cuDNN's LSTM in bf16
    on the same bf16 weights (it rounds elsewhere: a yardstick of time
    only)."""
    import torch

    def case(label, bf, t_len, in_dim, h, x_bf16=False, reverse=False,
             carry=False, in_row=False):
        x, wx, wh, b, h0, c0 = _bf16_lstm_case(gen, dev, bf, t_len, in_dim,
                                                h, x_bf16, carry)
        rows = 2.0 * t_len * bf * 4 * h
        flops = ((rows * in_dim, _x_peak(x)), (rows * h, PEAK_BF16_FLOPS))
        moved = nbytes(x, wx, wh, b) + 4 * bf * h * (t_len + 2) + \
            (nbytes(h0, c0) if carry else 0)
        label = (f"lstm bf16 {label} {bf}x{t_len}x{in_dim}->{h} x "
                 f"{'bf16' if x_bf16 else 'fp32'}"
                 + (" reverse" if reverse else "")
                 + (" carry" if carry else ""))
        return (label, (x, wx, wh, b, reverse, h0, c0), flops, moved,
                cudnn_lstm_bf16(dev, in_dim, h, wx, wh, b, bf, t_len,
                                reverse, h0, c0), in_row)

    b = B_MAIN
    for in_dim, h in FSN_LAYERS[2:]:
        yield case("FullSubNet sub band", b * FSN_F, FSN_T, in_dim, h,
                   in_row=True)
    yield case("FullSubNet sub band", b * FSN_F, FSN_T, 384, 384,
               reverse=True)
    yield case("FullSubNet sub band", b * FSN_F + 3, FSN_T, 384, 384,
               carry=True)
    yield case("FullSubNet sub band B=32", 32 * FSN_F, FSN_T, 384, 384)
    for reverse in (False, True):
        yield case("DPCRN intra", b * T_FRAMES, 4, 128, 64, reverse=reverse)
    yield case("LSTMNet lstm1 B=256", 256, T_FRAMES, 161, 1024, x_bf16=True)
    yield case("FullSubNet full band (small fold)", b, FSN_T, FSN_F, 512,
               x_bf16=True)


def bf16_lstm_project_cases(gen, dev):
    """The bf16 projection (fp32 XP, lstm_proj_bf16) at the three layer
    calls of LSTMNet's B = 4 bf16 forward (lstm1: bf16 x, In = 161, padded
    to 168 by the wrapper; lstm2: fp32 x), then FullSubNet's full band
    (bf16 x, In = 257), GCRN's and DPCRN's inter (fp32 x), and H = 12 and
    100 (4H not a whole 64-column tile; In 161 and 100). Yardstick:
    torch.addmm on the widened operands (the library call); cuDNN's bf16
    LSTM layer, the projection and the recurrence in one call, is timed at
    the same layer shapes by `bf16_lstm_recur_cases`."""
    import torch

    def case(label, bf, t_len, in_dim, h, x_bf16, in_row=False):
        x, wx, _, b, _, _ = _bf16_lstm_case(gen, dev, bf, t_len, in_dim,
                                            h, x_bf16)
        x2, wx2, b2 = x.view(bf * t_len, in_dim).float(), wx.float(), \
            b.float()
        return (f"lstm_project bf16 {label} {bf}x{t_len}x{in_dim}->{4 * h} "
                f"x {'bf16' if x_bf16 else 'fp32'}", (x, wx, b),
                ((2.0 * bf * t_len * in_dim * 4 * h, _x_peak(x)),),
                nbytes(x, wx, b) + 4 * bf * t_len * 4 * h,
                lambda: torch.addmm(b2, x2, wx2), in_row)

    for (label, in_dim), x_bf16 in zip(LSTMNET_LAYERS, (True, False, False)):
        yield case(f"LSTMNet {label}", B_MAIN, T_FRAMES, in_dim, 1024,
                   x_bf16, True)
    yield case("FullSubNet full band", B_MAIN, FSN_T, FSN_F, 512, True)
    yield case("GCRN glstm", B_MAIN, T_FRAMES, 512, 512, False)
    yield case("DPCRN inter", 4 * B_MAIN, T_FRAMES, 128, 128, False)
    yield case("H=12", 5, 33, 161, 12, True)
    yield case("H=100", 37, 40, 100, 100, False)


def bf16_lstm_recur_cases(gen, dev):
    """The bf16 recurrence (lstm_recur_bf16: fp32 XP, bf16 Wh, h rounded to
    bf16 where the product takes it, exact products) at the three layer
    calls of LSTMNet's B = 4 bf16 forward, then DPCRN's inter, GCRN's,
    FullSubNet's full band and DCCRN's (also in reverse and with a
    carry), and H = 12 and 100 (K and the unit tiles padded), reverse and
    with a carry. Yardstick: cuDNN's bf16 LSTM layer at the layer's shape
    (In, H: the projection and the recurrence in one call), one call a
    shape (LSTMNet's lstm2 and lstm3 share theirs; `check_kernels` times
    it once)."""
    import torch

    layers = {}

    def case(label, bf, t_len, h, in_dim=None, in_row=False, reverse=False,
             carry=False):
        in_dim = in_dim or h
        xp = torch.randn(bf, t_len, 4 * h, generator=gen).to(dev)
        wx, wh, b = (w.to(torch.bfloat16)
                     for w in lstm_weights(gen, dev, in_dim, h))
        h0 = c0 = None
        if carry:
            h0, c0 = (torch.randn(bf, h, generator=gen).mul(0.5).to(dev)
                      for _ in range(2))
        moved = nbytes(xp, wh) + 4 * bf * h * (t_len + 2) + \
            (nbytes(h0, c0) if carry else 0)
        shape = (bf, t_len, in_dim, h, reverse, carry)
        if shape not in layers:
            layers[shape] = cudnn_lstm_bf16(dev, in_dim, h, wx, wh, b, bf,
                                            t_len, reverse, h0, c0)
        return (f"lstm_recur bf16 {label} {bf}x{t_len}x{h}"
                + (" reverse" if reverse else "") + (" carry" if carry
                                                     else ""),
                (xp, wh, reverse, h0, c0),
                ((2.0 * bf * t_len * h * 4 * h, PEAK_BF16_FLOPS),), moved,
                layers[shape], in_row)

    for label, in_dim in LSTMNET_LAYERS:
        yield case(f"LSTMNet {label}", B_MAIN, T_FRAMES, 1024, in_dim,
                   in_row=True)
    yield case("DPCRN inter", 4 * B_MAIN, T_FRAMES, 128)
    yield case("GCRN glstm", B_MAIN, T_FRAMES, 512)
    yield case("FullSubNet full band", B_MAIN, FSN_T, 512, FSN_F)
    yield case("DCCRN clstm", 2 * B_MAIN, DCCRN_T, 128, 512, reverse=True)
    yield case("DCCRN clstm", 2 * B_MAIN, DCCRN_T, 128, 512, carry=True)
    yield case("H=12", 5, 33, 12, 161, reverse=True)
    yield case("H=100", 37, 40, 100, carry=True)


# (family, In -> H, Bf at B, T) of every LSTM layer call on the main paths
LSTM_CALLS = (("FullSubNet full band", 512, lambda b: b, FSN_T),
              ("FullSubNet sub band", 384, lambda b: FSN_F * b, FSN_T),
              ("DCCRN clstm", 128, lambda b: 2 * b, DCCRN_T),
              ("LSTMNet / CRN", 1024, lambda b: b, T_FRAMES),
              ("GCRN glstm", 512, lambda b: b, T_FRAMES),
              ("DPCRN intra", 64, lambda b: T_FRAMES * b, 4),
              ("DPCRN inter", 128, lambda b: 4 * b, T_FRAMES),
              ("DeepXi ResLSTM", 512, lambda b: b, DEEPXI_T))


def check_recur_plans(dev, dtype) -> None:
    """For every small-fold layer call of the main paths at B = 4, 32 and
    256: the shared memory ops/lstm.py plans for the recurrence's block in
    the variant of `dtype` (`persistent_plan`: fp32, 8 units a block; bf16,
    the units and warps it picks of `recur_bf16_designs`) is that
    variant's kernel's, and the occupancy API lets as many blocks share an
    SM as the plan assumes (else the C entry refuses the launch)."""
    import torch

    from se_tpu_torch.ops import _build, lstm

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    checked = []
    name = _build.variant("lstm_recur", dtype)
    for label, h, fold, t_len in LSTM_CALLS:
        for batch in (4, 32, 256):
            bf = fold(batch)
            if lstm.step_variant(bf, t_len, h, sms, dtype) != "persistent":
                continue
            plan = lstm.persistent_plan(bf, h, sms, dtype)
            smem, per_sm = lstm.recur_fit(h, plan.chunks, dev, dtype,
                                          plan.tile, plan.warps)
            checked.append({"call": f"{label} B={batch}", "bf": bf, "h": h,
                            "tile": plan.tile, "warps": plan.warps,
                            "blocks": plan.blocks,
                            "plan_smem": plan.smem, "kernel_smem": smem,
                            "plan_blocks_sm": plan.blocks_sm,
                            "occupancy_blocks_sm": per_sm})
            if smem != plan.smem or per_sm < plan.blocks_sm:
                fail(f"{name} plan for {label} B={batch}: {checked[-1]}")
    emit({"phase": "kernel", "kernel": name,
          "check": "persistent_plan against the kernel's shared memory "
          "and occupancy", "calls": checked})


def stft_cases(gen, dev):
    """The STFT of each spectral family's B = 4 forward (DCCRN's 512/128
    sums in the row), then pad_end and valid framing, two n_fft that run
    generic radix stages (384: a radix 3; 2048: past the default shared
    memory), then the three center presets at phase 5's B = 32 and 256. The bound is the function's, not
    any kernel's: a real FFT a frame (2.5 n log2 n flops) plus the window's
    frame_len products, and the bytes of the waveform in and the spectrum
    out (no basis: an FFT reads none). Yardstick for the center cases:
    torch.stft (cuFFT)."""
    import math

    import torch

    from se_tpu_torch.ops import stft as plain
    from se_tpu_torch.ops.windows import get_window

    center = (("DCCRN 512/128 k=4", plain.PRESET_512_128),
              ("FullSubNet 512/256 k=2", plain.PRESET_512_256),
              ("PRESET_320 320/160 k=2", plain.PRESET_320))
    cases = [(label, cfg, B_MAIN, i == 0) for i, (label, cfg)
             in enumerate(center)]
    cases += [("pad_end hamming 512/256", plain.StftConfig(
                  512, 256, 512, window="hamming", convention="pad_end"),
               B_MAIN, False),
              ("valid 400/100", plain.StftConfig(400, 100, 512,
                                                 convention="valid"),
               B_MAIN, False),
              ("center 384/128 radix 4 4 4 3", plain.StftConfig(384, 128,
                                                                384),
               B_MAIN, False),
              ("center 2048/512", plain.StftConfig(2048, 512, 2048), B_MAIN,
               False)]
    cases += [(label, cfg, batch, False) for batch in (32, 256)
              for label, cfg in center]
    waves = {}
    for label, cfg, batch, in_row in cases:
        if batch not in waves:
            waves.clear()  # one batch on the card at a time
            waves[batch] = torch.randn(batch, SECONDS * SR,
                                       generator=gen).mul(0.1).to(dev)
        x = waves[batch]
        t_len, n2 = plain.num_frames(x.shape[1], cfg), 2 * cfg.bins
        flops = batch * t_len * (2.5 * cfg.fft * math.log2(cfg.fft)
                                 + cfg.frame_len)
        moved = nbytes(x) + 4 * batch * t_len * n2
        library = None
        if cfg.convention == "center":
            win = torch.from_numpy(get_window(cfg.window, cfg.win_length,
                                              cfg.periodic)).to(dev)
            library = (lambda cfg=cfg, win=win, x=x: torch.stft(
                x, cfg.fft, cfg.hop, cfg.win_length, win, center=True,
                pad_mode="reflect", return_complex=True))
        yield (f"stft {label} {batch}x{x.shape[1]}", (x, cfg), flops, moved,
               library, in_row)


def _flat_lstm(fn):
    def run(*args, **kw):
        ys, (h, c) = fn(*args, **kw)
        return ys, h, c
    return run


def check_kernels(dev, only) -> dict:
    """Phase 3 for the kernels named in `only`. A row sums, over the cases
    of the forward its note names, its ms, twin ms, bound and yardstick ms;
    every case counts in its error."""
    import torch

    from se_tpu_torch.ops import lstm, stft_fused

    gen = torch.Generator().manual_seed(1)
    # name: () -> (kernel, twin, cases, source, replaces, launches per
    # timing, what the row sums), built only for the kernels asked for, so
    # the script also measures an older package that lacks a newer kernel
    b4 = f"one B = {B_MAIN} x {SECONDS} s forward"
    kinds = {
        "attention": lambda: (
            _att_kernel, _att_twin, attention_cases,
            "se_tpu_torch/csrc/attention.cu",
            "se_tpu/ops/pallas_attention.py:53", 10,
            f"the 4 calls of Uformer's {b4}: the T-attention (L = 401) on "
            "the tensor cores (att_flash_tc), the F-attention (L = 4) on "
            "the CUDA cores (att_small_l); B = 32 and the other design are "
            "per-case lines"),
        "dsconv": lambda: (
            _block_kernel, _block_twin, dsconv_cases,
            "se_tpu_torch/csrc/dsconv.cu", "se_tpu/ops/pallas_dsconv.py:113",
            10, "the 16 DSConvCplx / DSConvReal module forwards of phase "
            "4c's path (Uformer's block shapes at B = 4): "
            "dsconv_block_pre_tc + dsconv_block_post_tc a call, on the "
            "tensor cores (Uformer's stage runs dsconv_pair)"),
        "dsconv_pair": lambda: (
            _pair_kernel, _pair_twin, pair_cases,
            "se_tpu_torch/csrc/dsconv.cu", "se_tpu/ops/pallas_dsconv.py:325",
            10, f"the 8 stages of Uformer's {b4}: dsconv_pre_tc + "
            "dsconv_post_tc a stage, on the tensor cores; B = 32 is a "
            "per-case line"),
        "encoder": lambda: (
            _encoder_kernel, _encoder_twin, encoder_cases,
            "se_tpu_torch/csrc/encoder.cu", "se_tpu/ops/pallas_encoder.py:98",
            10, f"the 6 levels of Uformer's {b4}: level 0 on the CUDA "
            "cores (encoder_level_cc), 1-5 on the tensor cores "
            "(encoder_level_tc)"),
        "decoder": lambda: (
            _decoder_kernel, _decoder_twin, decoder_cases,
            "se_tpu_torch/csrc/decoder.cu",
            "se_tpu/ops/pallas_decoder.py:117", 10,
            f"the 6 levels of Uformer's {b4}: levels 0-4 on the tensor "
            "cores (decoder_level_tc), 5 on the CUDA cores "
            "(decoder_level_cc)"),
        "lstm": lambda: (
            _flat_lstm(lstm.lstm_layer_kernel), _flat_lstm(lstm._reference),
            lstm_cases, "se_tpu_torch/csrc/lstm.cu",
            "se_tpu/ops/pallas_lstm.py:60", 2,
            "lstm_step_tc, a launch a frame: the 2 sub-band layer calls of "
            f"FullSubNet's {b4}; its full band takes the small fold (rows "
            "lstm_project, lstm_recur); every case runs the layer as "
            "lstm_layer_kernel dispatches it, the other shapes are "
            "per-case lines"),
        "lstm_project": lambda: (
            lstm.lstm_project, lstm._project_reference, lstm_project_cases,
            "se_tpu_torch/csrc/lstm.cu", "se_tpu/ops/pallas_lstm.py:60", 10,
            "lstm_proj_tc, the small fold's projection (inside the TPU "
            f"kernel's body, :44): the 3 layer calls of LSTMNet's {b4}"),
        "lstm_recur": lambda: (
            _flat_lstm(lstm.lstm_recur), _flat_lstm(lstm._recur_reference),
            lstm_recur_cases, "se_tpu_torch/csrc/lstm.cu",
            "se_tpu/ops/pallas_lstm.py:60", 2,
            "lstm_recur_persistent, the small fold's time loop in one "
            f"launch: the 3 layer calls of LSTMNet's {b4}"),
        "stft": lambda: (
            stft_fused.stft_fused, stft_fused._reference, stft_cases,
            "se_tpu_torch/csrc/stft.cu", "se_tpu/ops/pallas_stft.py:67", 10,
            f"the 1 call of DCCRN's {b4}; the other presets and B = 32 "
            "and 256 are per-case lines"),
        # the bf16 variants: against the bf16 twin (`_dtype.bf16_compare`)
        # and, reported, the fp32 twin on the same bf16 values; the bound at
        # bf16 bytes and PEAK_BF16_FLOPS (the pair: its products have an
        # fp32 operand, PEAK_FP32_BF16_FLOPS)
        "attention_bf16": lambda: (
            _att_kernel, _att_twin, bf16_attention_cases,
            "se_tpu_torch/csrc/attention.cu",
            "se_tpu/ops/pallas_attention.py:53", 10,
            f"the 4 calls of Uformer's {b4} in bf16: att_flash_bf16 (T, "
            "L = 401: two sweeps over K, bf16 mma.sync m16n8k16 from a "
            "bf16 cp.async ring), att_small_l<.., bf16> (F, L = 4); B = 32 "
            "per-case lines",
            {"peak": PEAK_BF16_FLOPS, "slack": True}),
        "dsconv_pair_bf16": lambda: (
            _pair_kernel, _pair_twin, bf16_pair_cases,
            "se_tpu_torch/csrc/dsconv.cu", "se_tpu/ops/pallas_dsconv.py:325",
            10, f"the 8 stages of Uformer's {b4} in bf16: dsconv_pre_bf16 "
            "+ dsconv_post_bf16 a stage (bf16 mma.sync m16n8k16 from a "
            "bf16 cp.async ring, bf16 packs; each fp32 operand, LN1's "
            "output, y's taps and z, in three bf16 pieces); B = 32 and "
            "C = 12 and Cm 4 + 4 (the widened route) per-case lines",
            {"peak": PEAK_FP32_BF16_FLOPS}),
        "dsconv_bf16": lambda: (
            _block_kernel, _block_twin,
            lambda gen, dev: itertools.chain(
                bf16_dsconv_cases(gen, dev),
                bf16_dsconv_widened_cases(gen, dev)),
            "se_tpu_torch/csrc/dsconv.cu", "se_tpu/ops/pallas_dsconv.py:113",
            10, "the 16 DSConvCplx / DSConvReal module forwards of phase "
            "4c's bf16 path (Uformer's block shapes at B = 4): "
            "dsconv_block_pre_bf16 + dsconv_block_post_bf16 a call (bf16 "
            "mma.sync m16n8k16 from a bf16 cp.async ring, bf16 packs; each "
            "fp32 operand, LN1's output, y's taps and z, in three bf16 "
            "pieces); B = 32 and Cin 12, Cm 8 (the widened route) per-case "
            "lines",
            {"peak": PEAK_FP32_BF16_FLOPS}),
        "stft_bf16": lambda: (
            stft_fused.stft_fused, stft_fused._reference, bf16_stft_cases,
            "se_tpu_torch/csrc/stft.cu", "se_tpu/ops/pallas_stft.py:67", 10,
            "stft_basis_bf16, the bf16 basis product on the CUDA cores "
            "(fp32 out): phase 4c's stft_auto call, DCCRN's 512/128 at "
            "B = 4; B = 32 per-case lines",
            {"peak": PEAK_BF16_FLOPS, "fp32_out": True}),
        "encoder_bf16": lambda: (
            _encoder_kernel, _encoder_twin, bf16_encoder_cases,
            "se_tpu_torch/csrc/encoder.cu", "se_tpu/ops/pallas_encoder.py:98",
            10, f"the 6 levels of Uformer's {b4} in bf16: "
            "encoder_level_cc<bf16> (0), encoder_level_tc_bf16 (1-5: bf16 "
            "mma.sync m16n8k16 from a bf16 cp.async ring, bf16 packs, one "
            "product a k16); B = 32 per-case lines",
            {"peak": PEAK_BF16_FLOPS}),
        "decoder_bf16": lambda: (
            _decoder_kernel, _decoder_twin, bf16_decoder_cases,
            "se_tpu_torch/csrc/decoder.cu",
            "se_tpu/ops/pallas_decoder.py:117", 10,
            f"the 6 levels of Uformer's {b4} in bf16: "
            "decoder_level_tc_bf16 (0-4: bf16 mma.sync m16n8k16 from a "
            "bf16 cp.async ring, bf16 packs, one product a k16), "
            "decoder_level_cc<.., bf16> (5); B = 32 and Cc = 12 (the "
            "widened route) per-case lines",
            {"peak": PEAK_BF16_FLOPS}),
        # the bf16 LSTM: weights bf16, x fp32 or bf16, XP, h, c and y
        # fp32, so its errors are fp32 sums in another order (the mma's
        # accumulation over K = 1024: ~2e-5 of XP's ~4) and it is held as
        # the fp32 rows are, 1e-4 * max(1, max|twin|), against its bf16
        # twin: the projection as it is, the recurrences stepped along the
        # kernel's own y (`h_in`), and free-running also within
        # bf16_compare with LSTM_FLOOR (each side rounds its own h to bf16:
        # a flip now and then). Operations at each product's rate (cases
        # give (flops, peak) pairs)
        "lstm_bf16": lambda: (
            _flat_lstm(lstm.lstm_layer_kernel), _flat_lstm(lstm._reference),
            bf16_lstm_cases, "se_tpu_torch/csrc/lstm.cu",
            "se_tpu/ops/pallas_lstm.py:60", 2,
            "lstm_step_bf16<float|bf16> a frame (bf16 mma.sync "
            "m16n8k16: an fp32 x in three bf16 pieces, a bf16 x and the "
            "bf16 shadow of h in one product each): the 2 "
            f"sub-band layer calls of FullSubNet's {b4} in bf16; its full "
            "band takes the small fold (rows lstm_project_bf16, "
            "lstm_recur_bf16); the other shapes are per-case lines",
            {"peak": None, "fp32_out": True, "stepped": True}),
        "lstm_project_bf16": lambda: (
            lstm.lstm_project, lstm._project_reference,
            bf16_lstm_project_cases, "se_tpu_torch/csrc/lstm.cu",
            "se_tpu/ops/pallas_lstm.py:60", 10,
            "lstm_proj_bf16<float|bf16>, XP fp32 (bf16 mma.sync m16n8k16 "
            "from the bf16 cp.async ring, bfr::ring: lstm1's bf16 x in one "
            "product, lstm2's fp32 x in three bf16 pieces): the 3 layer "
            f"calls of LSTMNet's {b4} in bf16; cuDNN's bf16 LSTM layer at "
            "these shapes: row lstm_recur_bf16's library_ms",
            {"peak": None, "fp32_out": True}),
        "lstm_recur_bf16": lambda: (
            _flat_lstm(lstm.lstm_recur), _flat_lstm(lstm._recur_reference),
            bf16_lstm_recur_cases, "se_tpu_torch/csrc/lstm.cu",
            "se_tpu/ops/pallas_lstm.py:60", 2,
            "lstm_recur_bf16<units, warps> (the Wh slice in bf16 shared "
            "memory, h from the bf16 shadow by cp.async, bf16 mma.sync "
            f"m16n8k16): the 3 layer calls of LSTMNet's {b4} in bf16; "
            "library: cuDNN's bf16 LSTM layer at the same shapes",
            {"peak": None, "fp32_out": True, "stepped": True}),
    }
    if "lstm_recur" in only:
        check_recur_plans(dev, torch.float32)
    if "lstm_recur_bf16" in only:
        check_recur_plans(dev, torch.bfloat16)
    if "lstm" in only:
        check_carry_chain(dev)
    table = {}
    for name, kind in kinds.items():
        if name not in only:
            continue
        kernel, twin, cases, source, replaces, reps, note, *extra = kind()
        extra = extra[0] if extra else None
        row_start = time.perf_counter()
        peak = extra["peak"] if extra else PEAK_FP32_ACCURATE_FLOPS
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
               "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": None, "note": note}
        t_ops = t_bytes = 0.0
        shared_lib = shared_ms = shared_dev = None
        for label, args, flops, moved, library, in_row in cases(gen, dev):
            # consecutive cases that share a library call time it once
            if library is not shared_lib:
                shared_lib = shared_ms = shared_dev = None
            with torch.no_grad():
                got = kernel(*args)
                want = twin(*args)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                if extra is None:
                    err = max(float((g - w).abs().max())
                              for g, w in zip(got, want))
                    scale = max(1.0, max(float(w.abs().max())
                                         for w in want))
                    tol, ok, checks = 1e-4 * scale, None, {}
                else:
                    from se_tpu_torch.ops._dtype import (
                        BF16_FLOOR, FLIP_SHARE, LSTM_FLOOR, att_flip_slack,
                        bf16_compare, to_float,
                    )
                    slack = ([att_flip_slack(*args[:4])]
                             if "slack" in extra else None)
                    floor = LSTM_FLOOR if "stepped" in extra else BF16_FLOOR
                    err, _, past, differ, ok = bf16_compare(got, want,
                                                            slack, floor)
                    want32 = twin(*to_float(args))
                    want32 = want32 if isinstance(want32, tuple) \
                        else (want32,)
                    err32 = max(float((g.float() - w).abs().max())
                                for g, w in zip(got, want32))
                    tol = f"2^-7 |twin| + {floor:g} max|twin|" + (
                        f"; P's flip slack on <= {FLIP_SHARE}"
                        if slack else "")
                    checks = {"share_past_strict": past,
                              "share_differing": differ,
                              "max_abs_err_vs_fp32_twin": err32}
                    if "fp32_out" in extra:
                        # the fp32 rows' rule, against the twin stepped
                        # along the kernel's y where it recurs; and the
                        # share past bf16_compare's 1e-6 floor, reported
                        checks["share_past_1e-6_floor"] = bf16_compare(
                            got, want).share_past
                        ref = (twin(*args, h_in=got[0])
                               if "stepped" in extra else want)
                        err_fp = max(float((g - w).abs().max())
                                     for g, w in zip(got, ref))
                        tol_fp = 1e-4 * max(1.0, max(
                            float(w.abs().max()) for w in ref))
                        checks.update({"max_abs_err_fp32_rule": err_fp,
                                       "tol_fp32_rule": tol_fp})
                        if "stepped" in extra:
                            tol += "; stepped: 1e-4 max(1, max|twin|)"
                        else:
                            ok, tol = True, "1e-4 max(1, max|twin|)"
                        ok = ok and err_fp <= tol_fp
                        del ref
                    del slack, want32
                del got, want
                # 5 rounds after 3 where the row sums the case, 3 after 1
                # for the per-case lines (the script's time limit)
                ms = cuda_ms(lambda: kernel(*args), reps=reps,
                             **({} if in_row else {"rounds": 3, "warm": 1}))
                # the twin, no yardstick of speed: 3 runs after 1, where
                # the row sums it (elsewhere it only cost the script time)
                plain = cuda_ms(lambda: twin(*args), reps=reps, rounds=3,
                                warm=1) if in_row else None
                if library is not None and shared_lib is None:
                    shared_lib = library
                    shared_ms = cuda_ms(library, reps=reps)
                lib = shared_ms
            b_ms, b_by = bound(flops, moved, peak)
            line = {"phase": "kernel", "kernel": name, "case": label,
                    "max_abs_err": err, "tol": tol, **checks, "ms": ms,
                    "plain_ms": plain, "library_ms": lib,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "gflop": total_flops(flops) / 1e9,
                    "mbytes": moved / 1e6, "in_row": in_row}
            # where the event time goes, for the cases the row sums
            if in_row and (name in DEVICE_SPLIT or extra):
                with torch.no_grad():
                    line["device_ms"] = device_ms(lambda: kernel(*args))
                    if library is not None:
                        if shared_dev is None:
                            shared_dev = device_ms(library)
                        line["library_device_ms"] = shared_dev
            if name in PER_FRAME and "device_ms" in line:
                frames = args[0].shape[1]
                line["us_per_frame"] = 1e3 * sum(
                    t for k, t in line["device_ms"].items()
                    if "lstm_recur" in k) / frames
                line["bound_us_per_frame"] = 1e3 * b_ms / frames
            emit(line)
            if ok is False or (ok is None and not err <= tol):
                fail(f"{label}: kernel and twin differ by {err} > {tol}")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if extra is not None:
                row["max_abs_err_vs_fp32_twin"] = max(
                    row.get("max_abs_err_vs_fp32_twin", 0.0),
                    checks["max_abs_err_vs_fp32_twin"])
            if not in_row:
                continue
            row["ms"] += ms
            row["plain_ms"] += plain
            row["bound_ms"] += b_ms
            if lib is not None:
                row["library_ms"] = (row["library_ms"] or 0.0) + lib
            t_ops += ops_seconds(flops, peak)
            t_bytes += moved / PEAK_BYTES
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        row["check_s"] = time.perf_counter() - row_start
        table[name] = row
    return table


# ------------------------------------------------------------- main path

def seeded(name: str, seed: int, **kw):
    """Family `name` at its published widths on the CPU from a seed
    (torch's init), BN statistics and every norm's affine (BN; the TCM
    families' instance and cumulative norms; DeepXi's LayerNorms, where
    they have a scale or a bias), the per-channel PReLU slopes and
    CTSNet's ShareSepConv kernels (else a pure time shift) moved off
    their defaults. The DeepXi names build DeepXi with their network
    (DEEPXI_NETWORK) at its shipped width."""
    import torch

    from se_tpu_torch.models import get_model
    from se_tpu_torch.nn import (
        BatchNorm, CumulativeLayerNorm1d, CumulativeLayerNorm2d, InstanceNorm,
        OnePassLayerNorm, PReLU, ShareSepConv,
    )

    tcm_norms = (CumulativeLayerNorm1d, CumulativeLayerNorm2d, InstanceNorm)
    gen = torch.Generator().manual_seed(seed)
    if name in DEEPXI_NETWORK:
        name, kw = "deepxi", {"network": DEEPXI_NETWORK[name], **kw}
    model = get_model(name).make(device="cpu", generator=gen, **kw)

    def draw(t, scale, shift=0.0):
        t.copy_(shift + scale * torch.randn(t.shape, generator=gen))

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                c = mod.weight.shape[0]
                mod.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(c, generator=gen))
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(c, generator=gen))
            elif isinstance(mod, tcm_norms):
                scale = mod.weight if hasattr(mod, "weight") else mod.gain
                draw(scale, 0.1, 1.0)
                draw(mod.bias, 0.1)
            elif isinstance(mod, PReLU) and mod.weight.numel() > 1:
                draw(mod.weight, 0.05, 0.25)
            elif isinstance(mod, ShareSepConv):
                draw(mod.weight, 0.05, 0.25)
            elif isinstance(mod, OnePassLayerNorm):
                if mod.weight is not None:
                    draw(mod.weight, 0.1, 1.0)
                if mod.bias is not None:
                    draw(mod.bias, 0.1)
    return model.eval()


# family: the launches a B = 4 forward must show (None: at least one; 0:
# none). The LSTM layer calls: FullSubNet 2 full band (small fold) + 2 sub
# band (the tensor-core step, `lstm`); DCCRN 2 complex LSTMs x (real,
# imag); LSTMNet 1 + 2; CRN 2; GCRN 2 groups x 2 stages, all small folds
# (a projection and a persistent recurrence each); DPCRN x the block
# applied twice: intra 2 layers x 2 directions over T = 4 bins (the
# tensor-core step) + inter 2 layers (small fold).
# The TCM families (CTSNet, TaylorSENet, G2Net) run cuDNN's convs and torch
# ops around the STFT kernel: one launch, every other kernel none. So does
# DeepXi's ResNetV2 (cuBLAS GEMMs, cuDNN's dilated convs, torch ops);
# its ResLSTM adds 5 LSTM layers 512 -> 512 on Bf = B, the small fold
# at every B of phases 4-5 (a projection and a persistent recurrence each).
ONLY_STFT = {"attention": 0, "dsconv": 0, "dsconv_pair": 0, "encoder": 0,
             "decoder": 0, "lstm": 0, "lstm_project": 0, "lstm_recur": 0,
             "stft": 1}
TCM_FAMILIES = ("ctsnet", "taylorsenet", "g2net")
# the two DeepXi paths: the shipped ResNetV2 and the ResLSTM variant, each
# at its default width (DeepXi's registry variants "resnet", "reslstm")
DEEPXI_NETWORK = {"deepxi": "ResNetV2", "deepxi_reslstm": "ResLSTM"}
MAIN_PATHS = {
    "uformer": {"attention": 4, "dsconv_pair": 8, "encoder": 6,
                "decoder": 6},
    "fullsubnet": {"lstm": 2, "lstm_project": 2, "lstm_recur": 2,
                   "stft": 1},
    "dccrn": {"lstm": 0, "lstm_project": 4, "lstm_recur": 4, "stft": 1},
    "lstm": {"lstm": 0, "lstm_project": 3, "lstm_recur": 3, "stft": 1},
    "crn": {"lstm": 0, "lstm_project": 2, "lstm_recur": 2, "stft": 1},
    "gcrn": {"lstm": 0, "lstm_project": 4, "lstm_recur": 4, "stft": 1},
    "dpcrn": {"lstm": 8, "lstm_project": 4, "lstm_recur": 4, "stft": 1},
    **{name: ONLY_STFT for name in TCM_FAMILIES},
    "deepxi": ONLY_STFT,
    "deepxi_reslstm": {**ONLY_STFT, "lstm_project": 5, "lstm_recur": 5},
}
# kernels whose phase-3 lines carry the device time by kernel name
# (torch.profiler) beside the CUDA-event time
DEVICE_SPLIT = ("stft", "encoder", "dsconv_pair", "attention", "dsconv")
# the bf16 recurrence: the row's cases also their device time a frame
PER_FRAME = ("lstm_recur_bf16",)
# family: the kernel names its phase-6 profile reports (and must show, for
# the families of PROFILE_GATED)
PROFILE_KERNELS = {
    "uformer": ("encoder_level_cc", "encoder_level_tc", "dsconv_pre_tc",
                "dsconv_post_tc", "decoder_level_tc", "decoder_level_cc",
                "att_flash_tc", "att_small_l"),
    "deepxi": ("stft_fft",),
    "deepxi_reslstm": ("stft_fft", "lstm_proj_tc", "lstm_recur_persistent"),
}
PROFILE_GATED = ("uformer",)
# family: the launches of a bf16 B = 4 forward (phase 4b): Uformer's four
# kernels in their bf16 variants and no fp32 kernel; the TCM families the
# fp32 STFT kernel (the spectral branch takes its STFT in fp32, as se_tpu)
# and nothing else; the six LSTM families the fp32 STFT and their fp32
# path's LSTM launches in the bf16 variants (MAIN_PATHS), no fp32 LSTM
# launch
BF16_KERNELS = {"attention_bf16": 4, "dsconv_pair_bf16": 8,
                "encoder_bf16": 6, "decoder_bf16": 6}
LSTM_KERNELS = ("lstm", "lstm_project", "lstm_recur")
LSTM_FAMILIES = ("fullsubnet", "dccrn", "lstm", "crn", "gcrn", "dpcrn")
BF16_PATHS = {
    "uformer": {**{k: 0 for k in ONLY_STFT}, **BF16_KERNELS},
    **{name: {**ONLY_STFT, **{k: 0 for k in BF16_KERNELS}}
       for name in TCM_FAMILIES},
    **{name: {**ONLY_STFT, **{k: 0 for k in BF16_KERNELS},
              **{f"{k}_bf16": MAIN_PATHS[name][k] for k in LSTM_KERNELS}}
       for name in LSTM_FAMILIES},
}
# family: the bf16 variants' kernel names its bf16 profile reports (each
# also with "bfloat16" in its signature); Uformer's must show each
# (PROFILE_GATED)
_LSTM_PROJ_RECUR_BF16 = ("lstm_proj_bf16", "lstm_recur_bf16")
PROFILE_KERNELS_BF16 = {
    "uformer": ("att_flash_bf16", "att_small_l", "encoder_level_cc",
                "encoder_level_tc_bf16", "decoder_level_tc_bf16",
                "decoder_level_cc", "dsconv_pre_bf16", "dsconv_post_bf16"),
    **{name: _LSTM_PROJ_RECUR_BF16 for name in ("dccrn", "lstm", "crn",
                                                "gcrn")},
    "fullsubnet": ("lstm_step_bf16",) + _LSTM_PROJ_RECUR_BF16,
    "dpcrn": ("lstm_step_bf16",) + _LSTM_PROJ_RECUR_BF16,
}
# kernel: the main path whose B = 4 forward its row of the table sums
ROW_PATH = {"attention": "uformer", "dsconv": "conformer blocks",
            "dsconv_pair": "uformer", "encoder": "uformer",
            "decoder": "uformer", "lstm": "fullsubnet",
            "lstm_project": "lstm", "lstm_recur": "lstm", "stft": "dccrn",
            **{k: "uformer bf16" for k in BF16_KERNELS},
            "lstm_bf16": "fullsubnet bf16", "lstm_project_bf16": "lstm bf16",
            "lstm_recur_bf16": "lstm bf16",
            "dsconv_bf16": "conformer blocks bf16", "stft_bf16": "stft bf16"}
# phase 4c, the entry points that run the single block and the bf16 STFT:
# the launches each must show
ENTRY_PATHS = {
    "conformer blocks": {"dsconv": 16, "dsconv_bf16": 0},
    "conformer blocks bf16": {"dsconv": 0, "dsconv_bf16": 16},
    "stft bf16": {"stft": 0, "stft_bf16": 1},
}
# families whose B = 256 batch takes the large-fold step (lstm_step_tc;
# in bf16 lstm_step_bf16) in some layer call: phase 5 checks one of its
# utterances against the CPU
TC_BATCH_CHECK = ("lstm", "crn", "dpcrn")


def waveforms(batch: int, seed: int):
    import numpy as np

    return (np.random.default_rng(seed).standard_normal(
        (batch, SECONDS * SR)) * 0.1).astype(np.float32)


@functools.lru_cache(maxsize=1)
def deepxi_xi_map():
    """DeepXi's DBNormalCDF map, fitted once by `compute_xi_stats` on the
    CPU from 8 seeded 4 s pairs (clean: noise-like, a slow envelope on
    each; noise: white at 0.3 of it), shared by the card and the CPU."""
    import numpy as np

    from se_tpu_torch.models.deepxi import XiMap, compute_xi_stats

    t = np.arange(SECONDS * SR) / SR
    envelope = 0.55 + 0.45 * np.sin(2 * np.pi * 3.0 * t)
    clean = waveforms(8, 300) * envelope.astype(np.float32)
    noise = waveforms(8, 301) * 0.3
    return compute_xi_stats(list(clean), list(noise), XiMap("DBNormalCDF"),
                            device="cpu")


def run_enhance(name: str, model, wav, device=None, dtype=None):
    """Enhance `wav` (B, n) with `model` on `device` (None: the card) as
    the family's users do, to numpy: `enhance_waveform` (in `dtype`), or
    for DeepXi `models.deepxi.enhance` with the fitted map (the hybrid
    io-kind has no branch in `enhance_waveform`)."""
    if name in DEEPXI_NETWORK:
        from se_tpu_torch.models.deepxi import enhance

        return enhance(model, wav, deepxi_xi_map(),
                       length=wav.shape[-1]).cpu().numpy()
    from se_tpu_torch.eval.enhance import enhance_waveform

    return enhance_waveform(name, model, wav, device=device, dtype=dtype)


def card_vs_cpu(name: str, est, cpu_model, wav, index: int, check: str):
    """Utterance `index` of the card's batch output against the same
    weights run on the CPU on that utterance alone."""
    import numpy as np

    ref = run_enhance(name, cpu_model, wav[index:index + 1], "cpu")[0]
    err = float(np.abs(est[index] - ref).max())
    tol = 1e-3 * float(np.abs(ref).max())
    emit({"phase": "main", "model": name, "check": check,
          "max_abs_err": err, "tol": tol})
    if not err <= tol:
        fail(f"{name}: {check}: card output differs from the CPU's by "
             f"{err} > {tol}")


def main_path(name: str, dev, launches):
    """Phase 4 for one model: its launch counts and the card against the
    CPU. Returns the model on the card, the model on the CPU and the
    counts."""
    import numpy as np

    from se_tpu_torch.eval.enhance import enhance_waveform

    required = MAIN_PATHS[name]
    cpu_model = seeded(name, 0)
    model = copy.deepcopy(cpu_model).to(dev)
    wav = waveforms(B_MAIN, 0)
    if name in DEEPXI_NETWORK:
        deepxi_xi_map()  # fitted before the count starts

    launches.clear()
    est = run_enhance(name, model, wav)
    counts = dict(launches)
    emit({"phase": "main", "model": name, "launches": counts,
          "shape": list(est.shape)})
    for kernel, want in required.items():
        got = counts.get(kernel, 0)
        ok = got > 0 if want is None else got == want
        if not ok:
            fail(f"{name}: a B = {B_MAIN} forward launched {kernel} {got} "
                 f"times, expected {'at least 1' if want is None else want}")
    if est.shape != wav.shape or not np.isfinite(est).all():
        fail(f"{name}: enhanced output of shape {est.shape} is not "
             "finite/complete")
    card_vs_cpu(name, est, cpu_model, wav, 0, "card vs cpu, utterance 0")
    if name in TCM_FAMILIES:  # the other norm variant, InstanceNorm
        cpu_in = seeded(name, 1, norm="in")
        est = enhance_waveform(name, copy.deepcopy(cpu_in).to(dev), wav)
        card_vs_cpu(name, est, cpu_in, wav, 0,
                    "card vs cpu, utterance 0, norm in")
    return model, cpu_model, counts


def bf16_path(name: str, model, cpu_model, launches) -> dict:
    """Phase 4b for one family: `enhance_waveform(dtype=torch.bfloat16)`
    on B = 4 x 4 s on the card with the counts set to 0 just before and
    read just after (BF16_PATHS: Uformer's bf16 variants 4 / 8 / 6 / 6 and
    no fp32 kernel; the TCM families the fp32 STFT once; the LSTM families
    the fp32 STFT and their LSTM launches in the bf16 variants only), the
    output finite and complete; then utterance 0 against the same weights
    on the CPU in bf16 and in fp32 (`bf16_card_vs_cpu`). Returns the
    counts."""
    import numpy as np
    import torch

    wav = waveforms(B_MAIN, 0)
    launches.clear()
    est = run_enhance(name, model, wav, dtype=torch.bfloat16)
    counts = dict(launches)
    emit({"phase": "main bf16", "model": name, "launches": counts,
          "shape": list(est.shape)})
    for kernel, want in BF16_PATHS[name].items():
        got = counts.get(kernel, 0)
        if got != want:
            fail(f"{name} bf16: a B = {B_MAIN} forward launched {kernel} "
                 f"{got} times, expected {want}")
    if est.shape != wav.shape or not np.isfinite(est).all():
        fail(f"{name} bf16: enhanced output of shape {est.shape} is not "
             "finite/complete")
    bf16_card_vs_cpu(name, est, cpu_model, wav, 0,
                     "card bf16 vs cpu, utterance 0")
    return counts


def entry_paths(uformer_model, dev, launches) -> dict:
    """Phase 4c: the paths of the single DSConv block and the bf16 STFT,
    the entry points a user calls. Uformer's 16 DSConvCplx / DSConvReal
    modules (phase 4's weights on the card) in eval on B = 4 x 401 x 4
    inputs (256 and 128 channels), then bf16 copies of them on the same
    inputs in bf16, then `stft_auto` on DCCRN's 512/128 with a bf16 B = 4
    x 4 s waveform; counts set to 0 just before each path and read just
    after (ENTRY_PATHS). Each block's output against its twin on the same
    inputs (fp32: 1e-4 * max(1, max|twin|); bf16: `bf16_compare`), the
    spectrum against its twin (1e-4 * max(1, max|twin|)). Returns the
    counts by path."""
    import torch

    from se_tpu_torch.ops import dsconv, stft_fused
    from se_tpu_torch.ops._dtype import bf16_compare
    from se_tpu_torch.ops.stft import PRESET_512_128

    conf = uformer_model.conformer
    blocks = [*conf.dsconv_cplx, *conf.dsconv_real]
    gen = torch.Generator().manual_seed(7)
    inputs = {c: torch.randn(B_MAIN, T_FRAMES, 4, c, generator=gen).to(dev)
              for c in (256, 128)}
    counts, errs = {}, {}
    for path, dtype in (("conformer blocks", torch.float32),
                        ("conformer blocks bf16", torch.bfloat16)):
        mods = [copy.deepcopy(b).to(dtype) if dtype != torch.float32
                else b for b in blocks]
        xs = [inputs[b.layernorm_conv1.weight.shape[0] * b.ncomp].to(dtype)
              for b in mods]
        for m, x in zip(mods, xs):  # the packs, made before the count
            m.weights()
        with torch.no_grad():
            launches.clear()
            outs = [m(x) for m, x in zip(mods, xs)]
            counts[path] = dict(launches)
            worst = 0.0
            for m, x, out in zip(mods, xs, outs):
                want = dsconv._reference(x, m.params(), m.dilation1,
                                         m.dilation2, m.ncomp)
                if dtype == torch.float32:
                    err = float((out - want).abs().max())
                    tol = 1e-4 * max(1.0, float(want.abs().max()))
                    ok = err <= tol
                    worst = max(worst, err / tol)
                else:
                    check = bf16_compare([out], [want])
                    ok, err = check.ok, check.max_abs_err
                    worst = max(worst, err)
                if not ok:
                    fail(f"{path}: a block's output differs from its twin "
                         f"by {err}")
            errs[path] = worst
        del mods, outs
    wav = torch.from_numpy(waveforms(B_MAIN, 0)).to(dev).to(torch.bfloat16)
    with torch.no_grad():
        launches.clear()
        got = stft_fused.stft_auto(wav, PRESET_512_128)
        counts["stft bf16"] = dict(launches)
        want = stft_fused._reference(wav, PRESET_512_128)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    tol = 1e-4 * max(1.0, max(float(w.abs().max()) for w in want))
    if not err <= tol or got[0].dtype != torch.float32:
        fail(f"stft bf16: {got[0].dtype} spectrum {err} from its twin, past "
             f"{tol}")
    errs["stft bf16"] = err
    for path, want_counts in ENTRY_PATHS.items():
        for kernel, n in want_counts.items():
            if counts[path].get(kernel, 0) != n:
                fail(f"{path}: launched {kernel} "
                     f"{counts[path].get(kernel, 0)} times, expected {n}")
    emit({"phase": "entry", "launches": counts,
          "worst": {"conformer blocks (err / tol)":
                    errs["conformer blocks"],
                    "conformer blocks bf16 (max abs err)":
                    errs["conformer blocks bf16"],
                    "stft bf16 (max abs err)": errs["stft bf16"]}})
    return counts


def bf16_card_vs_cpu(name: str, est, cpu_model, wav, index: int,
                     check: str) -> None:
    """Utterance `index` of the card's bf16 batch output against the same
    weights on the CPU on that utterance alone, in bf16 and in fp32: the
    card's distance from each (max |err| / max |cpu fp32|) within twice
    the CPU bf16's own distance from fp32 (PERF.md section 2)."""
    import numpy as np
    import torch

    one = wav[index:index + 1]
    cpu32 = run_enhance(name, cpu_model, one, "cpu")[0]
    cpu16 = run_enhance(name, cpu_model, one, "cpu", torch.bfloat16)[0]
    scale = float(np.abs(cpu32).max())

    def dist(a, b):
        return float(np.abs(a - b).max()) / scale

    e_cpu = dist(cpu16, cpu32)
    e32, e16 = dist(est[index], cpu32), dist(est[index], cpu16)
    emit({"phase": "main bf16", "model": name, "check": check,
          "cpu_bf16_vs_cpu_fp32": e_cpu, "card_bf16_vs_cpu_fp32": e32,
          "card_bf16_vs_cpu_bf16": e16, "limit": 2 * e_cpu})
    if not (e32 <= 2 * e_cpu and e16 <= 2 * e_cpu):
        fail(f"{name} bf16: {check}: the card's output is {e32} from the "
             f"CPU fp32 and {e16} from the CPU bf16, past twice the CPU "
             f"bf16's own distance {e_cpu}")


def forward_gflop(name: str, model) -> dict:
    """The operations of one 4 s utterance's enhance call: the GEMMs and
    convolutions torch.utils.flop_counter sees (2 per multiply-add), and
    for the LSTM kernels (ctypes calls it cannot see) 2 T (In + H) 4H a
    layer call, In = H = 512 for DeepXi's ResLSTM."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        run_enhance(name, model, waveforms(1, 2))
    lstm = MAIN_PATHS[name]["lstm_recur"] * 2.0 * DEEPXI_T * 1024 * 2048
    return {"gflop_torch_ops": counter.get_total_flops() / 1e9,
            "gflop_lstm_kernels": lstm / 1e9}


def throughput(name: str, model, cpu_model, card: str, dtype=None) -> None:
    import torch

    flops = forward_gflop(name, model) if name in DEEPXI_NETWORK else {}
    for batch in (32, 256):
        wav = waveforms(batch, batch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        est = run_enhance(name, model, wav, dtype=dtype)  # warm-up
        warm_s = time.perf_counter() - t0
        if batch == 256 and name in TC_BATCH_CHECK:
            check = (f"card vs cpu, utterance {batch - 1} of a B = {batch} "
                     "batch "
                     + ("(lstm_step_tc)" if dtype is None
                        else "(lstm_step_bf16)"))
            if dtype is None:
                card_vs_cpu(name, est, cpu_model, wav, batch - 1, check)
            else:
                bf16_card_vs_cpu(name, est, cpu_model, wav, batch - 1,
                                 check.replace("card", "card bf16", 1))
        del est
        repeats = 2 if warm_s > SLOW_CALL_S else 3
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run_enhance(name, model, wav, dtype=dtype)
            times.append(time.perf_counter() - t0)
        rates = [batch * SECONDS / t for t in times]
        line = {"phase": "speed",
                "metric": f"{name}_enhance_{'bf16' if dtype else 'fp32'}",
                "batch": batch, "seconds_audio": SECONDS,
                "audio_s_per_s": statistics.median(rates),
                "min": min(rates), "max": max(rates), "repeats": repeats,
                "warmup_s": warm_s,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "card": card, **flops}
        if flops:  # operations a second, all utterances of the median call
            gflop = flops["gflop_torch_ops"] + flops["gflop_lstm_kernels"]
            line["tflop_per_s"] = gflop * line["audio_s_per_s"] \
                / SECONDS / 1e3
        if repeats < 5:
            line["note"] = (f"the warm-up call took {warm_s:.1f} s > "
                            f"{SLOW_CALL_S:.0f} s: 2 timed calls, not 5")
        emit(line)


# torch.profiler drops some of a call's events now and then (PERF.md
# section 7: in full runs DeepXi's profiles lost the call's first events,
# its STFT among them, attempt after attempt): a profile that misses a
# kernel of PROFILE_KERNELS is taken again, up to this many times in all
PROFILE_ATTEMPTS = 5


def profile(name: str, model, card: str, dtype=None) -> None:
    """Device time by kernel over one enhance call at B = 32 x 4 s (in
    `dtype`), and the device's busy share of the call's wall time (one
    stream: kernels do not overlap). The line names the attempt it
    reports, and the kernels of PROFILE_KERNELS (bf16: each of
    PROFILE_KERNELS_BF16 with "bfloat16" in its signature) its last
    attempt still missed (`missing`): a failure for the families of
    PROFILE_GATED."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    wav = waveforms(32, 1)
    run_enhance(name, model, wav, dtype=dtype)
    if dtype is None:
        want = PROFILE_KERNELS.get(name, ())

        def match(k, key):
            return k in key
    else:
        want = PROFILE_KERNELS_BF16.get(name, ())

        def match(k, key):
            return k in key and "bfloat16" in key
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_enhance(name, model, wav, dtype=dtype)
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only: the host ops that launched them carry
        # the same device time and would count it twice
        rows = [(evt.device_time_total / 1e3, evt.count, evt.key)
                for evt in prof.key_averages()
                if evt.device_type == DeviceType.CUDA]
        missing = [k for k in want
                   if not any(match(k, key) for _, _, key in rows)]
        if not missing:
            break
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    seen = {k: sum(ms for ms, _, key in rows if match(k, key))
            for k in want}
    emit({"phase": "profile",
          "model": name + (" bf16" if dtype else ""), "batch": 32,
          "wall_ms": wall_ms, "device_ms": device_ms,
          "device_busy_share": device_ms / wall_ms if wall_ms else None,
          "top": [{"ms": ms, "calls": n, "name": key[:90]}
                  for ms, n, key in rows[:12]], "kernels_ms": seen,
          "attempt": attempt, "missing": missing, "card": card})
    if missing and name in PROFILE_GATED:
        fail(f"{name}: {PROFILE_ATTEMPTS} profiles show no "
             f"{', '.join(missing)}")


# ------------------------------------------------------------ phase 7: train

# kernel: its backward (ops/_autograd.py kernel_call), as its row names it
BACKWARD = {
    "attention": "VJP of ops/attention.py _reference, recomputed",
    "dsconv": "VJP of ops/dsconv.py _reference, recomputed",
    "dsconv_pair": "VJP of ops/dsconv.py _pair_reference, recomputed",
    "encoder": "VJP of ops/encoder.py _reference, recomputed",
    "decoder": "VJP of ops/decoder.py _reference, recomputed",
    "lstm": "VJP of ops/lstm.py _chunked_reference (chunks of 32 frames, "
            "each checkpointed), recomputed",
    "lstm_project": "VJP of ops/lstm.py _project_reference, recomputed",
    "lstm_recur": "VJP of ops/lstm.py _recur_reference, recomputed",
    "stft": "none: stft_fused raises on an input that requires grad "
            "(se_tpu's stft_pallas has no VJP)",
    "attention_bf16": "VJP of ops/attention.py _reference in bf16 (P "
                      "rounded to bf16), recomputed",
    "lstm_bf16": "VJP of ops/lstm.py _chunked_reference with bf16 weights, "
                 "recomputed",
    "lstm_project_bf16": "VJP of ops/lstm.py _project_reference with bf16 "
                         "weights, recomputed",
    "lstm_recur_bf16": "VJP of ops/lstm.py _recur_reference with a bf16 "
                       "wh, recomputed",
    **{k: "not on any train path: Uformer trains its levels and DSConv "
          "blocks on the plain path, as se_tpu's train mode"
       for k in (*BF16_KERNELS, "dsconv_bf16") if k != "attention_bf16"},
    "stft_bf16": "none: stft_fused raises on an input that requires grad "
                 "(se_tpu's stft_pallas has no VJP)",
}
# family: the launches of one train step (one forward; the backward runs
# the twins). Uformer's train mode runs its U-net levels and DSConv blocks
# on the plain path, as se_tpu does; DPCRN's features come through the
# STFT kernel (mix and clean) under no_grad.
# FullSubNet's sub band (drop_band: 128 B rows at B = 4, 8 x 24 = 192
# tensor-core blocks) takes the step, its full band the small fold; the
# other LSTM families their phase-4 layer calls (MAIN_PATHS).
TRAIN_PATHS = {
    "uformer": {"attention": 4, "encoder": 0, "decoder": 0,
                "dsconv_pair": 0, "dsconv": 0},
    "fullsubnet": {**ONLY_STFT, "lstm": 2, "lstm_project": 2,
                   "lstm_recur": 2, "stft": 2},
    **{name: {**ONLY_STFT, **MAIN_PATHS[name], "stft": 2}
       for name in ("dccrn", "gcrn", "crn", "lstm")},
    "dpcrn": {"lstm": 8, "lstm_project": 4, "lstm_recur": 4, "stft": 2},
    **{name: {**ONLY_STFT, "stft": 2} for name in TCM_FAMILIES},
    # DeepXi's driver step: MagXi's example takes the STFT of s, d and x
    "deepxi": {**ONLY_STFT, "stft": 3},
    "deepxi_reslstm": {**ONLY_STFT, "stft": 3, "lstm_project": 5,
                       "lstm_recur": 5},
}
TRAIN_BATCH = 32  # bench.py's train default, 4 s utterances
# the batch of phase 7b/7c and 7e's steps: 2, but FullSubNet 4, whose
# training sub band needs 128 B >= 512 rows to take the tensor-core step
# (at B = 2 its 256 rows, 4 x 24 blocks, would take the small fold and
# `lstm` would never run under autograd)
TRAIN_B = {"fullsubnet": 4}
# family: the losses phase 7b/7c trains it with (DCCRN also fusion_snr,
# which synthesises the waveforms inside the loss: the iSTFT under
# autograd)
TRAIN_LOSSES = {"dccrn": ("default", "fusion_snr")}
# family: the launches of one bf16 train step (phase 7e). Uformer the bf16
# attention 4 times and no other kernel (its levels and DSConv blocks on
# the plain path, its STFT torch's); the LSTM families the fp32 STFT
# twice (`_prep`, fp32 under no_grad, as se_tpu's) and their train step's
# LSTM launches in the bf16 variants, no fp32 LSTM launch; the TCM
# families the fp32 STFT twice and nothing else.
_NO_BF16 = {**{k: 0 for k in BF16_KERNELS},
            **{f"{k}_bf16": 0 for k in LSTM_KERNELS}}
BF16_TRAIN_PATHS = {
    "uformer": {**{k: 0 for k in ONLY_STFT}, **_NO_BF16,
                "attention_bf16": 4},
    **{name: {**ONLY_STFT, **_NO_BF16, "stft": 2,
              **{f"{k}_bf16": TRAIN_PATHS[name][k] for k in LSTM_KERNELS}}
       for name in ("fullsubnet", "dccrn", "gcrn", "crn", "lstm",
                    "dpcrn")},
    **{name: {**ONLY_STFT, **_NO_BF16, "stft": 2} for name in TCM_FAMILIES},
}
# fp32 round-off at a step's gradient scale: the share of its largest
# |gradient| entry that phase 7b/7c adds to every tensor's tolerance
GRAD_FLOOR = 1e-6


def _leaves(nest, dev):
    """`nest` (tuples of tensors and other values) with each tensor a fresh
    leaf on `dev` that requires grad."""
    import torch

    if isinstance(nest, tuple):
        return tuple(_leaves(a, dev) for a in nest)
    if isinstance(nest, torch.Tensor):
        return nest.detach().to(dev).requires_grad_()
    return nest


def _tensors(nest):
    import torch

    if isinstance(nest, tuple):
        return [t for a in nest for t in _tensors(a)]
    return [nest] if isinstance(nest, torch.Tensor) else []


def grad_case(kernel_name, label, wrapper, twin, args, dev, launches,
              counter, floor=None):
    """The wrapper's Function on CUDA leaves of `args` against the twin's
    own autograd on the same values and upstream gradients: each input's
    gradient in the input's dtype and within 1e-4 * max(1, max|twin
    grad|), or, with `floor` (bf16 inputs), within `bf16_compare` with
    that floor; the forward adds one to the launch count `counter` and its
    outputs carry a grad_fn. Returns the error."""
    import torch

    from se_tpu_torch.ops._dtype import bf16_compare

    runs = []
    for fn in (wrapper, twin):
        ins = _leaves(args, dev)
        before = launches[counter]
        outs = _tensors(fn(*ins))
        runs.append((_tensors(ins), outs, launches[counter] - before))
    (ins_k, outs_k, launched), (ins_t, outs_t, _) = runs
    diff = [i for i, o in enumerate(outs_k) if o.requires_grad]
    if not diff or any(outs_k[i].grad_fn is None for i in diff):
        fail(f"{label}: the wrapper's output has no grad_fn")
    if launched != 1:
        fail(f"{label}: the forward launched {counter} {launched} times")
    gen = torch.Generator().manual_seed(7)
    gs = [torch.randn(outs_k[i].shape, generator=gen).to(dev) for i in diff]
    got = torch.autograd.grad([outs_k[i] for i in diff], ins_k, gs,
                              allow_unused=True)
    want = torch.autograd.grad([outs_t[i] for i in diff], ins_t, gs,
                               allow_unused=True)
    torch.cuda.synchronize()
    worst, worst_ratio, pairs = 0.0, 0.0, []
    for a, w, x in zip(got, want, ins_k):
        if (a is None) != (w is None):
            fail(f"{label}: the Function and the twin differ in which "
                 "inputs get a gradient")
        if w is None:
            continue
        if a.dtype != x.dtype:
            fail(f"{label}: a {x.dtype} input's gradient is {a.dtype}")
        pairs.append((a, w))
        err = float((a - w).abs().max())
        tol = 1e-4 * max(1.0, float(w.abs().max()))
        worst, worst_ratio = max(worst, err), max(worst_ratio, err / tol)
    line = {"phase": "train", "check": "gradient", "kernel": kernel_name,
            "case": label, "max_abs_err": worst, "inputs": len(ins_k)}
    if floor is None:
        ok = worst_ratio <= 1.0
        line["err_over_tol"] = worst_ratio
    else:
        check = bf16_compare(*zip(*pairs), floor=floor)
        ok = check.ok
        line.update(rule=f"bf16_compare, floor {floor}",
                    share_past=check.share_past,
                    share_differing=check.share_differing)
    emit(line)
    if not ok:
        fail(f"{label}: Function and twin gradients differ past the "
             "tolerance")
    return worst


def check_gradients(dev, only, launches) -> dict:
    """Phase 7a: each kernel's Function against its twin's autograd at a
    B = 4 phase-3 case of each design; the STFT's refusal. A case is
    (label, wrapper, twin, args, the launch count its forward adds to)."""
    import torch

    from se_tpu_torch.ops import (
        attention, decoder, dsconv, encoder, lstm, stft_fused,
    )
    from se_tpu_torch.ops._dtype import BF16_FLOOR, LSTM_FLOOR
    from se_tpu_torch.ops.stft import PRESET_320

    gen = torch.Generator().manual_seed(3)
    b, t = B_MAIN, T_FRAMES

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    cases = {"attention": [], "lstm": [], "lstm_project": [],
             "lstm_recur": [], "encoder": [], "decoder": [], "dsconv": [],
             "dsconv_pair": [], "attention_bf16": [], "lstm_bf16": [],
             "lstm_project_bf16": [], "lstm_recur_bf16": []}
    for n, h, l, design in ((b * 4, 8, t, "flash_tc"),
                            (b * t, 8, 4, "small_l")):
        cases["attention"].append((
            f"attention {n}x{h}x{l}x16 design={design}",
            lambda q, k, v: attention.sdp_attention(q, k, v, 0.25),
            lambda q, k, v: attention._reference(q, k, v, 0.25),
            tuple(r(n, h, l, 16, scale=0.5) for _ in range(3)),
            "attention"))
    for label, bf, t_len, in_dim, h, counter in (
            ("DPCRN inter (lstm_proj_tc + lstm_recur_persistent)", b * 4,
             t, 128, 128, "lstm_recur"),
            ("DPCRN intra (lstm_step_tc)", b * t, 4, 128, 64, "lstm")):
        for reverse in (False, True):
            weights = tuple(w.cpu() for w in lstm_weights(gen, "cpu",
                                                          in_dim, h))
            cases["lstm"].append((
                f"lstm {label} {bf}x{t_len}x{in_dim}->{h}"
                + (" reverse" if reverse else ""),
                lambda *a, rv=reverse: lstm.lstm_layer_kernel(*a, rv),
                lambda *a, rv=reverse: lstm._reference(*a, rv),
                (r(bf, t_len, in_dim), *weights), counter))
    wx, wh, bias = lstm_weights(gen, "cpu", 161, 1024)
    cases["lstm_project"].append((
        f"lstm_project LSTMNet lstm1 {b}x{t}x161->4096", lstm.lstm_project,
        lstm._project_reference, (r(b, t, 161), wx, bias), "lstm_project"))
    _, wh, _ = lstm_weights(gen, "cpu", 128, 128)
    cases["lstm_recur"].append((
        f"lstm_recur DPCRN inter {b * 4}x{t}x128",
        lambda xp, wh: lstm.lstm_recur(xp, wh),
        lambda xp, wh: lstm._recur_reference(xp, wh),
        (r(b * 4, t, 512), wh), "lstm_recur"))
    for level in (0, 1):  # the CUDA-core design, a tensor-core level
        f, cin, cout = 256 >> level, KERNELS[level], KERNELS[level + 1]
        shapes = ((2, 5, 2 * cin, 2 * cout), (1, 2 * cout), (1, 2 * cout),
                  (1, 2 * cout), (1, 1), (2, 5, cin, cout), (1, cout),
                  (1, cout), (1, cout), (1, 1))
        cases["encoder"].append((
            f"encoder level {level} {b}x{t}x{f}x{cin}->{cout} design="
            f"{encoder.level_design(cin)}", encoder.encoder_level,
            encoder._reference,
            (r(b, t, f, 2 * cin), r(b, t, f, cin),
             level_params(gen, shapes, "cpu")), "encoder"))
    for level in (4, 5):  # a tensor-core level, the CUDA-core design
        f, cc, cout = 4 << level, 2 * KERNELS[6 - level], KERNELS[5 - level]
        has_bn = level < 5
        shapes = ((6, 2 * cc, 2 * cout), (4, 2 * cc, 2 * cout),
                  (1, 2 * cout), (1, 2 * cout), (1, 2 * cout), (1, 1),
                  (6, cc, cout), (4, cc, cout), (1, cout), (1, cout),
                  (1, cout), (1, 1))
        cases["decoder"].append((
            f"decoder level {level} {b}x{t}x{f}x{cc}->{cout} design="
            f"{decoder.level_design(cc, cout)}",
            lambda a, m, p, hb=has_bn: decoder.decoder_level(a, m, p, hb),
            lambda a, m, p, hb=has_bn: decoder._reference(a, m, p, hb),
            (r(b, t, f, 2 * cc), r(b, t, f, cc),
             level_params(gen, shapes, "cpu")), "decoder"))
    for ncomp, cin, tot in ((2, 256, 64), (1, 128, 32)):
        cases["dsconv"].append((
            f"dsconv ncomp={ncomp} {b}x{t}x4x{cin} d=(1,128)",
            lambda x, p, nc=ncomp: dsconv.dsconv_block(x, p, 1, 128, nc),
            lambda x, p, nc=ncomp: dsconv._reference(x, p, 1, 128, nc),
            (r(b, t, 4, cin, scale=0.5),
             dsconv_params(gen, cin, tot, "cpu")), "dsconv"))
    cases["dsconv_pair"].append((
        f"dsconv_pair {b}x{t}x4x(256+128) d=(1,128)",
        lambda *a: dsconv.dsconv_pair_block(*a, 1, 128),
        lambda *a: dsconv._pair_reference(*a, 1, 128),
        (r(b, t, 4, 256, scale=0.5), r(b, t, 4, 128, scale=0.5),
         dsconv_params(gen, 256, 64, "cpu"),
         dsconv_params(gen, 128, 32, "cpu")), "dsconv_pair"))

    bf16 = torch.bfloat16
    for n, h, l, design in ((b * 4, 8, t, "flash_tc"),
                            (b * t, 8, 4, "small_l")):
        cases["attention_bf16"].append((
            f"attention_bf16 {n}x{h}x{l}x16 design={design}",
            lambda q, k, v: attention.sdp_attention(q, k, v, 0.25),
            lambda q, k, v: attention._reference(q, k, v, 0.25),
            tuple(r(n, h, l, 16, scale=0.5).to(bf16) for _ in range(3)),
            "attention_bf16", BF16_FLOOR))
    # the bf16 LSTM: DPCRN's intra layer on the step with x fp32 and bf16,
    # LSTMNet's first projection and DPCRN's inter recurrence alone; bf16
    # weights, the recurrences held with one bf16 ulp of the largest
    # gradient as the floor (LSTM_FLOOR)
    wx, wh, bias = (w.to(bf16) for w in lstm_weights(gen, "cpu", 128, 64))
    for x_dtype in (torch.float32, bf16):
        cases["lstm_bf16"].append((
            f"lstm_bf16 DPCRN intra (lstm_step_bf16) {b * t}x4x128->64 "
            f"x {x_dtype}", lstm.lstm_layer_kernel, lstm._reference,
            (r(b * t, 4, 128).to(x_dtype), wx, wh, bias), "lstm_bf16",
            LSTM_FLOOR))
    wx, _, bias = (w.to(bf16) for w in lstm_weights(gen, "cpu", 161, 1024))
    cases["lstm_project_bf16"].append((
        f"lstm_project_bf16 LSTMNet lstm1 {b}x{t}x161->4096",
        lstm.lstm_project, lstm._project_reference,
        (r(b, t, 161), wx, bias), "lstm_project_bf16", BF16_FLOOR))
    _, wh, _ = lstm_weights(gen, "cpu", 128, 128)
    cases["lstm_recur_bf16"].append((
        f"lstm_recur_bf16 DPCRN inter {b * 4}x{t}x128",
        lambda xp, wh: lstm.lstm_recur(xp, wh),
        lambda xp, wh: lstm._recur_reference(xp, wh),
        (r(b * 4, t, 512), wh.to(bf16)), "lstm_recur_bf16", LSTM_FLOOR))

    errors = {}
    for name, kernel_cases in cases.items():
        if name not in only:
            continue
        errors[name] = max(grad_case(name, label, wrapper, twin, args, dev,
                                     launches, *rest)
                           for label, wrapper, twin, args, *rest
                           in kernel_cases)
        torch.cuda.empty_cache()
    if "stft" in only:
        x = r(2, SECONDS * SR).to(dev).requires_grad_()
        try:
            stft_fused.stft_fused(x, PRESET_320)
        except ValueError as exc:
            emit({"phase": "train", "check": "stft refuses grad",
                  "message": str(exc)})
        else:
            fail("stft_fused returned an output for an input that requires "
                 "grad")
    return errors


def _train_batch(batch: int, dev, seed: int) -> dict:
    """B utterances of 4 s: noise-like `clean` plus 0.5 x another draw as
    the mix; every frame valid."""
    import numpy as np
    import torch

    clean = waveforms(batch, seed)
    noise = waveforms(batch, seed + 1) * 0.5
    n = clean.shape[1]
    return {"mix": torch.from_numpy(clean + noise).to(dev),
            "clean": torch.from_numpy(clean).to(dev),
            "frames": torch.full((batch,), n // HOP + 1, dtype=torch.int64,
                                 device=dev)}


def _dropout(model, rate: float) -> None:
    from se_tpu_torch.nn import Dropout

    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.rate = rate


# a PReLU or ReLU input this close to 0, relative to the call's largest
# |x|, is within the round-off by which two fp32 forwards differ
PRELU_KINK = 1e-5


def replay_branch(x, own, mask, seen: dict, label: str):
    """The branch each element of x takes in a replayed step: its `own`,
    or the recorded `mask` where |x| <= PRELU_KINK * max|x| of the call.
    A recorded branch that differs from `own` further from 0 fails,
    naming `label`; `seen` counts the calls, the elements taken from the
    record against their own (`flips`) and their largest |x| / max|x|
    (`flip_max_rel`)."""
    import torch

    if mask is None or mask.shape != x.shape:
        fail("a replayed step called its kinks otherwise than the recorded "
             "one")
    mask = mask.to(x.device)
    seen["calls"] += 1
    flip = mask != own
    ax = x.detach().abs()
    top = ax.max()
    if bool(flip.any()):
        rel = float(ax[flip].max()) / max(float(top), 1e-30)
        if not rel <= PRELU_KINK:
            fail(f"{label}: the card's branch differs at |x| = {rel} x "
                 f"max|x| of the call, past the round-off bound "
                 f"{PRELU_KINK}")
        seen["flips"] += int(flip.sum())
        seen["flip_max_rel"] = max(seen["flip_max_rel"], rel)
    return torch.where(ax <= PRELU_KINK * top, mask, own)


@contextlib.contextmanager
def prelu_branches(model, masks: list, record: bool):
    """While open, every PReLU call of `model` records its branch (x >= 0)
    into `masks` (`record`), or takes the branch recorded at the same call
    of an earlier step where its own |x| <= PRELU_KINK * max|x| of the
    call, and its own branch elsewhere (`replay_branch`). An input within
    round-off of the kink has two valid subgradients, 1 and the slope:
    two steps that should give the same gradients must take the same
    one. The dict it yields counts the calls and the elements whose
    branch was taken from the record against their own."""
    import torch

    from se_tpu_torch.nn import PReLU

    names = {id(m): n for n, m in model.named_modules()}
    real = PReLU.forward
    calls = iter(masks)
    seen = {"calls": 0, "flips": 0, "flip_max_rel": 0.0}

    def forward(self, x):
        if record:
            masks.append((x >= 0).cpu())
            return real(self, x)
        take = replay_branch(x, x >= 0, next(calls, None), seen,
                             f"PReLU {names.get(id(self), '?')}")
        return torch.where(take, x, self.weight * x)

    PReLU.forward = forward
    try:
        yield seen
        if not record and seen["calls"] != len(masks):
            fail(f"a replayed step made {seen['calls']} PReLU calls, the "
                 f"recorded one {len(masks)}")
    finally:
        PReLU.forward = real


@contextlib.contextmanager
def relu_branches(masks: list, record: bool):
    """`prelu_branches` for DeepXi's ReLUs (`F.relu` in models/deepxi.py,
    the branch x > 0, as torch's relu differentiates it): 40 ResNetV2
    blocks hold ~8e6 ReLU inputs a step at B = 2 x 4 s (384 a frame a
    block), some within round-off of 0, whose gradient is 1 on one side
    and 0 on the other."""
    import torch
    import torch.nn.functional as F

    from se_tpu_torch.models import deepxi

    calls = iter(masks)
    seen = {"calls": 0, "flips": 0, "flip_max_rel": 0.0}

    class Functional:  # torch.nn.functional, its relu replayed
        def __getattr__(self, name):
            return getattr(F, name)

        @staticmethod
        def relu(x):
            if record:
                masks.append((x > 0).cpu())
                return F.relu(x)
            take = replay_branch(x, x > 0, next(calls, None), seen,
                                 f"ReLU call {seen['calls']}")
            return torch.where(take, x, torch.zeros_like(x))

    deepxi.F = Functional()
    try:
        yield seen
        if not record and seen["calls"] != len(masks):
            fail(f"a replayed step made {seen['calls']} ReLU calls, the "
                 f"recorded one {len(masks)}")
    finally:
        deepxi.F = F


def grads_vs_cpu(card: dict, cpu: dict, exact: dict) -> dict:
    """Phase 7b's gradient check: each tensor of the card's step (name ->
    fp64 CPU tensor) within tol = 1e-3 * max|grad| + GRAD_FLOOR * the
    step's largest |grad| entry of the CPU's fp32 gradient, or within
    max(tol, twice the CPU's fp32 distance) of the fp64 gradient (see
    `train_vs_cpu`). Returns the worst ratio to that tolerance
    (`grad_err_over_tol`), every tensor's (ratio, name, ratio to the fp32 CPU's
    tolerance) largest first (`rows`), the floor, the tensors held to the
    fp64 step and the CPU's three largest fp32 distances from it."""
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in exact.values())
    rows, by_exact, cpu_rel = [], [], []
    for k, g64 in exact.items():
        tol = 1e-3 * float(cpu[k].abs().max()) + floor
        vs_cpu = float((card[k] - cpu[k]).abs().max())
        cpu_off = float((cpu[k] - g64).abs().max())
        card_off = float((card[k] - g64).abs().max())
        if float(g64.abs().max()) > floor:  # how far fp32 strays, relative
            cpu_rel.append((cpu_off / float(g64.abs().max()), k))
        if vs_cpu > tol:  # the CPU's fp32 gradient strays
            by_exact.append((k, card_off / cpu_off))
        rows.append((min(vs_cpu / tol, card_off / max(tol, 2 * cpu_off)),
                     k, vs_cpu / tol))
    rows.sort(reverse=True)
    return {"grad_err_over_tol": rows[0][0], "rows": rows,
            "grad_floor": floor, "tensors": len(rows),
            "held_to_fp64": by_exact,
            "cpu_fp32_vs_fp64_worst": sorted(cpu_rel, reverse=True)[:3]}


# phase 7b-7e's worker processes for the CPU's sides of the train checks
CPU_WORKERS = 3


def _cpu_worker_init(threads: int) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(threads)


@contextlib.contextmanager
def cpu_workers():
    """A pool of CPU_WORKERS spawned processes (no CUDA in them) for phase
    7b-7e's CPU steps and enhances, which run there while this process
    runs the card's sides: each worker on an equal share of the cores but
    one, this process on the rest (its torch threads set so while the pool
    lives), so that the processes' threads together do not outnumber the
    cores. Every process of the pool has ended on the way out."""
    import concurrent.futures
    import multiprocessing
    import os

    import torch

    cores = len(os.sched_getaffinity(0))
    threads = max(1, (cores - 1) // CPU_WORKERS)
    own = torch.get_num_threads()
    torch.set_num_threads(max(1, cores - CPU_WORKERS * threads))
    emit({"phase": "train", "cpu_workers": CPU_WORKERS,
          "threads_each": threads, "threads_here": torch.get_num_threads()})
    pool = concurrent.futures.ProcessPoolExecutor(
        CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_worker_init, initargs=(threads,))
    try:
        yield pool
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        torch.set_num_threads(own)


def _numpy(tensors: dict) -> dict:
    """A dict of CPU tensors as numpy arrays, to pass between processes."""
    return {k: v.detach().cpu().numpy() for k, v in tensors.items()}


def _torch(arrays: dict) -> dict:
    import torch

    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _cpu_train_side(name: str, loss_fn: str, dtype: str, masks: list):
    """Phase 7b/7c's CPU side in a worker process: the step of
    `train_vs_cpu` on the CPU in `dtype` ("float32", or "float64": the
    exact step), its PReLUs taking the card's branches (`masks`, numpy).
    Returns the loss, the gradients and buffers (float64, numpy), the
    step's seconds and its flip counts."""
    import torch

    from se_tpu_torch.train.trainer import TrainConfig, make_train_step

    dtype = getattr(torch, dtype)
    model, init_fn, step_fn, _ = make_train_step(
        TrainConfig(model=name, loss=loss_fn), device="cpu")
    model.to(dtype)
    state = init_fn(0)
    _dropout(model, 0.0)
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in _train_batch(TRAIN_B.get(name, 2), "cpu",
                                      11).items()}
    masks = [torch.from_numpy(m) for m in masks]
    t0 = time.perf_counter()
    with prelu_branches(model, masks, record=False) as seen:
        state, loss = step_fn(state, batch)
        loss = loss.item()
    step_s = time.perf_counter() - t0
    return (loss, _numpy({k: p.grad.double()
                          for k, p in model.named_parameters()}),
            _numpy({k: b.double() for k, b in model.named_buffers()}),
            step_s, {k: seen[k] for k in ("flips", "flip_max_rel")})


def _cpu_enhance(name: str, loss_fn: str, weights: dict, wav):
    """Phase 7b's CPU enhance in a worker process: `enhance_waveform` of
    `name` on the CPU with the card's trained `weights` (numpy)."""
    from se_tpu_torch.eval.enhance import enhance_waveform
    from se_tpu_torch.train.trainer import TrainConfig, make_train_step

    model = make_train_step(TrainConfig(model=name, loss=loss_fn),
                            device="cpu")[0]
    model.load_state_dict(_torch(weights))
    return enhance_waveform(name, model, wav, device="cpu")


def train_vs_cpu(name: str, dev, launches, pool,
                 loss_fn: str = "default"):
    """Phase 7b/7c: one train step of `name` with the loss `loss_fn` at its
    published widths, B = 2 (TRAIN_B: FullSubNet 4) x 4 s, from the same
    weights (init_fn(0)), dropout rates 0, BN batch
    statistics on, on the card and on the CPU in fp32, and on the CPU in
    fp64 as the exact step, the CPU's steps taking the card's branch at
    every PReLU input within round-off of 0 (`prelu_branches`: such an
    input takes either subgradient, and each element that two steps take
    apart changes its gradient by (1 - slope) x; a branch that differs
    further from 0 fails; the line counts the elements and their largest
    |x| relative to their call): the card's loss within 1e-4 relative of the CPU's, the BN
    statistics after the step within 1e-3 * max|cpu|, the step's launch
    counts (TRAIN_PATHS), and every gradient tensor within
    tol = 1e-3 * max|grad| + GRAD_FLOOR * the step's largest |grad| entry
    of the CPU's fp32 gradient, or within max(tol, twice the CPU's fp32
    distance) of the fp64 gradient. The floor is fp32 round-off at the
    step's gradient scale, which sets the error of sums that cancel to
    near zero (the conv biases before batch-statistics BN, the attention
    key biases: zero in exact arithmetic; the PReLU slopes, sums of ~1e5
    signed terms). The second clause holds the card to the exact step
    where fp32 itself strays: behind BN with batch statistics some weight
    gradients of the CPU's fp32 step are percents off the fp64 step (the
    line's `cpu_fp32_vs_fp64_worst`), and two fp32 runs that sum in other
    orders stray about as far, not equally far. Then three steps on the
    card with dropout on and `enhance_waveform` of the trained weights on
    the card against the CPU (1e-3 * max|cpu|): the card model enhanced
    before training too, so its cached packs must have been dropped.
    Between the two, the card's step under remat "full" and "dots"
    against its step without, all three with cuDNN's deterministic
    algorithms (loss 1e-5 relative, gradients to the same tolerance).
    The remat steps and the three steps run with the family's default
    loss only: with another (DCCRN's fusion_snr) the one step against the
    CPU. The card's side runs now, the CPU's steps and its enhance in
    `pool` (`cpu_workers`). Returns a function that waits for them,
    checks, keeps the CPU's fp32 step in the dict it is given under `name`
    ({"loss", the gradients, the BN statistics after it}: phase 7e's fp32
    reference) and returns the launch counts.
    """
    import numpy as np
    import torch

    from se_tpu_torch.eval.enhance import enhance_waveform
    from se_tpu_torch.train.trainer import TrainConfig, make_train_step

    cfg = TrainConfig(model=name, loss=loss_fn)
    b = TRAIN_B.get(name, 2)
    masks: list = []  # the card's PReLU branches, call by call
    wav = waveforms(2, 5)
    model, init_fn, step_fn, _ = make_train_step(cfg, device=dev)
    state = init_fn(0)
    enhance_waveform(name, model, wav, device=dev)  # packs cached
    _dropout(model, 0.0)
    batch = _train_batch(b, dev, 11)
    launches.clear()
    t0 = time.perf_counter()
    with prelu_branches(model, masks, record=True):
        state, loss = step_fn(state, batch)
        loss = loss.item()
    step_s = time.perf_counter() - t0
    counts = dict(launches)
    grads = {k: p.grad.detach().cpu().double()
             for k, p in model.named_parameters()}
    stats = {k: b.detach().cpu().double() for k, b in model.named_buffers()}
    masks = [m.numpy() for m in masks]
    cpu_sides = {side: pool.submit(_cpu_train_side, name, loss_fn, dtype,
                                   masks)
                 for side, dtype in (("exact", "float64"),
                                     ("cpu", "float32"))}
    enhanced = remat = None
    if loss_fn == "default":
        remat = remat_steps(name, loss_fn, batch, dev)
        _dropout(model, 0.1)
        for _ in range(3):
            state, loss_d = step_fn(state, batch)
        if not np.isfinite(loss_d.item()):
            fail(f"{name}: a train step with dropout gave loss "
                 f"{loss_d.item()}")
        est = enhance_waveform(name, model, wav, device=dev)
        enhanced = est, pool.submit(_cpu_enhance, name, loss_fn,
                                    _numpy(model.state_dict()), wav)
    del model, init_fn, step_fn, state, batch

    def finish(cpu_fp32_steps: dict) -> dict:
        exact, cpu = (cpu_sides[k].result() for k in ("exact", "cpu"))
        exact_grads, cpu_grads = _torch(exact[1]), _torch(cpu[1])
        cpu_stats = _torch(cpu[2])
        loss_err = abs(loss - cpu[0]) / abs(cpu[0])
        check = grads_vs_cpu(grads, cpu_grads, exact_grads)
        rows, worst = check["rows"], check["grad_err_over_tol"]
        # the buffers: BN statistics, and the LSTMs' zero `bias_hh` (one
        # trained bias), whose error counts absolute
        stat_worst = max([float((stats[k] - v).abs().max())
                          / (float(v.abs().max()) or 1.0)
                          for k, v in cpu_stats.items()] or [0.0])
        emit({"phase": "train", "check": "card vs cpu step", "model": name,
              "loss_fn": cfg.loss, "batch": b, "loss_card": loss,
              "loss_cpu": cpu[0], "loss_cpu_fp64": exact[0],
              "loss_rel_err": loss_err,
              **{k: v for k, v in check.items() if k != "rows"},
              "grad_worst": rows[:4], "bn_stat_err_over_max": stat_worst,
              "prelu_calls": len(masks),
              "prelu_branches_taken_from_the_card": {"cpu_fp32": cpu[4],
                                                     "cpu_fp64": exact[4]},
              "launches": counts, "step_s_card": step_s,
              "step_s_cpu": cpu[3], "step_s_cpu_fp64": exact[3]})
        if not np.isfinite(loss) or not loss_err <= 1e-4:
            fail(f"{name}: card loss {loss} against the CPU's {cpu[0]}")
        if not worst <= 1.0:
            fail(f"{name}: a gradient differs by {worst} x the tolerance "
                 f"({rows[0][1]}, {rows[0][2]})")
        if not stat_worst <= 1e-3:
            fail(f"{name}: BN statistics differ from the CPU's by "
                 f"{stat_worst}")
        for kernel, want in TRAIN_PATHS[name].items():
            if counts.get(kernel, 0) != want:
                fail(f"{name}: a train step launched {kernel} "
                     f"{counts.get(kernel, 0)} times, expected {want}")
        if remat is not None:
            remat_check(name, cfg.loss, remat, check["grad_floor"])
        if loss_fn == "default":
            cpu_fp32_steps[name] = {
                "loss": torch.tensor(cpu[0], dtype=torch.float64),
                **cpu_grads,
                **{k: v for k, v in cpu_stats.items() if "running" in k}}
        if enhanced is not None:
            est, ref = enhanced[0], enhanced[1].result()
            err = float(np.abs(est - ref).max())
            tol = 1e-3 * float(np.abs(ref).max())
            emit({"phase": "train", "check": "enhance after 3 steps with "
                  "dropout, card vs cpu", "model": name, "loss_fn": cfg.loss,
                  "max_abs_err": err, "tol": tol})
            if not err <= tol:
                fail(f"{name}: enhance after training differs from the "
                     f"CPU's by {err} > {tol}")
        return counts

    return finish


def remat_steps(name: str, loss_fn: str, batch: dict, dev) -> dict:
    """Phase 7b: the card's step of `name` on `batch` under remat "none",
    "full" and "dots", all three with cuDNN's deterministic algorithms
    (its default ones sum some weight gradients in another order from run
    to run: atomics; up to 1% of a tensor's largest entry in CTSNet's
    ShareSepConv kernels, sums of ~5e4 terms that cancel). Returns remat:
    (loss, gradients on the CPU)."""
    import torch

    from se_tpu_torch.train.trainer import TrainConfig, make_train_step

    was_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        steps = {}
        for remat in ("none", "full", "dots"):
            model, init_fn, step_fn, _ = make_train_step(
                TrainConfig(model=name, loss=loss_fn, remat=remat),
                device=dev)
            state = init_fn(0)
            _dropout(model, 0.0)
            state, loss = step_fn(state, batch)
            steps[remat] = loss.item(), {
                k: p.grad.detach().cpu().double()
                for k, p in model.named_parameters()}
            del model, init_fn, step_fn, state
    finally:
        torch.backends.cudnn.deterministic = was_deterministic
    return steps


def remat_check(name: str, loss_fn: str, steps: dict, floor: float
                ) -> None:
    """`remat_steps`' "full" and "dots" against "none": loss 1e-5
    relative, every gradient within 1e-3 * max|grad| + `floor` (the step's
    `grads_vs_cpu` floor)."""
    loss_none, grads_none = steps["none"]
    for remat in ("full", "dots"):
        loss, grads = steps[remat]
        worst = max(float((g - grads_none[k]).abs().max())
                    / (1e-3 * float(grads_none[k].abs().max()) + floor)
                    for k, g in grads.items())
        emit({"phase": "train", "check": f"remat {remat} vs none, card, "
              "cuDNN deterministic", "model": name, "loss_fn": loss_fn,
              "loss": loss,
              "loss_none": loss_none, "grad_err_over_tol": worst})
        if not (abs(loss - loss_none) <= 1e-5 * abs(loss_none)
                and worst <= 1.0):
            fail(f"{name}: remat={remat} changed the step on the card")


def trainer_step(name: str, dev, dtype: str = "fp32"):
    """One train step of `name` at B = TRAIN_BATCH x 4 s through
    `make_train_step` in `dtype` (dropout on), as a call that returns its
    loss."""
    from se_tpu_torch.train.trainer import TrainConfig, make_train_step

    _, init_fn, step_fn, _ = make_train_step(
        TrainConfig(model=name, compute_dtype=dtype), device=dev)
    state = init_fn(0)
    batch = _train_batch(TRAIN_BATCH, dev, 21)
    return lambda: step_fn(state, batch)[1]


def deepxi_driver(name: str, where, dtype, fitted=None):
    """DeepXi's driver for `name` on `where` in `dtype`: the weights of
    `seeded(name, 0)`, the map `fitted` (by default `deepxi_xi_map()`)."""
    from se_tpu_torch.models.deepxi_driver import DeepXiDriver

    drv = DeepXiDriver(network=DEEPXI_NETWORK[name], device=where)
    drv.model.load_state_dict(seeded(name, 0).state_dict())
    drv.model.to(dtype)
    if fitted is None:
        fitted = deepxi_xi_map()
    drv.xi_map.mu, drv.xi_map.sigma = fitted.mu, fitted.sigma
    return drv


def deepxi_batch(batch: int, where, dtype, seed: int):
    """`_train_batch`'s waveforms as the driver takes them: (s, x, frames),
    frames 250 (its count from the padded length, as se_tpu's)."""
    import torch

    b = _train_batch(batch, where, seed)
    frames = torch.full((batch,), DEEPXI_T, dtype=torch.int64, device=where)
    return b["clean"].to(dtype), b["mix"].to(dtype), frames


def deepxi_step(name: str, dev):
    """One DeepXi driver step at B = TRAIN_BATCH x 4 s, as a call that
    returns its loss."""
    import torch

    from se_tpu_torch.train.trainer import adam_state

    drv = deepxi_driver(name, dev, torch.float32)
    s, x, frames = deepxi_batch(TRAIN_BATCH, dev, torch.float32, 21)
    opt_state = adam_state(dict(drv.model.named_parameters()))
    return lambda: drv.train_step(s, x, frames, opt_state)


def _cpu_deepxi_side(name: str, dtype: str, masks: list, fitted):
    """Phase 7b's CPU side for DeepXi in a worker process: the driver step
    of `deepxi_train_vs_cpu` on the CPU in `dtype` with the card's map
    `fitted`, its ReLUs taking the card's branches (`masks`, numpy).
    Returns the loss, the gradients (float64, numpy), the step's seconds
    and its flip counts."""
    import torch

    from se_tpu_torch.train.trainer import adam_state

    dtype = getattr(torch, dtype)
    drv = deepxi_driver(name, "cpu", dtype, fitted)
    s, x, frames = deepxi_batch(2, "cpu", dtype, 11)
    opt_state = adam_state(dict(drv.model.named_parameters()))
    masks = [torch.from_numpy(m) for m in masks]
    t0 = time.perf_counter()
    with relu_branches(masks, record=False) as seen:
        loss = drv.train_step(s, x, frames, opt_state).item()
    step_s = time.perf_counter() - t0
    return (loss, _numpy({k: p.grad.double()
                          for k, p in drv.model.named_parameters()}),
            step_s, {k: seen[k] for k in ("flips", "flip_max_rel")})


def deepxi_train_vs_cpu(name: str, dev, launches, pool):
    """Phase 7b for DeepXi: one driver step (`DeepXiDriver.train_step`:
    the MagXi example, BCE with the frame mask, elementwise clip, Adam) of
    `name` at B = 2 x 4 s from the same weights and map on the card in
    fp32, on the CPU in fp32 and in fp64 (the exact step), the CPU's steps
    taking the card's branch at every ReLU input within round-off of 0
    (`relu_branches`, as 7b's PReLUs): the card's loss within 1e-4
    relative of the CPU's, every gradient inside `grads_vs_cpu`'s
    tolerance (phase 7b's), the step's launches
    (TRAIN_PATHS: the STFT kernel for s, d and x; the ResLSTM's layers
    forward). The card's side runs now, the CPU's in `pool`. Returns a
    function that waits for them, checks and returns the launch
    counts."""
    import numpy as np
    import torch

    from se_tpu_torch.train.trainer import adam_state

    masks: list = []  # the card's ReLU branches, call by call
    fitted = deepxi_xi_map()
    drv = deepxi_driver(name, dev, torch.float32, fitted)
    s, x, frames = deepxi_batch(2, dev, torch.float32, 11)
    opt_state = adam_state(dict(drv.model.named_parameters()))
    launches.clear()
    t0 = time.perf_counter()
    with relu_branches(masks, record=True):
        loss = drv.train_step(s, x, frames, opt_state).item()
    step_s = time.perf_counter() - t0
    grads = {k: p.grad.detach().cpu().double()
             for k, p in drv.model.named_parameters()}
    counts = dict(launches)
    del drv, s, x, frames, opt_state
    masks = [m.numpy() for m in masks]
    cpu_sides = {side: pool.submit(_cpu_deepxi_side, name, dtype, masks,
                                   fitted)
                 for side, dtype in (("exact", "float64"),
                                     ("cpu", "float32"))}

    def finish(cpu_fp32_steps: dict) -> dict:
        exact, cpu = (cpu_sides[k].result() for k in ("exact", "cpu"))
        loss_err = abs(loss - cpu[0]) / abs(cpu[0])
        check = grads_vs_cpu(grads, _torch(cpu[1]), _torch(exact[1]))
        rows = check.pop("rows")
        emit({"phase": "train", "check": "card vs cpu step (DeepXiDriver)",
              "model": name, "network": DEEPXI_NETWORK[name], "batch": 2,
              "loss_card": loss, "loss_cpu": cpu[0],
              "loss_cpu_fp64": exact[0], "loss_rel_err": loss_err, **check,
              "grad_worst": rows[:4], "relu_calls": len(masks),
              "relu_branches_taken_from_the_card": {"cpu_fp32": cpu[3],
                                                    "cpu_fp64": exact[3]},
              "launches": counts, "step_s_card": step_s,
              "step_s_cpu": cpu[2], "step_s_cpu_fp64": exact[2]})
        if not np.isfinite(loss) or not loss_err <= 1e-4:
            fail(f"{name}: card loss {loss} against the CPU's {cpu[0]}")
        if not check["grad_err_over_tol"] <= 1.0:
            fail(f"{name}: a gradient differs by "
                 f"{check['grad_err_over_tol']} x the tolerance "
                 f"({rows[0][1]}, {rows[0][2]})")
        for kernel, want in TRAIN_PATHS[name].items():
            if counts.get(kernel, 0) != want:
                fail(f"{name}: a train step launched {kernel} "
                     f"{counts.get(kernel, 0)} times, expected {want}")
        return counts

    return finish


def _step_tensors(model, loss) -> dict:
    """A step's loss, every gradient and the BN statistics after it, as
    float64 numpy arrays (phase 7e's comparison)."""
    out = {"loss": loss.detach().double()}
    out.update((k, p.grad.double()) for k, p in model.named_parameters())
    out.update((k, v.double()) for k, v in model.named_buffers()
               if "running" in k)
    return _numpy(out)


def _cpu_bf16_side(name: str):
    """Phase 7e's CPU side in a worker process: the bf16 step of
    `bf16_train_vs_cpu` on the CPU. Returns `_step_tensors` and the step's
    seconds."""
    from se_tpu_torch.train.trainer import TrainConfig, make_train_step

    model, init_fn, step_fn, _ = make_train_step(
        TrainConfig(model=name, compute_dtype="bf16"), device="cpu")
    state = init_fn(0)
    _dropout(model, 0.0)
    batch = _train_batch(TRAIN_B.get(name, 2), "cpu", 11)
    t0 = time.perf_counter()
    state, loss = step_fn(state, batch)
    out = _step_tensors(model, loss)
    return out, time.perf_counter() - t0


def bf16_train_vs_cpu(name: str, dev, launches, pool):
    """Phase 7e: one bf16 train step (`TrainConfig(compute_dtype="bf16")`:
    fp32 masters, the model on their bf16 casts) of `name` at its
    published widths, B = 2 (TRAIN_B: FullSubNet 4) x 4 s, dropout rates
    0, from init_fn(0), on phase 7b's batch,
    on the card with the counts set to 0 just before and read just after
    (BF16_TRAIN_PATHS: no fp32 attention or LSTM launch); then the same
    step on the CPU in bf16 (in `pool`); the CPU's fp32 step is phase 7b's
    (from the same weights and batch). The loss, every gradient and
    the BN statistics after the step held by `bf16_step_compare` (the
    card's distance from the CPU fp32 step within twice the CPU bf16
    step's own, plus one bf16 ulp of the step's largest gradient capped
    at a quarter of the tensor's own scale but for scalars and tensors
    the CPU's bf16 step does not resolve; at most 1% of the tensors
    within four times it; pooled, within twice; PERF.md section 2).
    Returns a function that takes phase 7b's CPU fp32 steps by family,
    waits for the CPU's bf16 step, checks and returns the counts."""
    import numpy as np

    from se_tpu_torch.ops._dtype import bf16_step_compare
    from se_tpu_torch.train.trainer import TrainConfig, make_train_step

    b = TRAIN_B.get(name, 2)
    cpu_side = pool.submit(_cpu_bf16_side, name)
    model, init_fn, step_fn, _ = make_train_step(
        TrainConfig(model=name, compute_dtype="bf16"), device=dev)
    state = init_fn(0)
    _dropout(model, 0.0)
    batch = _train_batch(b, dev, 11)
    launches.clear()
    t0 = time.perf_counter()
    state, loss = step_fn(state, batch)
    card = _step_tensors(model, loss.cpu())
    step_s = time.perf_counter() - t0
    counts = dict(launches)
    del model, init_fn, step_fn, state, batch

    def finish(cpu_fp32_steps: dict) -> dict:
        cpu32 = cpu_fp32_steps.pop(name)
        cpu16, cpu_s = cpu_side.result()
        check = bf16_step_compare(card, cpu16, cpu32)
        loss = float(card["loss"])
        emit({"phase": "train", "check": "bf16 card vs cpu step",
              "model": name, "batch": b, "loss_card_bf16": loss,
              "loss_cpu_bf16": float(cpu16["loss"]),
              "loss_cpu_fp32": float(cpu32["loss"]),
              "pooled_card_vs_cpu_fp32": check.pooled_got,
              "pooled_cpu_bf16_vs_cpu_fp32": check.pooled_ref,
              "tensors": len(cpu32), "past_twice": check.failures[:6],
              "worst_over_limit": check.worst,
              "floor_cap_lifted": check.uncapped, "launches": counts,
              "step_s_card": step_s, "step_s_cpu_bf16": cpu_s})
        if not np.isfinite(loss) or not check.ok:
            fail(f"{name}: the card's bf16 step is past the bf16 rule: "
                 f"{check.failures[:3]}, pooled {check.pooled_got} against "
                 f"the CPU bf16's {check.pooled_ref}")
        for kernel, want in BF16_TRAIN_PATHS[name].items():
            if counts.get(kernel, 0) != want:
                fail(f"{name}: a bf16 train step launched {kernel} "
                     f"{counts.get(kernel, 0)} times, expected {want}")
        return counts

    return finish


# phase 7d: the families whose step is not profiled; bf16 beside fp32 for
# Uformer and FullSubNet
TRAIN_UNPROFILED = ("dpcrn", "dccrn", "gcrn", "crn", "lstm")
TRAIN_BF16_SPEED = ("uformer", "fullsubnet")
# phase 7d's (warm-up, timed) steps (the script's time limit)
TRAIN_SPEED_STEPS = (1, 3)


# R11's yardstick: the LSTM layer's train-time cost (forward + backward)
# through kernel_call against cuDNN's torch.nn.LSTM at two training shapes
# (label, Bf, T, ((In, H) a layer)); a yardstick, nothing on the main path
# calls cuDNN
R11_SHAPES = (
    ("FullSubNet training sub band", 128 * TRAIN_BATCH, FSN_T,
     FSN_LAYERS[2:]),
    ("DPCRN inter", 4 * TRAIN_BATCH, T_FRAMES, ((128, 128),)),
)


def lstm_train_yardsticks(dev, card: str) -> None:
    """Phase 7a, R11: at each R11_SHAPES shape, the layers' forward +
    backward through `lstm_layer_kernel` (kernel forward, the chunked
    twin's VJP recomputed), its forward alone and the twin's forward under
    autograd (what the backward recomputes: its share of the step), and
    torch.nn.LSTM's (cuDNN) forward + backward on the same input and
    upstream gradient; CUDA-event ms (median of 3 after a warm-up) and
    each one's peak device memory."""
    import torch

    from se_tpu_torch.ops import lstm

    gen = torch.Generator().manual_seed(17)
    for label, bf, t_len, layers in R11_SHAPES:
        in0, h = layers[0][0], layers[-1][1]
        x = torch.randn(bf, t_len, in0, generator=gen).to(dev)
        g = torch.randn(bf, t_len, h, generator=gen).to(dev)
        weights = [[w.requires_grad_() for w in lstm_weights(gen, dev, i, hh)]
                   for i, hh in layers]
        xg = x.clone().requires_grad_()

        def port():
            y = xg
            for wx, wh, b in weights:
                y, _ = lstm.lstm_layer_kernel(y, wx, wh, b)
            return y

        def twin():
            y = xg
            for wx, wh, b in weights:
                y, _ = lstm._chunked_reference(y, wx, wh, b)
            return y

        cudnn = torch.nn.LSTM(in0, h, num_layers=len(layers),
                              batch_first=True).to(dev)

        def fwd_bwd(fn):
            def run():
                fn().backward(g)
            return run

        rows = {}
        for key, fn in (("port_fwd_bwd", fwd_bwd(port)),
                        ("port_fwd", lambda: port().detach()),
                        ("twin_fwd_recompute", lambda: twin().detach()),
                        ("cudnn_fwd_bwd", fwd_bwd(lambda: cudnn(xg)[0]))):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(fn, reps=1, rounds=3, warm=1)
            rows[key] = {"ms": ms,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        emit({"phase": "train", "check": "R11 yardstick: LSTM forward + "
              "backward", "case": label, "bf": bf, "t": t_len,
              "layers": [list(l) for l in layers], **rows,
              "recompute_share": rows["twin_fwd_recompute"]["ms"]
              / rows["port_fwd_bwd"]["ms"],
              "port_over_cudnn": rows["port_fwd_bwd"]["ms"]
              / rows["cudnn_fwd_bwd"]["ms"], "card": card})
        del x, g, xg, weights, cudnn
        torch.cuda.empty_cache()


def train_throughput(name: str, step, card: str, do_profile: bool,
                     dtype: str = "fp32") -> None:
    """Phase 7d: `step()` (one train step at B = TRAIN_BATCH x 4 s in
    `dtype`, its loss returned) TRAIN_SPEED_STEPS' warm-up times, then the
    median of its timed ones in audio-s/s, peak device memory, every
    step's loss
    (all finite); with
    `do_profile`, device time by kernel of one step (torch.profiler over
    the device's activity alone, top 10) and the device's busy share."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    warm, timed = TRAIN_SPEED_STEPS
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(warm + timed):
        t0 = time.perf_counter()
        losses.append(step().item())
        if i >= warm:
            times.append(time.perf_counter() - t0)
    rates = [TRAIN_BATCH * SECONDS / t for t in times]
    emit({"phase": "train", "metric": f"{name}_train_{dtype}",
          "batch": TRAIN_BATCH, "seconds_audio": SECONDS, "warm_up": warm,
          "timed": timed,
          "audio_s_per_s": statistics.median(rates), "min": min(rates),
          "max": max(rates), "step_ms": [t * 1e3 for t in times],
          "losses": losses,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card": card})
    if not all(np.isfinite(losses)):
        fail(f"{name}: a train step's loss is not finite: {losses}")
    if not do_profile:
        return
    # the device's activity alone: a step's ~1e5 host ops, recorded too,
    # took most of the phase's seconds and stretched the profiled wall
    # time; with both where the device's alone shows no kernel
    start, rows = time.perf_counter(), []
    for activities in ([ProfilerActivity.CUDA],
                       [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        try:
            with torch_profile(activities=activities) as prof:
                t0 = time.perf_counter()
                step().item()
                wall_ms = (time.perf_counter() - t0) * 1e3
        except (AssertionError, RuntimeError):  # a profiler refusing it
            continue
        rows = sorted(((evt.device_time_total / 1e3, evt.count, evt.key)
                       for evt in prof.key_averages()
                       if evt.device_type == DeviceType.CUDA),
                      reverse=True)
        if rows:
            break
    device_total = sum(ms for ms, _, _ in rows)
    emit({"phase": "train", "profile": f"{name} {dtype}",
          "batch": TRAIN_BATCH,
          "activities": [str(a).split(".")[-1] for a in activities],
          "profiling_s": time.perf_counter() - start,
          "wall_ms": wall_ms, "device_ms": device_total,
          "device_busy_share": device_total / wall_ms,
          "top": [{"ms": ms, "calls": n, "name": key[:90]}
                  for ms, n, key in rows[:10]],
          "kernels_ms": {k: sum(ms for ms, _, key in rows if k in key)
                         for k in PROFILE_KERNELS.get(name, ())},
          "card": card})


# ----------------------------------------------------------- phase 8: stream

CHUNK = 16  # frames a stream's chunk (the streamers' default)
# family: the kernels a stream must launch. LSTMNet: every full chunk is
# T = 16 on the small fold's two kernels, its 13-frame tail the
# tensor-core step; CRN and DPCRN: each chunk's 10 replayed frames (the
# first chunk's 6 and 10) the tensor-core step, the 16-frame splits the
# small fold; DPCRN's intra BiLSTM (T = 4 bins) the tensor-core step; GCRN
# replays nothing: 16-frame chunks on the small fold, its 7-frame tail on
# the tensor-core step
STREAM_PATHS = {"lstm": ("lstm", "lstm_project", "lstm_recur"),
                "crn": ("lstm", "lstm_project", "lstm_recur"),
                "gcrn": ("lstm", "lstm_project", "lstm_recur"),
                "dpcrn": ("lstm", "lstm_project", "lstm_recur")}


def _stream(st, wav, cuts):
    import numpy as np

    edges = [0, *cuts, len(wav)]
    parts = [st.push(wav[a:b]) for a, b in zip(edges, edges[1:])]
    return np.concatenate(parts + [st.flush()])


def _streamer(name: str, model, gain, device=None):
    from se_tpu_torch.eval.streaming import CausalStreamer, LstmStreamer

    if name == "lstm":
        return LstmStreamer(model, chunk_frames=CHUNK, gain=gain,
                            device=device)
    return CausalStreamer(name, model, chunk_frames=CHUNK, gain=gain,
                          device=device)


def _within(label: str, got, ref) -> dict:
    """max |got - ref| against 1e-3 * max|ref| (phase 4's rule)."""
    import numpy as np

    err = float(np.abs(got - ref).max())
    tol = 1e-3 * float(np.abs(ref).max())
    if got.shape != ref.shape or not np.isfinite(got).all() \
            or not err <= tol:
        fail(f"{label}: shape {got.shape} vs {ref.shape}, error {err} > "
             f"{tol}")
    return {"max_abs_err": err, "tol": tol}


def stream_path(name: str, dev, launches, card: str) -> dict:
    """Phase 8 (a, b) for one family: the stream on the card against the
    card's own offline `enhance_waveform` (the gain passed in, so the two
    agree to the sum order of the STFT kernel against the basis product)
    and against the same stream on the CPU, each within 1e-3 * max|ref|;
    the kernels the stream launched (counts set to 0 just before it); then
    (d) the median wall time of a push that completes one chunk, its
    real-time factor and the launches a chunk. LSTMNet: a 3 s utterance
    plus 77 samples in 0.1 s pieces; the causal families: 1.5 s in
    tests/test_streaming.py's pieces."""
    import numpy as np

    from se_tpu_torch.eval.enhance import enhance_waveform

    cpu_model = seeded(name, 0)
    model = copy.deepcopy(cpu_model).to(dev)
    if name == "lstm":
        wav = waveforms(1, 80)[0][:3 * SR + 77]
        cuts = list(range(SR // 10, len(wav), SR // 10))
    else:
        wav = waveforms(1, 81)[0][:24000]
        cuts = [900, 7777, 15555]
    gain = float(np.sqrt(len(wav) / np.sum(np.square(wav))))

    launches.clear()
    got = _stream(_streamer(name, model, gain), wav, cuts)
    counts = dict(launches)
    offline = enhance_waveform(name, model, wav)
    on_cpu = _stream(_streamer(name, cpu_model, gain, "cpu"), wav, cuts)
    line = {"phase": "stream", "model": name, "samples": len(wav),
            "launches": counts,
            "vs_offline_card": _within(f"{name} stream vs offline", got,
                                       offline),
            "vs_stream_cpu": _within(f"{name} stream card vs cpu", got,
                                     on_cpu)}
    missing = [k for k in STREAM_PATHS[name] if counts.get(k, 0) == 0]
    if missing:
        fail(f"{name}: the stream launched no {', '.join(missing)}")

    # (d) a push of one chunk's samples completes one chunk
    times, packed, per_chunk = _chunk_pushes(name, model, gain, launches)
    busy = _chunk_device_share(name, model, gain)
    ms = statistics.median(times)
    chunk_ms = CHUNK * HOP / SR * 1e3
    line.update({"push_ms_median": ms, "push_ms_min": min(times),
                 "push_ms_max": max(times), "pushes": len(times),
                 "chunk_ms_audio": chunk_ms,
                 "real_time_factor": ms / chunk_ms,
                 "launches_per_chunk": statistics.median(per_chunk),
                 "push_ms_median_weights_packed_once":
                     statistics.median(packed),
                 "packing_ms_per_chunk_paired": statistics.median(
                     t - q for t, q in zip(times, packed)),
                 **busy, "card": card})
    emit(line)
    return counts


def _chunk_pushes(name, model, gain, launches):
    """Two streams of the same samples in turns, one as it runs and one
    with the LSTM weights packed once (`_PackedOnce`), the one going first
    alternating: after a 0.5 s start, 20 pushes of one chunk's samples (16
    hops) each, each completing one chunk. Returns the wall ms of each
    stream's pushes (pair i: the same chunk) and the launches of the plain
    stream's."""
    long = waveforms(1, 82)[0]
    plain, packed = (_streamer(name, model, gain) for _ in range(2))
    once = _PackedOnce()
    for st, ctx in ((plain, contextlib.nullcontext()), (packed, once)):
        with ctx:
            st.push(long[:SR // 2])
    times, packed_times, per_chunk = [], [], []
    for i in range(20):
        a = SR // 2 + i * CHUNK * HOP
        turns = [(plain, contextlib.nullcontext(), times),
                 (packed, once, packed_times)]
        for st, ctx, out in turns if i % 2 == 0 else turns[::-1]:
            before, n_launch = st._frame_pos, sum(launches.values())
            with ctx:
                t0 = time.perf_counter()
                st.push(long[a:a + CHUNK * HOP])
                out.append((time.perf_counter() - t0) * 1e3)
            if st._frame_pos - before != CHUNK:
                fail(f"{name}: a push of {CHUNK} hops completed "
                     f"{st._frame_pos - before} frames")
            if st is plain:
                per_chunk.append(sum(launches.values()) - n_launch)
    return times, packed_times, per_chunk


class _PackedOnce:
    """Inside `with`, each LSTM layer's weights transposed
    (`LSTM.layer_weights`) and packed for its kernels (`pack_input`,
    `pack_recurrent`, `pack_weights`) once, not at every layer call: what
    packing the weights once per model (ROADMAP R10) would save a chunk.
    The caches live as long as the object; the weights must not change."""

    def __init__(self):
        from se_tpu_torch.nn.recurrent import LSTM
        from se_tpu_torch.ops import lstm

        self.lstm, self.cls = lstm, LSTM
        self.saved = {n: getattr(lstm, n) for n in
                      ("pack_input", "pack_recurrent", "pack_weights")}
        self.layer_weights = LSTM.layer_weights
        ptrs = lambda *ts: tuple(t.data_ptr() for t in ts)  # noqa: E731
        self.cached = {n: self._once(fn, ptrs)
                       for n, fn in self.saved.items()}
        self.cached_layer_weights = self._once(
            self.layer_weights, lambda m, sfx: (id(m), sfx))

    @staticmethod
    def _once(fn, key):
        cache = {}

        def run(*args):
            k = key(*args)
            if k not in cache:
                cache[k] = fn(*args)
            return cache[k]
        return run

    def __enter__(self):
        for n, fn in self.cached.items():
            setattr(self.lstm, n, fn)
        self.cls.layer_weights = self.cached_layer_weights

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.lstm, n, fn)
        self.cls.layer_weights = self.layer_weights


def _chunk_device_share(name, model, gain) -> dict:
    """torch.profiler over 5 pushes of one chunk each: the device time a
    chunk (kernels only) and its share of the pushes' wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    st = _streamer(name, model, gain)
    long = waveforms(1, 84)[0]
    st.push(long[:SR // 2])
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(5):
            a = SR // 2 + i * CHUNK * HOP
            st.push(long[a:a + CHUNK * HOP])
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = sum(evt.device_time_total for evt in prof.key_averages()
                 if evt.device_type == DeviceType.CUDA) / 1e3
    return {"device_ms_per_chunk": device / 5,
            "device_busy_share": device / wall_ms}


def windowed_uformer(dev, launches, card: str) -> dict:
    """Phase 8 (c): `enhance_windowed` on Uformer at its defaults (4 s
    chunks, 2 s context, max_batch 16) over 8.5 s, three windows in one
    padded batch, against the CPU at max_batch 2 (two batches, the second
    padded) within 1e-3 * max|cpu|, with every Uformer kernel launched;
    the same in bf16 (its bf16 kernels, its distance from fp32); then the
    windowed throughput over 60 s (15 windows, one batch), fp32 and bf16
    in turns."""
    import numpy as np
    import torch

    from se_tpu_torch.eval.streaming import enhance_windowed

    cpu_model = seeded("uformer", 0)
    model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(83)
    wav = (rng.standard_normal(int(8.5 * SR)) * 0.1).astype(np.float32)
    launches.clear()
    got = enhance_windowed("uformer", model, wav)
    counts = dict(launches)
    cpu = enhance_windowed("uformer", cpu_model, wav, max_batch=2,
                           device="cpu")
    line = {"phase": "stream", "model": "uformer windowed",
            "samples": len(wav), "launches": counts,
            "vs_cpu_max_batch_2": _within("uformer windowed card vs cpu",
                                          got, cpu)}
    missing = [k for k in MAIN_PATHS["uformer"] if counts.get(k, 0) == 0]
    if missing:
        fail(f"uformer windowed: launched no {', '.join(missing)}")
    # bf16 (enhance_windowed(dtype=torch.bfloat16)): the four bf16
    # variants and no fp32 kernel, finite, and its mean distance from the
    # fp32 decode within assert_tracks's 0.1 (the CPU rule is phase 4b's
    # and tests/test_torch_bf16_recurrent_zoo.py's)
    launches.clear()
    got16 = enhance_windowed("uformer", model, wav, dtype=torch.bfloat16)
    counts16 = dict(launches)
    mean_rel = float(np.abs(got16 - got).mean() / np.abs(got).mean())
    line.update({"launches_bf16": counts16,
                 "bf16_vs_fp32_mean_rel": mean_rel})
    if any(counts16.get(k, 0) == 0 for k in BF16_KERNELS) or any(
            counts16.get(k, 0) for k in MAIN_PATHS["uformer"]):
        fail(f"uformer windowed bf16: launches {counts16}")
    if not (np.isfinite(got16).all() and mean_rel < 0.1):
        fail(f"uformer windowed bf16: mean distance {mean_rel} from fp32")
    minute = (rng.standard_normal(60 * SR) * 0.1).astype(np.float32)
    times = {None: [], torch.bfloat16: []}
    for dtype in times:  # warm-up
        enhance_windowed("uformer", model, minute, dtype=dtype)
    for dtype in (None, torch.bfloat16, torch.bfloat16, None) * 2:
        t0 = time.perf_counter()
        enhance_windowed("uformer", model, minute, dtype=dtype)
        times[dtype].append(time.perf_counter() - t0)
    line.update({"seconds_audio": 60, "windows": 15, "batches": 1,
                 "audio_s_per_s": 60 / statistics.median(times[None]),
                 "call_s": times[None],
                 "audio_s_per_s_bf16":
                     60 / statistics.median(times[torch.bfloat16]),
                 "call_s_bf16": times[torch.bfloat16], "card": card})
    emit(line)
    return counts


# -------------------------------------------------------------- phase 9: cli

CLI_FAMILIES = ("dpcrn", "lstm", "gcrn")
# the two trains that `checkpoints_agree` compares: the CLI's own `main` on
# the same arguments, under cuDNN's deterministic algorithms (its default
# ones sum some weight gradients in an order that varies from run to run:
# atomics; once 1.88 x the gradient rule apart on DPCRN's last transposed
# conv, de.de_module.3.0, with one sign flipped above the floor)
CLI_DETERMINISTIC = ("import sys, torch; "
                     "torch.backends.cudnn.deterministic = True; "
                     "from se_tpu_torch.cli import main; main(sys.argv[1:])")


def checkpoints_agree(plain: dict, other: dict) -> dict:
    """Two checkpoints of one train step from the same weights and batch:
    the gradients (Adam's first moment / (1 - b1)) within phase 7b's rule
    (1e-3 x max|g| + GRAD_FLOOR x the step's largest |g|, the floor); no
    gradient above the floor with another sign in the two; each weight
    and buffer within 1e-5 x max(1, max|w|) of its tensor, but where the
    gradient is round-off (|g| <= the floor in both), which Adam's first
    update u = g / (|g| + 1e-8) moves by up to lr whatever its size: there
    2 lr apart. Both trains run under cuDNN's deterministic algorithms
    (`CLI_DETERMINISTIC`). Fails otherwise; returns the worst ratios and
    counts."""
    import torch

    b1, lr = 0.9, 1e-3  # optax's scale_by_adam; the CLI's default rate
    g_p = {k: m / (1 - b1) for k, m in plain["opt_state"]["mu"].items()}
    g_o = {k: m / (1 - b1) for k, m in other["opt_state"]["mu"].items()}
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in g_p.values())
    grad_worst = max((float((g_o[k] - g).abs().max())
                      / (1e-3 * float(g.abs().max()) + floor), k)
                     for k, g in g_p.items())
    big_flips, round_off, apart = 0, 0, 0
    for k, w in plain["model"].items():
        d = (other["model"][k] - w).abs()
        near = d <= 1e-5 * max(1.0, float(w.abs().max()))
        if k in g_p:
            small = torch.maximum(g_p[k].abs(), g_o[k].abs()) <= floor
            big_flips += int(((torch.sign(g_p[k]) != torch.sign(g_o[k]))
                              & ~small).sum())
            round_off += int((small & ~near).sum())
            near = near | (small & (d <= 2 * lr))
        apart += int((~near).sum())
    out = {"grad_err_over_tol": grad_worst, "grad_floor": floor,
           "sign_flips_above_floor": big_flips,
           "round_off_weights_apart": round_off, "weights_apart": apart}
    if not (grad_worst[0] <= 1.0 and big_flips == 0 and apart == 0):
        fail(f"cli train --data-parallel: its checkpoint parts from the "
             f"plain train's: {out}")
    return out


def cli_phase(dev, card: str) -> None:
    """Phase 9: the command line as its users run it, each command a
    subprocess `python -m se_tpu_torch ...` (the TF32 flags its own; the
    two trains the CLI's `main` under `CLI_DETERMINISTIC`) in a
    temporary directory with two seeded 1 s noisy / clean pairs and a
    manifest (the verify recipe's fixture): train DPCRN one step, the same
    with `--data-parallel` (one rank on the one card, NCCL), enhance from
    the plain train's checkpoint, stream exact (LSTMNet) and windowed
    (GCRN), score. The two trains run one after the other, each alone on
    the card (beside other processes cuDNN may pick other algorithms in
    one than in the other, and a gradient within round-off of a kink then
    takes another branch), then both streams and enhance side by side,
    then score (each wall from its start to its exit). Each must exit 0; the two trains' checkpoints must
    agree (`checkpoints_agree`); the
    enhanced wavs must match the restored model's in-process
    `enhance_waveform` within 1e-3 * max + one 16-bit step; every CSV
    column must be finite."""
    import csv
    import json
    import os
    import tempfile

    import numpy as np

    from se_tpu_torch.data import read_wav, write_wav
    from se_tpu_torch.eval.enhance import enhance_waveform
    from se_tpu_torch.train.checkpoint import restore_checkpoint
    from se_tpu_torch.train.trainer import TrainConfig, make_train_step

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        for d in ("noisy", "clean"):
            os.makedirs(os.path.join(tmp, d))
        ids = []
        for i in range(2):
            c = (rng.standard_normal(SR) * 0.1).astype(np.float32)
            n = (rng.standard_normal(SR) * 0.03).astype(np.float32)
            write_wav(os.path.join(tmp, "clean", f"u{i}.wav"), c, SR)
            write_wav(os.path.join(tmp, "noisy", f"u{i}.wav"), c + n, SR)
            ids.append(f"u{i}")
        with open(os.path.join(tmp, "files.json"), "w") as f:
            json.dump(ids, f)
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        train = ["train", "--model", "dpcrn", "--mix-dir", "noisy",
                 "--clean-dir", "clean", "--manifest", "files.json",
                 "--batch-size", "2", "--epochs", "1", "--checkpoint-dir"]
        cli, fixed = ["-m", "se_tpu_torch"], ["-c", CLI_DETERMINISTIC]
        stages = (
            (("train", fixed + train + ["CP"]),),
            (("train data parallel",
              fixed + train + ["CP_dp", "--data-parallel"]),),
            (("stream exact",
              cli + ["stream", "--mode", "exact", "--model", "lstm",
                     "--mix-dir", "noisy", "--out-dir", "stream_exact"]),
             ("stream windowed",
              cli + ["stream", "--mode", "windowed", "--model", "gcrn",
                     "--mix-dir", "noisy", "--out-dir", "stream_windowed"]),
             ("enhance",
              cli + ["enhance", "--model", "dpcrn", "--checkpoint", "CP",
                     "--mix-dir", "noisy", "--out-dir", "est"])),
            (("score",
              cli + ["score", "--est-dir", "est", "--ref-dir", "clean",
                     "--csv", "results/r.csv"]),))
        walls = {}
        for stage in stages:
            running = {}
            for label, argv in stage:
                err = open(os.path.join(tmp, f"{label}.err"), "w+")
                running[label] = (time.perf_counter(), err, subprocess.Popen(
                    [sys.executable, *argv], cwd=tmp,
                    env=env, stdout=subprocess.DEVNULL, stderr=err))
            while running:
                for label, (t0, err, proc) in list(running.items()):
                    code = proc.poll()
                    late = time.perf_counter() - t0 > 600
                    if code is None and not late:
                        continue
                    walls[label] = time.perf_counter() - t0
                    del running[label]
                    err.seek(0)
                    text = err.read()[-3000:]
                    err.close()
                    if code != 0:
                        for _, other_err, other in running.values():
                            other.kill()
                            other.wait()
                            other_err.close()
                        proc.kill()
                        proc.wait()
                        fail(f"cli {label}: exit {code} after "
                             f"{walls[label]:.0f} s\n{text}")
                time.sleep(0.05)

        model, init_fn, _, _ = make_train_step(TrainConfig(model="dpcrn"),
                                               device=dev)
        state, found = restore_checkpoint(os.path.join(tmp, "CP"),
                                          init_fn(0))
        if not found or state["step"] != 1:
            fail("cli train: no checkpoint of step 1 in CP")
        import torch

        dp_err = checkpoints_agree(*(
            torch.load(os.path.join(tmp, d, "model.ckpt-0-1"),
                       weights_only=False) for d in ("CP", "CP_dp")))
        errs = []
        for fid in ("u0.wav", "u1.wav"):
            wav, _ = read_wav(os.path.join(tmp, "noisy", fid))
            got, _ = read_wav(os.path.join(tmp, "est", fid))
            want = enhance_waveform("dpcrn", model, wav)
            err = float(np.abs(got - want).max())
            tol = 1e-3 * float(np.abs(want).max()) + 1.0 / 32768
            errs.append({"utt": fid, "max_abs_err": err, "tol": tol})
            if not err <= tol:
                fail(f"cli enhance {fid}: {err} > {tol} from the restored "
                     "model in process")
            for out in ("stream_exact", "stream_windowed"):
                s_wav, _ = read_wav(os.path.join(tmp, out, fid))
                if s_wav.shape != wav.shape or not np.isfinite(s_wav).all():
                    fail(f"cli {out} {fid}: shape {s_wav.shape}, or not "
                         "finite")
        with open(os.path.join(tmp, "results", "r.csv")) as f:
            rows = list(csv.DictReader(f))
        values = [float(v) for row in rows for k, v in row.items()
                  if k != "utt"]
        if len(rows) != 2 or not np.isfinite(values).all():
            fail(f"cli score: {len(rows)} rows, values {values}")
        emit({"phase": "cli", "wall_s": walls, "enhance_vs_in_process": errs,
              "data_parallel_vs_plain_train": dp_err,
              "score_rows": rows, "card": card})


# --------------------------------------------------------- phase 10: parallel

# two ranks share the one card (gloo: `collectives.choose_backend`);
# parallel_cards.py runs the phase with one rank a card (NCCL)
PARALLEL_WORLD = 2
PARALLEL_DECODES = ("uformer", "dpcrn")  # 4 s utterances, 2 a rank
PARALLEL_DECODE_ROWS = 2
# family: the rows a rank of its sharded train step (FullSubNet's shard
# of 4 puts 512 rows in its sub band: the tensor-core step, as TRAIN_B)
PARALLEL_STEPS = {"dpcrn": 2, "fullsubnet": 4}
PARALLEL_REPS = 5  # timed decodes, after one untimed
# family: the launches each rank's part of a path must show; the LSTM
# layer calls by their count on either design ("lstm" the tensor-core
# step, "lstm_recur" the small fold), since a shard picks its own
# the "model" axis (ROADMAP 13b) on the same ranks: model groups of two
# ranks (an even world), and the rows a data group of its Uformer step
MODEL_STEP_ROWS = 2
UFORMER_KERNELS = {"attention": 4, "dsconv_pair": 8, "encoder": 6,
                   "decoder": 6}
PARALLEL_PATHS = {
    "uformer decode": UFORMER_KERNELS,
    "uformer decode model": UFORMER_KERNELS,
    "uformer train model": {"attention": 4, "dsconv_pair": 0, "encoder": 0,
                            "decoder": 0},
    "dpcrn decode": {"stft": 1, "lstm calls": 12},
    "dpcrn train": {"stft": 2, "lstm calls": 12},
    "fullsubnet train": {"stft": 2, "lstm": 2, "lstm_project": 2,
                         "lstm_recur": 2},
}


def _path_ok(counts: dict, want: dict) -> bool:
    got = dict(counts)
    got["lstm calls"] = got.get("lstm", 0) + got.get("lstm_recur", 0)
    return all(got.get(k, 0) == n for k, n in want.items()) and \
        got.get("lstm_project", 0) == got.get("lstm_recur", 0)


def _probe_gloo_cuda(dev) -> dict:
    """gloo's all_reduce, broadcast and all_gather on CUDA tensors, each
    result held to what it must be (the port hands gloo its CUDA tensors
    as they are: `parallel.collectives`)."""
    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    seen = {}
    for op in ("all_reduce", "broadcast", "all_gather"):
        t = torch.full((4,), float(rank + 1), device=dev)
        try:
            if op == "all_reduce":
                dist.all_reduce(t)
                want = [world * (world + 1) / 2] * 4
            elif op == "broadcast":
                dist.broadcast(t, 0)
                want = [1.0] * 4
            else:
                parts = [torch.empty_like(t) for _ in range(world)]
                dist.all_gather(parts, t)
                t, want = torch.cat(parts), [float(r + 1) for r in
                                             range(world) for _ in range(4)]
            seen[op] = "ok" if t.tolist() == want else f"wrong: {t.tolist()}"
        except Exception as err:  # the probe's answer, checked below
            seen[op] = f"{type(err).__name__}: {str(err)[:160]}"
    return seen


def parallel_rank(rank: int, world: int, out_dir: str, address: str,
                  backend_wanted: str) -> None:
    """One rank of phase 10, a process of its own on card rank % cards:
    join the group, wait for the one-process decodes' timing to end
    (DIR/go), decode Uformer and DPCRN over the mesh (one untimed call, the
    launches of one, then PARALLEL_REPS timed between barriers), take one
    sharded train step of DPCRN and FullSubNet recording its PReLU
    branches, and save it all as DIR/rank{rank}.pt. `backend_wanted`
    "nccl" is the probe: ranks that share a card under NCCL, its outcome
    saved as DIR/nccl{rank}.json."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from se_tpu_torch.eval.enhance import enhance_waveform
    from se_tpu_torch.ops import _build
    from se_tpu_torch.parallel import (
        initialize_multihost, make_mesh, rank_device,
    )
    from se_tpu_torch.parallel.collectives import barrier
    from se_tpu_torch.train.trainer import TrainConfig, make_train_step

    out = Path(out_dir)
    dev = rank_device("cuda", rank)
    torch.cuda.set_device(dev)
    if backend_wanted == "nccl":
        try:
            dist.init_process_group("nccl", init_method=address,
                                    world_size=world, rank=rank)
            t = torch.ones(4, device=dev)
            dist.all_reduce(t)
            torch.cuda.synchronize()
            said = f"ok: all_reduce gave {t.tolist()}"
        except Exception as err:  # the probe's answer
            said = f"{type(err).__name__}: {str(err)[:300]}"
        (out / f"nccl{rank}.json").write_text(json.dumps(said))
        os._exit(0)  # a refused communicator may not tear down cleanly
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = initialize_multihost(address, world, rank, "cuda")
    mesh = make_mesh()
    _build.library()
    result = {"rank": rank, "device": str(dev), "backend": backend,
              "gloo_cuda": _probe_gloo_cuda(dev) if backend == "gloo"
              else None, "paths": {}}
    while not (out / "go").exists():
        time.sleep(0.05)
    for name in PARALLEL_DECODES:
        model = seeded(name, 0).to(dev)
        wav = waveforms(PARALLEL_DECODE_ROWS * world, 0)
        enhance_waveform(name, model, wav, mesh=mesh)  # packs, cuDNN plans
        _build.LAUNCHES.clear()
        est = enhance_waveform(name, model, wav, mesh=mesh)
        counts = dict(_build.LAUNCHES)
        barrier(mesh)
        t0 = time.perf_counter()
        for _ in range(PARALLEL_REPS):
            enhance_waveform(name, model, wav, mesh=mesh)
        torch.cuda.synchronize()
        barrier(mesh)
        result["paths"][f"{name} decode"] = {
            "est": est, "launches": counts,
            "wall_s": time.perf_counter() - t0}
        del model
    for name, rows in PARALLEL_STEPS.items():
        model, init_fn, step_fn, _ = make_train_step(
            TrainConfig(model=name), device=dev, mesh=mesh)
        state = init_fn(0)
        _dropout(model, 0.0)
        batch = _train_batch(rows * world, dev, 11)
        masks: list = []
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        with prelu_branches(model, masks, record=True):
            state, loss = step_fn(state, batch)
            loss = loss.item()
        result["paths"][f"{name} train"] = {
            "loss": loss, "launches": dict(_build.LAUNCHES),
            "step_s": time.perf_counter() - t0, "masks": masks,
            "grads": {k: p.grad.detach().cpu() for k, p in
                      model.named_parameters()},
            "stats": {k: v.detach().cpu() for k, v in
                      model.named_buffers()}}
        del model, state
        torch.cuda.empty_cache()
    model_axis_rank(result, world, dev)
    torch.save(result, out / f"rank{rank}.pt")
    dist.destroy_process_group()


@contextlib.contextmanager
def kernel_rows(rows: dict):
    """While open, each `_build.launch` adds its first tensor's leading
    size (the rows a kernel took: q's N, x's B) to rows[entry]."""
    from se_tpu_torch.ops import _build

    real = _build.launch

    def launch(entry, *args):
        rows[entry] = rows.get(entry, 0) + args[0].shape[0]
        return real(entry, *args)

    _build.launch = launch
    try:
        yield rows
    finally:
        _build.launch = real


def model_mesh(world: int) -> dict:
    """Phase 10's "model" axis mesh: {"data": world / 2, "model": 2}."""
    if world % 2:
        fail(f"parallel: the model axis needs an even world, got {world}")
    return {"data": world // 2, "model": 2}


def model_axis_rank(result: dict, world: int, dev) -> None:
    """A phase-10 rank's "model" axis part (`model_mesh`): Uformer's
    decode of the data paths' batch over the mesh (one untimed call, the
    launches and kernel rows of one, PARALLEL_REPS timed), the kernel rows
    of the same decode without a mesh, and one Uformer train step at
    MODEL_STEP_ROWS a data group, dropout 0, recording its PReLU branches;
    into result["paths"]."""
    import torch

    from se_tpu_torch.eval.enhance import enhance_waveform
    from se_tpu_torch.ops import _build
    from se_tpu_torch.parallel import make_mesh
    from se_tpu_torch.parallel.collectives import barrier
    from se_tpu_torch.train.trainer import TrainConfig, make_train_step

    mesh = make_mesh(model_mesh(world))
    model = seeded("uformer", 0).to(dev)
    wav = waveforms(PARALLEL_DECODE_ROWS * world, 0)
    enhance_waveform("uformer", model, wav, mesh=mesh)
    _build.LAUNCHES.clear()
    with kernel_rows({}) as mapped:
        est = enhance_waveform("uformer", model, wav, mesh=mesh)
    counts = dict(_build.LAUNCHES)
    with kernel_rows({}) as whole:  # this rank's data rows, unmapped
        enhance_waveform("uformer", model, wav[
            mesh.data_index * len(wav) // mesh.data:
            (mesh.data_index + 1) * len(wav) // mesh.data])
    barrier(mesh)
    t0 = time.perf_counter()
    for _ in range(PARALLEL_REPS):
        enhance_waveform("uformer", model, wav, mesh=mesh)
    torch.cuda.synchronize()
    barrier(mesh)
    result["paths"]["uformer decode model"] = {
        "est": est, "launches": counts, "rows": mapped, "rows_whole": whole,
        "wall_s": time.perf_counter() - t0, "mesh": dict(mesh.shape),
        "data_index": mesh.data_index, "model_index": mesh.model_index}
    del model
    model, init_fn, step_fn, _ = make_train_step(
        TrainConfig(model="uformer"), device=dev, mesh=mesh)
    state = init_fn(0)
    _dropout(model, 0.0)
    batch = _train_batch(MODEL_STEP_ROWS * mesh.data, dev, 11)
    masks: list = []
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    with prelu_branches(model, masks, record=True):
        state, loss = step_fn(state, batch)
        loss = loss.item()
    result["paths"]["uformer train model"] = {
        "loss": loss, "launches": dict(_build.LAUNCHES),
        "step_s": time.perf_counter() - t0, "masks": masks,
        "grads": {k: p.grad.detach().cpu() for k, p in
                  model.named_parameters()},
        "stats": {k: v.detach().cpu() for k, v in model.named_buffers()},
        "data_index": mesh.data_index, "model_index": mesh.model_index}
    del model, state
    torch.cuda.empty_cache()


def _spawn_ranks(out_dir: str, backend: str, world: int) -> list:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        address = f"tcp://localhost:{sock.getsockname()[1]}"
    procs = []
    for rank in range(world):
        log = open(Path(out_dir) / f"{backend}{rank}.log", "w+")
        procs.append((log, subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--parallel-rank", str(rank), "--parallel-world", str(world),
             "--parallel-dir", out_dir,
             "--parallel-address", address, "--parallel-backend", backend],
            stdout=log, stderr=subprocess.STDOUT)))
    return procs


def _join(procs: list, seconds: float) -> list:
    """Wait for `procs` up to `seconds` in all, kill what is left; returns
    (exit code or None if killed, log tail) per process."""
    deadline = time.perf_counter() + seconds
    out = []
    for log, proc in procs:
        try:
            code = proc.wait(timeout=max(deadline - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            code = None
        log.seek(0)
        out.append((code, log.read()[-3000:]))
        log.close()
    return out


def parallel_phase(dev, card: str, world: int = PARALLEL_WORLD) -> dict:
    """Phase 10: data parallelism on the card. Two ranks, two processes on
    the one card, join a gloo group (the backend `choose_backend` picks
    for ranks that share a card), whose all_reduce, broadcast and
    all_gather on CUDA tensors must give the right values, and beside
    them two more try NCCL on the same card (reported: NCCL refuses a
    duplicate device). Before the ranks
    start their work, this process times the one-process decodes of
    Uformer and DPCRN at B = 4 x 4 s (one untimed call, PARALLEL_REPS
    timed). Each rank's part of the sharded decode (shards of 2) must
    launch its family's kernels (PARALLEL_PATHS) and its gathered output
    match the one-process card decode within 1e-3 x max|ref| (phase 4's
    rule); au-s/s of both, beside the card. Then one sharded fp32 train
    step each of DPCRN (B = 4) and FullSubNet (B = 8), dropout 0, against
    the one-process card step on the same global batch, the reference
    taking the ranks' PReLU branches where its own input is within
    round-off of 0 (`prelu_branches`, as phase 7b): the loss within 1e-4
    relative, each gradient within 1e-3 x max|ref| + GRAD_FLOOR x the
    step's largest, the BN statistics within 1e-3 x max|ref| (phase 7b's
    rules). Then the "model" axis on the same ranks (`model_axis_rank`,
    `model_mesh`): Uformer's decode of the same batch against the
    one-process decode (`model_axis_decode`) and one Uformer step at
    MODEL_STEP_ROWS a data group against the one-process step at that
    batch, by the same rules. With `world` ranks on as many cards
    (parallel_cards.py) they join an NCCL group, and the batches grow with
    the world (2 decoded utterances a rank, DPCRN 2 and FullSubNet 4 rows
    a rank in the steps; the model axis a {"data": 2, "model": 2} mesh at
    four). Returns the launches of each rank's paths."""
    import tempfile

    import numpy as np
    import torch

    from se_tpu_torch.eval.enhance import enhance_waveform
    from se_tpu_torch.ops import _build
    from se_tpu_torch.train.trainer import TrainConfig, make_train_step

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _spawn_ranks(tmp, "auto", world)
        shared = world > torch.cuda.device_count()  # ranks share a card
        probe = _spawn_ranks(tmp, "nccl", world) if shared else []
        wav = waveforms(PARALLEL_DECODE_ROWS * world, 0)
        ref = {}
        for name in PARALLEL_DECODES:
            model = seeded(name, 0).to(dev)
            enhance_waveform(name, model, wav)
            t0 = time.perf_counter()
            for _ in range(PARALLEL_REPS):
                est = enhance_waveform(name, model, wav)
            torch.cuda.synchronize()
            ref[name] = (est, time.perf_counter() - t0)
            del model
        torch.cuda.empty_cache()
        (Path(tmp) / "go").touch()
        done = _join(ranks, 240)
        probed = _join(probe, 5)
        for rank, (code, log) in enumerate(done):
            if code != 0:
                fail(f"parallel rank {rank}: exit {code}\n{log}")
        results = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                   for r in range(world)]
        nccl = []
        for rank, (code, log) in enumerate(probed):
            said = Path(tmp) / f"nccl{rank}.json"
            nccl.append(json.loads(said.read_text()) if said.exists() else
                        f"exit {code}: {log[-300:]}")
    t_ranks = time.perf_counter() - t_phase
    emit({"phase": "parallel", "check": "ranks", "world": world,
          "backend": results[0]["backend"],
          "devices": [r["device"] for r in results],
          "gloo_cuda": [r["gloo_cuda"] for r in results],
          "nccl_two_ranks_one_card": nccl, "card": card})
    if results[0]["backend"] != ("gloo" if shared else "nccl") or shared \
            and any(v != "ok" for r in results
                    for v in r["gloo_cuda"].values()):
        fail("parallel: ranks that share a card must run gloo, and gloo "
             "must take CUDA tensors; a card a rank NCCL: "
             f"{results[0]['backend']}, {[r['gloo_cuda'] for r in results]}")
    launches = {}
    audio_s = PARALLEL_DECODE_ROWS * world * SECONDS * PARALLEL_REPS
    for name in PARALLEL_DECODES:
        want, one_wall = ref[name]
        tol = 1e-3 * float(np.abs(want).max())
        errs, walls = [], []
        for r in results:
            part = r["paths"][f"{name} decode"]
            launches[f"{name} decode rank {r['rank']}"] = part["launches"]
            walls.append(part["wall_s"])
            errs.append(float(np.abs(part["est"] - want).max()))
            if part["est"].shape != want.shape or not errs[-1] <= tol:
                fail(f"parallel {name} decode, rank {r['rank']}: "
                     f"{errs[-1]} > {tol} from the one-process decode")
            if not _path_ok(part["launches"],
                            PARALLEL_PATHS[f"{name} decode"]):
                fail(f"parallel {name} decode, rank {r['rank']}: launches "
                     f"{part['launches']}, expected "
                     f"{PARALLEL_PATHS[f'{name} decode']}")
        emit({"phase": "parallel", "model": name, "check": "sharded decode "
              "vs one-process card decode",
              "batch": PARALLEL_DECODE_ROWS * world, "shards": world,
              "max_abs_err": errs, "tol": tol,
              "launches": {r["rank"]: r["paths"][f"{name} decode"]
                           ["launches"] for r in results},
              "au_s_per_s_sharded": audio_s / max(walls),
              "au_s_per_s_one_process": audio_s / one_wall, "card": card})
    mmesh = model_mesh(world)
    launches.update(model_axis_decode(results, ref["uformer"][0], world,
                                      card))
    steps = [(f"{name} train", name, rows * world)
             for name, rows in PARALLEL_STEPS.items()]
    steps.append(("uformer train model", "uformer",
                  MODEL_STEP_ROWS * mmesh["data"]))
    for path, name, b in steps:
        parts = [r["paths"][path] for r in results]
        for r, part in zip(results, parts):
            launches[f"{path} rank {r['rank']}"] = part["launches"]
            if not _path_ok(part["launches"], PARALLEL_PATHS[path]):
                fail(f"parallel {path}, rank {r['rank']}: launches "
                     f"{part['launches']}, expected {PARALLEL_PATHS[path]}")
        # the global batch's PReLU branches: each call's rows from one
        # rank of each data coordinate (a model group's ranks hold the
        # same rows), in data order
        masks = [torch.cat(call) for call in zip(*(
            p["masks"] for p in parts if p.get("model_index", 0) == 0))]
        model, init_fn, step_fn, _ = make_train_step(TrainConfig(model=name),
                                                     device=dev)
        state = init_fn(0)
        _dropout(model, 0.0)
        batch = _train_batch(b, dev, 11)
        t0 = time.perf_counter()
        with prelu_branches(model, masks, record=False) as seen:
            state, loss = step_fn(state, batch)
            loss = loss.item()
        one_s = time.perf_counter() - t0
        grads = {k: p.grad.detach().cpu() for k, p in
                 model.named_parameters()}
        stats = {k: v.detach().cpu() for k, v in model.named_buffers()}
        floor = GRAD_FLOOR * max(float(g.abs().max()) for g in
                                 grads.values())
        worst = []
        for r, part in zip(results, parts):
            loss_err = abs(part["loss"] - loss) / abs(loss)
            g_over = max((float((part["grads"][k] - g).abs().max())
                          / (1e-3 * float(g.abs().max()) + floor), k)
                         for k, g in grads.items())
            s_err = max([float((part["stats"][k] - v).abs().max())
                         / (float(v.abs().max()) or 1.0)
                         for k, v in stats.items()] or [0.0])
            worst.append({"rank": r["rank"], "loss": part["loss"],
                          "loss_rel_err": loss_err,
                          "grad_err_over_tol": g_over,
                          "bn_stat_err_over_max": s_err,
                          "step_s": part["step_s"]})
            if not (loss_err <= 1e-4 and g_over[0] <= 1.0
                    and s_err <= 1e-3):
                fail(f"parallel {path}, rank {r['rank']}: loss "
                     f"{loss_err}, gradient {g_over}, statistics {s_err} "
                     "past phase 7b's tolerances")
        emit({"phase": "parallel", "model": name, "check": "sharded train "
              "step vs one-process card step", "path": path, "batch": b,
              "mesh": mmesh if path.endswith("model")
              else {"data": world}, "loss_one_process": loss,
              "step_s_one_process": one_s,
              "ranks": worst, "grad_floor": floor,
              "prelu_flips_taken_from_the_ranks": seen["flips"],
              "launches": {r["rank"]: p["launches"]
                           for r, p in zip(results, parts)}, "card": card})
        del model, state
        torch.cuda.empty_cache()
    emit({"phase": "parallel", "check": "phase seconds",
          "ranks_s": t_ranks, "seconds": time.perf_counter() - t_phase})
    return launches


def model_axis_decode(results: list, want, world: int, card: str) -> dict:
    """Phase 10's "model" axis decode: each rank's gathered Uformer decode
    against the one-process card decode `want` of the same batch, within
    1e-5 * max|ref| where a data group holds the whole batch (the convs
    then see one process's rows) and phase 4's 1e-3 * max|ref| otherwise
    (other row counts pick other cuDNN algorithms: 2.7e-5 of max on four
    cards, PERF.md); its launches (PARALLEL_PATHS), and every kernel entry
    having taken 1/model of the rows the same decode gives it unmapped.
    Returns each rank's launches."""
    import numpy as np

    mesh = model_mesh(world)
    rel = 1e-5 if mesh["data"] == 1 else 1e-3
    tol = rel * float(np.abs(want).max())
    launches, errs, walls = {}, [], []
    for r in results:
        part = r["paths"]["uformer decode model"]
        launches[f"uformer decode model rank {r['rank']}"] = part["launches"]
        walls.append(part["wall_s"])
        errs.append(float(np.abs(part["est"] - want).max()))
        if part["est"].shape != want.shape or not errs[-1] <= tol:
            fail(f"parallel uformer decode model, rank {r['rank']}: "
                 f"{errs[-1]} > {tol} from the one-process decode")
        if not _path_ok(part["launches"],
                        PARALLEL_PATHS["uformer decode model"]):
            fail(f"parallel uformer decode model, rank {r['rank']}: "
                 f"launches {part['launches']}, expected "
                 f"{PARALLEL_PATHS['uformer decode model']}")
        halves = {k: (n, part["rows_whole"].get(k)) for k, n in
                  part["rows"].items()}
        if not halves or any(n * mesh["model"] != whole
                             for n, whole in halves.values()):
            fail(f"parallel uformer decode model, rank {r['rank']}: the "
                 f"kernels' rows (mapped, unmapped) {halves} are not "
                 f"1/{mesh['model']} of the unmapped decode's")
    audio_s = PARALLEL_DECODE_ROWS * world * SECONDS * PARALLEL_REPS
    emit({"phase": "parallel", "model": "uformer", "check": "model-axis "
          "decode vs one-process card decode", "mesh": mesh,
          "batch": PARALLEL_DECODE_ROWS * world, "max_abs_err": errs,
          "tol": tol, "kernel_rows": {r["rank"]: r["paths"][
              "uformer decode model"]["rows"] for r in results},
          "launches": {r["rank"]: r["paths"]["uformer decode model"]
                       ["launches"] for r in results},
          "au_s_per_s_model_axis": audio_s / max(walls), "card": card})
    return launches


def kernel_resources(lib) -> dict:
    """Phase 2: the bf16 tensor-core kernels' registers, spill bytes,
    dynamic shared bytes and resident blocks an SM as the runtime reports
    them (their `*_resources` entries: the encoder and decoder levels',
    the flash attention's at each warps a block it launches, the pair
    stage's and the single block's, at the conformer's widths, the LSTM
    projection's and recurrence's). Fails where an entry does."""
    import ctypes

    from se_tpu_torch.ops import lstm

    names = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm")
    res = (ctypes.c_int * 8)()
    out = {}
    for kind in ("encoder", "decoder"):
        entry = f"se_{kind}_level_tc_bf16_resources"
        if getattr(lib, entry)(res):
            fail(f"{entry} failed")
        out[f"{kind}_level_tc_bf16"] = dict(zip(names, res[:4]))
    for warps in (1, 2, 4):  # `attention.flash_warps`'s choices
        if lib.se_att_flash_tc_bf16_resources(warps, res):
            fail("se_att_flash_tc_bf16_resources failed")
        out[f"att_flash_bf16<{warps}>"] = dict(zip(names, res[:4]))
    if lib.se_dsconv_pair_tc_bf16_resources(64, 32, res):
        fail("se_dsconv_pair_tc_bf16_resources failed")
    out["dsconv_pre_bf16"] = dict(zip(names, res[:4]))
    out["dsconv_post_bf16"] = dict(zip(names, res[4:]))
    # the single block in bf16 (row dsconv_bf16), complex and real
    for ncomp, tot in ((2, 64), (1, 32)):
        if lib.se_dsconv_block_tc_bf16_resources(ncomp, tot, res):
            fail("se_dsconv_block_tc_bf16_resources failed")
        nt = "NT_C" if ncomp == 2 else "NT_M"
        out[f"dsconv_block_pre_bf16<{nt}>"] = dict(zip(names, res[:4]))
        out[f"dsconv_block_post_bf16<{nt}>"] = dict(zip(names, res[4:]))
    # the bf16 small fold: the projection for either x, the recurrence in
    # each of its designs at one row chunk a block and H = 1024 and 128
    for x_bf16 in (0, 1):
        if lib.se_lstm_project_bf16_resources(x_bf16, res):
            fail("se_lstm_project_bf16_resources failed")
        out[f"lstm_proj_bf16<{'bf16' if x_bf16 else 'float'}>"] = dict(
            zip(names, res[:4]))
    for tile, warps in lstm.BF16_DESIGNS:
        for kh in (1024, 128):
            if lib.se_lstm_recur_bf16_resources(kh, 1, tile, warps, res):
                fail("se_lstm_recur_bf16_resources failed")
            out[f"lstm_recur_bf16<{tile}, {warps}> Kh={kh}"] = dict(
                zip(names, res[:4]))
    return out


def parse_args():
    import argparse

    p = argparse.ArgumentParser(
        description="Drive se_tpu_torch's main paths on one NVIDIA GPU and "
        "hold every kernel against its twin (all of them by default).")
    p.add_argument("--kernels", default=",".join(ROW_PATH),
                   help="phase 3 for these kernels only (comma-separated)")
    p.add_argument("--families", default=",".join(MAIN_PATHS),
                   help="phases 4-10 for these families only (phase 9 "
                   "needs dpcrn, lstm and gcrn; phase 10 uformer, dpcrn "
                   "and fullsubnet)")
    # phase 10's rank processes (this script run again by itself)
    for flag in ("--parallel-rank", "--parallel-world", "--parallel-dir",
                 "--parallel-address", "--parallel-backend"):
        p.add_argument(flag, default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    args.kernels = args.kernels.split(",")
    args.families = args.families.split(",")
    unknown = (set(args.kernels) - set(ROW_PATH)) | (set(args.families)
                                                     - set(MAIN_PATHS))
    if unknown:
        p.error(f"unknown kernel or family: {', '.join(sorted(unknown))}")
    return args


def main() -> None:
    args = parse_args()
    start = time.perf_counter()
    import torch

    walls, last = {}, [start]  # each phase's wall seconds

    def elapsed(done: str) -> None:
        now = time.perf_counter()
        walls[done] = now - last[0]
        last[0] = now
        emit({"phase": "elapsed", "done": done, "seconds": now - start})

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    if not (ROOT / "se_tpu_torch" / "csrc").is_dir():
        fail(f"no se_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    if args.parallel_rank is not None:  # a phase-10 rank, not the script
        parallel_rank(int(args.parallel_rank), int(args.parallel_world),
                      args.parallel_dir, args.parallel_address,
                      args.parallel_backend)
        return
    from se_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs (the bf16 Uformer's dense layers through cuBLAS) sum in
    # fp32, as se_tpu's bf16 products do: no bf16 partial sums in split-K
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    dev = torch.device("cuda")
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device_name": torch.cuda.get_device_name(0),
          "allow_tf32": False, "cudnn_allow_tf32": False,
          "allow_bf16_reduced_precision_reduction": False})

    t0 = time.perf_counter()
    lib = _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in _build.build_log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or ln.startswith("==")],
          "resources": kernel_resources(lib)})
    elapsed("1-2 env, build")
    table = check_kernels(dev, args.kernels)
    elapsed("3 kernel")
    models, counts, totals = {}, {}, {}
    for name in args.families:
        model, cpu_model, counts[name] = main_path(name, dev,
                                                   _build.LAUNCHES)
        models[name] = model, cpu_model
    bf16_families = [f for f in BF16_PATHS if f in args.families]
    for name in bf16_families:  # phase 4b
        counts[f"{name} bf16"] = bf16_path(name, *models[name],
                                           _build.LAUNCHES)
    if "uformer" in models:  # phase 4c
        counts.update(entry_paths(models["uformer"][0], dev,
                                  _build.LAUNCHES))
    for path in counts.values():
        for kernel, n in path.items():
            totals[kernel] = totals.get(kernel, 0) + n
    for name, row in table.items():
        # the launches of the forward whose times the row sums
        row["launches"] = counts.get(ROW_PATH[name], {}).get(name, 0)
        row["launches_all_paths"] = totals.get(name, 0)
    elapsed("4 main, 4b main bf16, 4c entry")
    for name, (model, cpu_model) in models.items():
        throughput(name, model, cpu_model, card)
        if name in bf16_families:  # beside fp32, in the same call
            throughput(name, model, cpu_model, card, torch.bfloat16)
    elapsed("5 speed")
    for name, (model, _) in models.items():
        profile(name, model, card)
        if name in PROFILE_KERNELS_BF16:
            profile(name, model, card, torch.bfloat16)
    del models
    torch.cuda.empty_cache()

    elapsed("6 profile")
    grad_errors = check_gradients(dev, args.kernels, _build.LAUNCHES)
    if "lstm" in args.kernels:
        lstm_train_yardsticks(dev, card)
    elapsed("7a train gradients")
    train_counts, cpu_fp32_steps, checks = {}, {}, []
    train_families = [f for f in TRAIN_PATHS if f in args.families]
    with cpu_workers() as pool:  # the CPU's sides beside the card's
        for name in train_families:
            if name in DEEPXI_NETWORK:
                checks.append((name, deepxi_train_vs_cpu(
                    name, dev, _build.LAUNCHES, pool)))
            for loss_fn in () if name in DEEPXI_NETWORK else \
                    TRAIN_LOSSES.get(name, ("default",)):
                key = name if loss_fn == "default" else f"{name} {loss_fn}"
                checks.append((key, train_vs_cpu(name, dev, _build.LAUNCHES,
                                                 pool, loss_fn)))
                elapsed(f"7b/7c {key} card")
            torch.cuda.empty_cache()
        for name in (f for f in BF16_TRAIN_PATHS if f in args.families):
            checks.append((f"{name} bf16", bf16_train_vs_cpu(
                name, dev, _build.LAUNCHES, pool)))
            torch.cuda.empty_cache()
            elapsed(f"7e {name} card")
        for key, finish in checks:  # in order: 7e takes 7b's fp32 steps
            train_counts[key] = finish(cpu_fp32_steps)
    elapsed("7b/7c/7e the CPU's sides")
    for name in train_families:
        if name in DEEPXI_NETWORK:
            train_throughput(name, deepxi_step(name, dev), card, True)
            elapsed(f"7d {name}")
        for dtype in () if name in DEEPXI_NETWORK else \
                ("fp32", "bf16") if name in TRAIN_BF16_SPEED else ("fp32",):
            train_throughput(
                name, trainer_step(name, dev, dtype=dtype), card,
                name not in TRAIN_UNPROFILED and dtype == "fp32", dtype)
            torch.cuda.empty_cache()
            elapsed(f"7d {name} {dtype}")
    for name, row in table.items():
        row["backward"] = BACKWARD[name]
        row["grad_max_abs_err"] = grad_errors.get(name)
        row["launches_train_step"] = {
            fam: c.get(name, 0) for fam, c in train_counts.items()}

    elapsed("7d train speed")
    stream_counts = {}
    for name in (f for f in STREAM_PATHS if f in args.families):
        stream_counts[f"{name} stream"] = stream_path(name, dev,
                                                      _build.LAUNCHES, card)
    if "uformer" in args.families:
        stream_counts["uformer windowed"] = windowed_uformer(
            dev, _build.LAUNCHES, card)
    torch.cuda.empty_cache()
    elapsed("8 stream")
    if set(CLI_FAMILIES) <= set(args.families):
        cli_phase(dev, card)
    elapsed("9 cli")
    parallel_counts = {}
    if {*PARALLEL_DECODES, *PARALLEL_STEPS} <= set(args.families):
        parallel_counts = parallel_phase(dev, card)
    elapsed("10 parallel")
    for name, row in table.items():
        row["launches_stream"] = {path: c.get(name, 0)
                                  for path, c in stream_counts.items()}
        row["launches_parallel"] = {path: c.get(name, 0)
                                    for path, c in parallel_counts.items()}

    emit({"phase": "wall", "seconds": walls,
          "total": time.perf_counter() - start})
    print(card, flush=True)
    emit({"kernels": list(table.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
