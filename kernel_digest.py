#!/usr/bin/env python3
"""Print a SHA-256 digest of the outputs of se_tpu_torch's kernels, on
inputs made from a seed, on one NVIDIA GPU: every fp32 design of Uformer's
kernels (attention's flash and short-L kernels, the encoder and decoder
levels on the tensor cores and the CUDA cores, the DSConv pair stage and
the single block), the bf16 decoder level, pair stage and single block,
Uformer's fp32 forward from a seeded model, the fp32 LSTM kernels (the
tensor-core step, the small fold's projection and recurrence: forward,
reverse, with a carry) and the bf16 large-fold step (fp32 and bf16 x).
Equal digests are equal outputs, bit for bit: run the script from the
root of each of two trees on the same card and compare the lines, to show
that a change left these kernels' results as they were.

    python3 kernel_digest.py

One line a case, `<sha256> <case>`, then the card's name and power limit.
Needs only the kernel wrappers' public entry points, so it runs against
an older tree too (copy the script to that tree's root).
"""

from __future__ import annotations

import hashlib
import subprocess
import sys
from pathlib import Path

# Uformer's channel widths, input to output (models/uformer.py KERNELS)
KERNELS = (1, 8, 16, 32, 64, 128, 128)
B, T = 2, 50


def digest(out) -> str:
    """SHA-256 of a tensor's (or a nest of tensors') bytes, on the host."""
    import torch

    h = hashlib.sha256()
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(t, (tuple, list)):
            h.update(digest(t).encode())
            continue
        t = t.detach().cpu().contiguous()
        h.update(str((tuple(t.shape), t.dtype)).encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_digest: torch.cuda.is_available() is false")
    sys.path.insert(0, str(Path.cwd()))
    from se_tpu_torch.models import get_model
    from se_tpu_torch.ops import attention, decoder, dsconv, encoder, lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    bf16 = torch.bfloat16

    def r(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=gen)).to(dev)

    def tail(c):  # bias, BN scale, BN shift, PReLU slope
        return (r(1, c, scale=0.1), r(1, c, scale=0.1, shift=1.0),
                r(1, c, scale=0.1), r(1, 1, scale=0.05, shift=0.25))

    def level16(params):  # conv weights bf16, tail vectors fp32 of bf16
        return tuple(p.to(bf16) if p.dim() > 2 else p.to(bf16).float()
                     for p in params)

    def block_params(cin, tot):
        return (r(1, cin, scale=0.1, shift=1.0), r(1, cin, scale=0.1),
                r(cin, tot, scale=cin ** -0.5), r(1, tot, scale=0.1),
                r(1, 1, scale=0.05, shift=0.25),
                r(9 * tot, tot, scale=(9 * tot) ** -0.5),
                r(1, tot, scale=0.1),
                r(9 * tot, tot, scale=(9 * tot) ** -0.5),
                r(1, tot, scale=0.1), r(1, tot, scale=0.1, shift=1.0),
                r(1, tot, scale=0.1), r(tot, cin, scale=tot ** -0.5),
                r(1, cin, scale=0.1))

    cases = []
    with torch.no_grad():
        for n, h, length in ((B * 4, 8, 401), (B * 4, 1, 401),
                             (B * 401, 8, 4), (B * 401, 1, 4)):
            q, k, v = (r(n, h, length, 16, scale=0.5) for _ in range(3))
            for design in attention.DESIGNS:
                if design == "small_l" and length > attention.SMALL_L_MAX:
                    continue
                cases.append((f"attention fp32 {n}x{h}x{length} {design}",
                              attention._launch(q, k, v, 0.25, design)))
        for i in range(6):
            f, cin, cout = 256 >> i, KERNELS[i], KERNELS[i + 1]
            params = (r(2, 5, 2 * cin, 2 * cout, scale=(20 * cin) ** -0.5),
                      *tail(2 * cout),
                      r(2, 5, cin, cout, scale=(10 * cin) ** -0.5),
                      *tail(cout))
            xc, xm = r(B, T, f, 2 * cin), r(B, T, f, cin)
            designs = [encoder.level_design(cin)]
            designs += ["cuda_core"] if cin <= 16 and cin % 4 == 0 else []
            for design in designs:
                cases.append((f"encoder fp32 level {i} {design}",
                              encoder._launch(xc, xm, params, design)))
        for i in range(6):
            f, cc, cout = 4 << i, 2 * KERNELS[6 - i], KERNELS[5 - i]
            params = (r(6, 2 * cc, 2 * cout, scale=(12 * cc) ** -0.5),
                      r(4, 2 * cc, 2 * cout, scale=(8 * cc) ** -0.5),
                      *tail(2 * cout),
                      r(6, cc, cout, scale=(6 * cc) ** -0.5),
                      r(4, cc, cout, scale=(4 * cc) ** -0.5), *tail(cout))
            xc, xm = r(B, T, f, 2 * cc), r(B, T, f, cc)
            has_bn = i < 5
            design = decoder.level_design(cc, cout)
            cases.append((f"decoder fp32 level {i} {design}",
                          decoder.decoder_level(xc, xm, params, has_bn)))
            if design == "tc":
                cases.append((f"decoder bf16 level {i}",
                              decoder.decoder_level(
                                  xc.to(bf16), xm.to(bf16), level16(params),
                                  has_bn)))
        c = KERNELS[-1]
        xc, xm = r(B, T, 4, 2 * c, scale=0.5), r(B, T, 4, c, scale=0.5)
        pc, pm = block_params(2 * c, 64), block_params(c, 32)
        for d1, d2 in ((1, 128), (8, 16)):
            cases.append((f"dsconv_pair fp32 d=({d1},{d2})",
                          dsconv.dsconv_pair_block(xc, xm, pc, pm, d1, d2)))
            cases.append((f"dsconv_pair bf16 d=({d1},{d2})",
                          dsconv.dsconv_pair_block(
                              xc.to(bf16), xm.to(bf16),
                              tuple(p.to(bf16) for p in pc),
                              tuple(p.to(bf16) for p in pm), d1, d2)))
        for ncomp, x, params in ((2, xc, pc), (1, xm, pm)):
            cases.append((f"dsconv_block fp32 ncomp={ncomp}",
                          dsconv.dsconv_block(x, params, 1, 128, ncomp)))
            cases.append((f"dsconv_block bf16 ncomp={ncomp}",
                          dsconv.dsconv_block(
                              x.to(bf16), tuple(p.to(bf16) for p in params),
                              1, 128, ncomp)))
        # the LSTM: (Bf, T, In, H) of a sub-band-like step (In 32 and 161:
        # 16-byte and 4-byte copies; H = 44 a ragged unit tile) and of
        # small folds (H = 128, 1024; H = 20 the 4-byte staging)
        for bf, t, in_dim, h in ((200, 12, 32, 64), (70, 9, 161, 44)):
            wx, wh, b = (r(*shape, scale=h ** -0.5)
                         for shape in ((in_dim, 4 * h), (h, 4 * h), (4 * h,)))
            x = r(bf, t, in_dim)
            h0, c0 = r(bf, h, scale=0.5), r(bf, h, scale=0.5)
            for reverse, carry in ((False, False), (True, True)):
                state = (h0, c0) if carry else (None, None)
                cases.append((f"lstm step fp32 {bf}x{t}x{in_dim}->{h} "
                              f"reverse={reverse} carry={carry}",
                              lstm.lstm_step(x, wx, wh, b, reverse, *state)))
                for x_dtype in (torch.float32, bf16):
                    cases.append((
                        f"lstm step bf16 {bf}x{t}x{in_dim}->{h} x "
                        f"{x_dtype} reverse={reverse} carry={carry}",
                        lstm.lstm_step(x.to(x_dtype), wx.to(bf16),
                                       wh.to(bf16), b.to(bf16), reverse,
                                       *state)))
        for bf, t, in_dim, h in ((8, 30, 161, 128), (4, 20, 64, 1024),
                                 (30, 9, 33, 20)):
            wx, wh, b = (r(*shape, scale=h ** -0.5)
                         for shape in ((in_dim, 4 * h), (h, 4 * h), (4 * h,)))
            x = r(bf, t, in_dim)
            cases.append((f"lstm project fp32 {bf}x{t}x{in_dim}->{4 * h}",
                          lstm.lstm_project(x, wx, b)))
            xp = r(bf, t, 4 * h)
            h0, c0 = r(bf, h, scale=0.5), r(bf, h, scale=0.5)
            for reverse, carry in ((False, False), (True, True)):
                state = (h0, c0) if carry else (None, None)
                cases.append((f"lstm recur fp32 {bf}x{t}x{h} "
                              f"reverse={reverse} carry={carry}",
                              lstm.lstm_recur(xp, wh, reverse, *state)))
        model = get_model("uformer").make(
            device=dev, generator=torch.Generator().manual_seed(0))
        noisy, src = r(B, 16000, scale=0.1), r(B, 16000, scale=0.1)
        cases.append(("uformer fp32 forward", model(noisy, src)))
    torch.cuda.synchronize()
    for name, out in cases:
        print(digest(out), name, flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
