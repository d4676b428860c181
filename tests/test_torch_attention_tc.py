"""The two designs of the attention kernel (csrc/attention.cu
`att_flash_tc`, `att_small_l`) on the CPU: the kernels run only on the
card (tests/test_torch_cuda.py), so what they compute is formed here in
plain torch as they form it, and held against the twin
`attention._reference`, itself held against se_tpu's Pallas kernel run
with interpret=True (as tests/test_pallas_attention.py runs it).

- The P . V step needs no shuffle: with S's accumulator registers taken as
  P's A fragments in the order (c0, c2, c1, c3), and V's B fragment rows
  read as keys 8 j + 2 tq and 8 j + 2 tq + 1, each m16n8k8 product is the
  tile's P . V over its 8 keys (mma.sync's fragment layouts, exactly).
- The flash kernel's tiles: 64 keys a tile, keys >= L masked to -inf,
  logits scaled by scale * log2(e), the online softmax (running max,
  exp2, O and l rescaled a tile), each tile's P . V summed in a fresh
  fragment, O / l at the end; in float64 and in the kernel's 3xTF32
  (tests/test_torch_lstm_tc.py's emulation), at L = 1 to 401, with
  logits up to +-80, within 1e-5 * max(1, max|twin|).
- The small-L kernel's per-row arithmetic (fp32 FMAs over the 16 channels,
  exp2, one pass for the max and one for the sums).
- `att_design` and `flash_warps` on Uformer's four shapes at B = 4 and 32.
"""

import math

import numpy as np
import pytest
import torch

from se_tpu.ops import pallas_attention as jatt
from se_tpu_torch.ops import attention
from test_torch_lstm_tc import matmul_3xtf32
from torch_kernel_inputs import att_inputs, close, to_torch

RTOL = 1e-5
LOG2E = math.log2(math.e)


def _fp64(a, b):
    return (a.double() @ b.double()).float()


# mma.sync.m16n8k8 .tf32 fragment layouts (PTX ISA): lane = 4 gid + tq
def c_coords(lane, i):
    """Accumulator register i of a lane: (row, col) of the 16 x 8 tile."""
    gid, tq = divmod(lane, 4)
    return gid + 8 * (i >> 1), 2 * tq + (i & 1)


def a_coords(lane, i):
    """A register i: (row, k) of the 16 x 8 tile."""
    gid, tq = divmod(lane, 4)
    return gid + 8 * (i & 1), tq + 4 * (i >> 1)


def b_coords(lane, i):
    """B register i: (k, col) of the 8 x 8 tile."""
    gid, tq = divmod(lane, 4)
    return tq + 4 * i, gid


def test_pv_fragments_need_no_shuffle(rng):
    """For each k8 step j of a 64-key tile, A built from S's accumulators
    as the kernel reuses them (a = (c0, c2, c1, c3) of n8 tile j) and B
    from V's rows 8 j + 2 tq + i (i = 0, 1; column gid) multiply to the
    step's P . V, whatever order the keys take inside the step."""
    p = torch.from_numpy(rng.random((16, 64)))
    v = torch.from_numpy(rng.standard_normal((64, 16)))
    got = torch.zeros(16, 16, dtype=torch.float64)
    for dn in range(2):
        for j in range(8):
            a = torch.zeros(16, 8, dtype=torch.float64)
            b = torch.zeros(8, 8, dtype=torch.float64)
            for lane in range(32):
                gid, tq = divmod(lane, 4)
                for i, ci in enumerate((0, 2, 1, 3)):
                    r, col = c_coords(lane, ci)  # S tile j's register ci
                    a[a_coords(lane, i)] = p[r, 8 * j + col]
                for i in range(2):
                    b[b_coords(lane, i)] = v[8 * j + 2 * tq + i, 8 * dn + gid]
            got[:, 8 * dn:8 * dn + 8] += a @ b
    torch.testing.assert_close(got, p @ v, rtol=1e-12, atol=1e-12)


def flash_emulated(q, k, v, scale, matmul):
    """att_flash_tc on (NH, L, 16): 64-key tiles, the online softmax in
    log2 units, each tile's P . V in a fresh sum added to the rescaled O."""
    nh, length, d = q.shape
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full((nh, length), -math.inf)
    lsum = torch.zeros(nh, length)
    acc = torch.zeros(nh, length, d)
    for k0 in range(0, length, attention.FLASH_KEYS):
        pad = max(0, k0 + attention.FLASH_KEYS - length)
        kt = torch.nn.functional.pad(k[:, k0:k0 + attention.FLASH_KEYS],
                                     (0, 0, 0, pad))  # the copies' zero fill
        vt = torch.nn.functional.pad(v[:, k0:k0 + attention.FLASH_KEYS],
                                     (0, 0, 0, pad))
        s = matmul(q, kt.transpose(1, 2)) * c
        keys = k0 + torch.arange(attention.FLASH_KEYS)
        s = torch.where(keys < length, s, -math.inf)
        mnew = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - mnew)
        m = mnew
        p = torch.exp2(s - m[..., None])
        lsum = lsum * corr + p.sum(-1)
        acc = acc * corr[..., None] + matmul(p, vt)
    return acc / lsum[..., None]


def small_l_emulated(q, k, v, scale):
    """att_small_l's thread: its q row's L dot products (fp32 FMAs over
    the 16 channels in order), scaled by scale * log2(e), exp2 against
    the row max, then the weighted sum of v rows, / l."""
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    s = torch.zeros(q.shape[:-1] + (k.shape[1],))
    for ch in range(q.shape[-1]):
        s = s + q[..., ch:ch + 1] * k[:, None, :, ch]
    s = s * c
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    acc = torch.zeros_like(q)
    for j in range(k.shape[1]):
        acc = acc + p[..., j:j + 1] * v[:, j:j + 1]
    return acc / p.sum(-1, keepdim=True)


def _inputs(rng, nh, length, max_logit=None, scale=0.25):
    q, k, v = to_torch(att_inputs(rng, nh, 1, length))
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    if max_logit is not None:  # scale q so that max |logit| = max_logit
        q = q * (max_logit / float((q @ k.transpose(1, 2) * scale)
                                   .abs().max()))
    return q, k, v


def _close(got, want, rtol=RTOL):
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("matmul", [_fp64, matmul_3xtf32],
                         ids=["fp64", "3xtf32"])
@pytest.mark.parametrize("max_logit", [None, 80.0])
@pytest.mark.parametrize("length", [1, 4, 5, 63, 64, 65, 401])
def test_flash_tiles_match_twin(rng, length, max_logit, matmul):
    q, k, v = _inputs(rng, 3, length, max_logit)
    want = attention._reference(q[:, None], k[:, None], v[:, None], 0.25)
    _close(flash_emulated(q, k, v, 0.25, matmul), want[:, 0])


@pytest.mark.parametrize("max_logit", [None, 80.0])
@pytest.mark.parametrize("length", [1, 4, 5, 16, 32])
def test_small_l_rows_match_twin(rng, length, max_logit):
    q, k, v = _inputs(rng, 40, length, max_logit)
    want = attention._reference(q[:, None], k[:, None], v[:, None], 0.25)
    _close(small_l_emulated(q, k, v, 0.25), want[:, 0])


@pytest.mark.parametrize("h", [8, 1])
@pytest.mark.parametrize("length", [4, 65, 401])
def test_twin_matches_pallas(rng, length, h):
    """The twin against se_tpu's kernel in interpret mode (its einsum for
    L < 64) and its `_reference`: 2e-6 absolute, as
    tests/test_pallas_attention.py holds the two."""
    q, k, v = att_inputs(rng, 2, h, length)
    got = attention._reference(*to_torch((q, k, v)), 0.25)
    close([got], [jatt.sdp_attention(q, k, v, 0.25, interpret=True)], 2e-6)
    close([got], [jatt._reference(q, k, v, 0.25)], 2e-6)


# Uformer's four attention calls at batch B: (N, H, L, design, warps on 132
# SMs): T-attention over 401 frames (N = 4 B bins), F-attention over 4 bins
# (N = 401 B frames); complex 8 heads, real 1
@pytest.mark.parametrize("b,n,h,length,design,warps", [
    (4, 16, 8, 401, "flash_tc", 4), (4, 16, 1, 401, "flash_tc", 1),
    (4, 1604, 8, 4, "small_l", None), (4, 1604, 1, 4, "small_l", None),
    (32, 128, 8, 401, "flash_tc", 4), (32, 128, 1, 401, "flash_tc", 4),
    (32, 12832, 8, 4, "small_l", None), (32, 12832, 1, 4, "small_l", None)])
def test_att_design_on_uformers_shapes(b, n, h, length, design, warps):
    assert attention.att_design(n * h, length) == design
    if warps is not None:
        assert attention.flash_warps(n * h, length, 132) == warps


@pytest.mark.parametrize("nh,length,warps", [
    (1, 1, 1), (16, 401, 1), (128, 401, 4), (12832, 4, 1), (12832, 32, 2),
    (12832, 33, 2), (12832, 49, 4), (12, 1500, 4), (8, 1500, 2),
    (4, 1500, 1)])
def test_flash_warps_fill_two_waves(nh, length, warps):
    """The most warps (4, 2, 1) whose grid still fills two waves of 132
    SMs and whose last warp owns a row."""
    assert attention.flash_warps(nh, length, 132) == warps
    blocks = nh * -(-length // (16 * warps))
    assert 16 * (warps - 1) < length or warps == 1
    assert blocks >= 264 or warps == 1
