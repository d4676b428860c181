"""The FFT design of the fused STFT kernel (csrc/stft.cu) on the CPU: the
kernel runs only on the card (tests/test_torch_cuda.py), so its arithmetic
is formed here in numpy, float32, stage by stage as the kernel forms it:
the windowed frame read from the waveform through the kernel's padding
map (`padded`, held against `pad_signal` here) as n/2 complex points (n
complex points of zero imaginary part for an odd n), the Stockham radix
stages of `radix_plan` with the twiddles of `twiddle_table` (the same
table the kernel reads), the radix-2, 4 and 5 butterflies' formulas and
the generic stage's products for any other radix, then the real-split
pass (an even n). It is held against the
twin `stft_fused._reference` (the matmul-DFT, itself held against
se_tpu's Pallas STFT in tests/test_torch_stft_fused.py) within 1e-5 *
max|twin|: fp32 sums in another order.

Also: which configurations `stft_auto` sends to the kernel, decided from
shapes alone (on `meta` tensors), and that `stft_fused` raises on an n_fft
outside the plan (more than MAX_POINTS complex points a frame).
"""

import numpy as np
import pytest
import torch

from se_tpu_torch.ops import _build
from se_tpu_torch.ops import stft as tst
from se_tpu_torch.ops import stft_fused as sf

RTOL = 1e-5
F32 = np.float32
C1, C2 = F32(0.30901699437494745), F32(-0.8090169943749475)
S1, S2 = F32(0.9510565162951535), F32(0.5877852522924731)


class C:
    """A float32 complex array as the kernel's float2: (re, im)."""

    def __init__(self, re, im):
        self.re, self.im = re.astype(F32), im.astype(F32)

    def __add__(self, o):
        return C(self.re + o.re, self.im + o.im)

    def __sub__(self, o):
        return C(self.re - o.re, self.im - o.im)

    def __mul__(self, o):  # cmul
        return C(self.re * o.re - self.im * o.im,
                 self.re * o.im + self.im * o.re)

    def mi(self):  # -i a
        return C(self.im, -self.re)

    def scale(self, s):
        return C(self.re * s, self.im * s)

    def __getitem__(self, idx):
        return C(self.re[..., idx], self.im[..., idx])


def dft(v):
    """csrc/stft.cu `dft<R>`, in place on a list of R points."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 4:
        t0, t1 = v[0] + v[2], v[0] - v[2]
        t2, t3 = v[1] + v[3], (v[1] - v[3]).mi()
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
    a0 = v[0]
    b1, b2, d1, d2 = v[1] + v[4], v[2] + v[3], v[1] - v[4], v[2] - v[3]
    e1 = a0 + b1.scale(C1) + b2.scale(C2)
    e2 = a0 + b1.scale(C2) + b2.scale(C1)
    f1 = (d1.scale(S1) + d2.scale(S2)).mi()
    f2 = (d1.scale(S2) - d2.scale(S1)).mi()
    return [a0 + (b1 + b2), e1 + f1, e2 + f2, e2 - f2, e1 - f1]


def stage_any(z, tw, off, ns, r, nb):
    """csrc/stft.cu `stage_any`: output q of butterfly j is sum_p z[j + p
    nb] w^m, m = p (k + q ns) mod ns r, k = j mod ns, summed in p order."""
    j = np.arange(nb)
    k = j % ns
    outs = []
    for q in range(r):
        acc = C(np.zeros_like(z.re[..., :nb]), np.zeros_like(z.im[..., :nb]))
        for p in range(r):
            acc = acc + z[j + p * nb] * tw[off + (p * (k + q * ns)) % (ns * r)]
        outs.append(acc)
    return outs


def kernel_pad(cfg: tst.StftConfig) -> int:
    """The `pad` stft_fused hands the kernel: n_fft // 2 for center."""
    return cfg.fft // 2 if cfg.convention == "center" else 0


def padded(x: np.ndarray, j: np.ndarray, pad: int) -> np.ndarray:
    """csrc/stft.cu `padded`: sample j of the padded waveform read from x
    (B, L): x[j - pad], reflected within `pad` samples of the ends, zero
    past that."""
    length = x.shape[-1]
    i = np.abs(j - pad)
    beyond = i >= length + pad
    i = np.where(i >= length, 2 * (length - 1) - i, i)
    return np.where(beyond, F32(0), x[:, np.where(beyond, 0, i)])


def kernel_stft(x: np.ndarray, cfg: tst.StftConfig):
    """What csrc/stft.cu computes, stage by stage: (B, n) -> (re, im)."""
    n, k_len, hop = cfg.fft, cfg.frame_len, cfg.hop
    split = n % 2 == 0
    half = sf.fft_points(n)
    plan = sf.radix_plan(n)
    table = sf.twiddle_table(n)
    tw = C(table[:, 0], table[:, 1])
    win = tst._const("window", cfg, torch.device("cpu")).numpy()
    t_len = tst.num_frames(x.shape[1], cfg)
    idx = np.arange(t_len)[:, None] * hop + np.arange(k_len)[None, :]
    frames = np.zeros((x.shape[0], t_len, n), F32)
    frames[..., :k_len] = padded(x, idx, kernel_pad(cfg)) * win  # windowed
    if split:
        z = C(frames[..., 0::2], frames[..., 1::2])
    else:
        z = C(frames, np.zeros_like(frames))
    ns, off = 1, 0
    for r in plan:
        nb = half // r
        j = np.arange(nb)
        k = j % ns
        if r in sf.RADICES:
            v = [z[j + q * nb] for q in range(r)]
            v = [v[0]] + [v[q] * tw[off + k * (r - 1) + q - 1]
                          for q in range(1, r)]
            v = dft(v)
        else:
            v = stage_any(z, tw, off, ns, r, nb)
        d = (j // ns) * ns * r + k
        re, im = np.empty_like(z.re), np.empty_like(z.im)
        for q in range(r):
            re[..., d + q * ns], im[..., d + q * ns] = v[q].re, v[q].im
        z = C(re, im)
        off += ns * (r - 1) if r in sf.RADICES else ns * r
        ns *= r
    if not split:
        return z[np.arange(cfg.bins)].re, z[np.arange(cfg.bins)].im
    kk = np.arange(half + 1)
    zk, zc = z[kk % half], z[(half - kk) % half]
    e = C(F32(0.5) * (zk.re + zc.re), F32(0.5) * (zk.im - zc.im))
    o = C(F32(0.5) * (zk.im + zc.im), F32(-0.5) * (zk.re - zc.re))
    out = e + tw[off + kk] * o
    return out.re, out.im


CASES = {
    "512_128": tst.PRESET_512_128,
    "512_256": tst.PRESET_512_256,
    "320": tst.PRESET_320,
    "320_pad_end": tst.StftConfig(320, 160, 320, convention="pad_end"),
    "320_valid": tst.StftConfig(320, 80, 320, convention="valid"),
    "pad_end_hamming": tst.StftConfig(512, 256, 512, window="hamming",
                                      convention="pad_end"),
    "valid_400_in_512": tst.StftConfig(400, 100, 512, convention="valid"),
    "valid_hop134": tst.StftConfig(402, 134, 512, convention="valid"),
    "400_radix_5x5": tst.StftConfig(400, 100, 400),
    "1024_256": tst.StftConfig(1024, 256, 1024),
    "384_radix_3": tst.StftConfig(384, 128, 384),
    "258_radix_3x43": tst.StftConfig(258, 129, 258),
    "odd_321_radix_3x107": tst.StftConfig(321, 107, 321),
    "2048_512": tst.StftConfig(2048, 512, 2048),
}


@pytest.mark.parametrize("n", [4000, 4321])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fft_stages_match_twin(case, n):
    cfg = CASES[case]
    x = np.random.default_rng(n).standard_normal((2, n)).astype(F32)
    got = kernel_stft(x, cfg)
    want = [w.numpy() for w in sf._reference(torch.from_numpy(x), cfg)]
    scale = max(1.0, max(float(np.abs(w).max()) for w in want))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("n", [4000, 4321, 1100])
@pytest.mark.parametrize("case", sorted(CASES))
def test_padding_map_is_pad_signal(case, n):
    """The kernel reads the padded waveform through `padded` instead of a
    padded copy: every sample a frame reads is pad_signal's (1100: just
    over 2048's reflect padding of 1024)."""
    cfg = CASES[case]
    x = np.random.default_rng(n).standard_normal((2, n)).astype(F32)
    xp = tst.pad_signal(torch.from_numpy(x), cfg).numpy()
    j = np.arange(xp.shape[1])
    np.testing.assert_array_equal(padded(x, j, kernel_pad(cfg)), xp)


@pytest.mark.parametrize("n,plan", [(512, (4, 4, 4, 4)), (320, (4, 4, 2, 5)),
                                    (400, (4, 2, 5, 5)), (4, (2,)),
                                    (1024, (4, 4, 4, 4, 2)),
                                    (384, (4, 4, 4, 3)), (258, (3, 43)),
                                    (511, (7, 73)), (2, ()),
                                    (2048, (4, 4, 4, 4, 4)),
                                    (768, (4, 4, 4, 2, 3)),
                                    (16384, (4,) * 6 + (2,))])
def test_radix_plan(n, plan):
    assert sf.radix_plan(n) == plan
    assert int(np.prod(plan)) == sf.fft_points(n)
    # an unrolled stage's (Ns, R - 1) block, a generic one's Ns R roots,
    # then W^k for k = 0 .. n/2 (even n)
    ns, rows = 1, 0
    for r in plan:
        rows += ns * (r - 1) if r in sf.RADICES else ns * r
        ns *= r
    tail = n // 2 + 1 if n % 2 == 0 else 0
    assert sf.twiddle_table(n).shape == (rows + tail, 2)


@pytest.mark.parametrize("n", [0, 16386, 16385, 8193, 20000])
def test_radix_plan_refuses(n):
    assert sf.radix_plan(n) is None


ROUTES = {  # config -> whether stft_auto takes the kernel for (B, n)
    "PRESET_512_128": (tst.PRESET_512_128, True),
    "PRESET_512_256": (tst.PRESET_512_256, True),
    "PRESET_320": (tst.PRESET_320, True),
    "PRESET_DEEPXI": (tst.PRESET_DEEPXI, True),
    "valid_hop134": (CASES["valid_hop134"], True),
    "PRESET_UFORMER 512 % 160": (tst.PRESET_UFORMER, False),
    "n_fft 384 = 2 x 192 = 2 x 4^3 x 3": (tst.StftConfig(384, 128, 384),
                                          True),
    "n_fft 258": (tst.StftConfig(258, 129, 258), True),
    "n_fft 16386, past the plan": (tst.StftConfig(16386, 8193, 16386),
                                   True),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_takes_kernel_decides_by_shape(name):
    cfg, want = ROUTES[name]
    x = torch.empty(4, 16000, device="meta")
    assert sf.takes_kernel(x, cfg) is want
    assert sf.takes_kernel(x[None], cfg) is False  # 3-D: the plain stft


def test_stft_fused_refuses_reflect_padding_wider_than_the_input():
    with pytest.raises(ValueError, match="reflect padding"):
        sf.stft_fused(torch.zeros(1, 256, device="meta"), tst.PRESET_512_128)


def test_stft_fused_refuses_n_outside_the_plan():
    cfg = tst.StftConfig(16386, 8193, 16386)
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="radix plan"):
            sf.stft_fused(torch.zeros(1, 20000, device=dev), cfg)


def test_stft_auto_routes_past_the_plan_to_the_kernel_and_raises():
    """frame_len % hop alone decides: an n_fft the plan does not cover
    reaches `stft_fused`, which raises, and takes no plain path."""
    cfg = tst.StftConfig(16386, 8193, 16386)
    with pytest.raises(ValueError, match="radix plan"):
        sf.stft_auto(torch.zeros(1, 20000), cfg)


@pytest.mark.parametrize("n_fft", [384, 258, 321])
def test_stft_auto_with_a_generic_radix_on_cpu_is_the_plain_stft(rng, n_fft):
    cfg = tst.StftConfig(n_fft, n_fft // 3, n_fft)
    x = torch.from_numpy(rng.standard_normal((2, 3000)).astype(F32))
    before = _build.LAUNCHES["stft"]
    got = sf.stft_auto(x, cfg)
    assert _build.LAUNCHES["stft"] == before
    for g, w in zip(got, tst.stft(x, cfg)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
