"""What surrounds the tensor-core LSTM step (csrc/lstm.cu `lstm_step_tc`),
on the CPU: the kernel itself runs only on the card
(tests/test_torch_cuda.py), so its layout and its arithmetic are held here
in plain torch.

- `pack_weights` is an exact permutation of [Wx; Wh] with zero padding,
  and a plain step that multiplies with the packed weights in the packed
  column order, in fp32 or in the kernel's 3xTF32, reproduces `_reference`
  and se_tpu's `_scan_forward` within 1e-5 (fp32 sums in another order; H
  not a multiple of the unit tile).
- 3xTF32 products as the kernel forms them (by integer view: big = v
  rounded to TF32, to nearest with ties away from zero as
  `cvt.rna.tf32.f32`; small = v - big, which the mma reads truncated to
  TF32) stay within 1e-6 of max|C| against fp64 at the sub band's
  K = 768; one TF32 pass does not. That is the reason for three passes.
- `step_variant` takes each layer call of the seven paths to the step the
  kernel's header names, on a 132-SM H100.
"""

import numpy as np
import pytest
import torch

from se_tpu.ops.pallas_lstm import _scan_forward
from se_tpu_torch.ops import lstm
from torch_kernel_inputs import close, lstm_inputs, to_torch

ATOL = 1e-5


def tf32(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: add half of the 13 dropped bits' unit to the magnitude, then
    clear them."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate_tf32(v: torch.Tensor) -> torch.Tensor:
    """What the mma reads of an fp32 operand: its low 13 bits dropped."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor):
    """csrc/lstm.cu `split_tf32`: big rounded, small as the mma reads it."""
    big = tf32(v)
    return big, truncate_tf32(v - big)


def matmul_3xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w as the kernel sums it: small.big + big.small + big.big, each
    product of TF32 values exact in fp32, accumulated in fp32."""
    (ab, asm), (wb, wsm) = split(a), split(w)
    return asm @ wb + ab @ wsm + ab @ wb


def packed_layer(x, wx, wh, b, passes: str, reverse: bool = False):
    """One layer as lstm_step_tc computes it: per frame, [x_t | h_{t-1}]
    zero-padded to Kp times the packed (4Hp, Kp) weights, gates read back
    from the packed column order, the cell in fp32."""
    bf, t_len, in_dim = x.shape
    h_dim = wh.shape[0]
    wp = lstm.pack_weights(wx, wh)
    hp, kp = wp.shape[0] // 4, wp.shape[1]
    h = x.new_zeros(bf, h_dim)
    c = x.new_zeros(bf, h_dim)
    ys = x.new_empty(bf, t_len, h_dim)
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        a = torch.nn.functional.pad(torch.cat([x[:, t], h], 1),
                                    (0, kp - in_dim - h_dim))
        gp = matmul_3xtf32(a, wp.t()) if passes == "3xtf32" else a @ wp.t()
        gp = gp.view(bf, hp // lstm.GROUP, 4, lstm.GROUP)
        i, f, g, o = (gp[:, :, q].reshape(bf, hp)[:, :h_dim]
                      + b[q * h_dim:(q + 1) * h_dim] for q in range(4))
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[:, t] = h
    return ys


@pytest.mark.parametrize("in_dim,h", [(6, 20), (33, 40), (32, 16)])
def test_pack_weights_is_an_exact_permutation(rng, in_dim, h):
    _, wx, wh, _ = to_torch(lstm_inputs(rng, 1, 1, in_dim, h))
    wp = lstm.pack_weights(wx, wh)
    k = in_dim + h
    hp = -(-h // lstm.UNIT_TILE) * lstm.UNIT_TILE
    kp = -(-k // lstm.K_TILE) * lstm.K_TILE
    assert wp.shape == (4 * hp, kp) and wp.is_contiguous()
    w = torch.cat([wx, wh])
    want = torch.zeros(4 * hp, kp)
    for g in range(4):
        for u in range(h):
            want[(u // 8) * 32 + g * 8 + u % 8, :k] = w[:, g * h + u]
    assert torch.equal(wp, want)


@pytest.mark.parametrize("passes", ["fp32", "3xtf32"])
@pytest.mark.parametrize("bf,t,in_dim,h", [(5, 9, 6, 20), (3, 6, 33, 40)])
def test_packed_step_matches_reference_and_jax_scan(rng, passes, bf, t,
                                                    in_dim, h):
    """H = 20 and 40 are not multiples of the 16-unit tile; In = 33 and
    K = 26 or 73 not of the 32-wide K stage."""
    x, wx, wh, b = lstm_inputs(rng, bf, t, in_dim, h)
    tx, twx, twh, tb = to_torch((x, wx, wh, b))
    got = packed_layer(tx, twx, twh, tb, passes)
    want, _ = lstm._reference(tx, twx, twh, tb)
    close([got], [want], ATOL)
    close([got], [_scan_forward(x, wx, wh, b)], ATOL)


@pytest.mark.parametrize("passes", ["fp32", "3xtf32"])
def test_packed_step_reverse_matches_reference(rng, passes):
    x, wx, wh, b = to_torch(lstm_inputs(rng, 4, 7, 12, 24))
    got = packed_layer(x, wx, wh, b, passes, reverse=True)
    want, _ = lstm._reference(x, wx, wh, b, reverse=True)
    close([got], [want], ATOL)


def test_tf32_rounding_emulation():
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10  # TF32's mantissa step at 1
    v = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -20,
                      1 + 3 * ulp / 4, 3.0e-30])
    got = tf32(v)
    assert got.tolist()[:4] == [1 + ulp, -(1 + ulp), 1.0, 1 + ulp]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert float(tf32(one)) == 1.0
    big, small = split(torch.tensor([1 / 3]))
    assert abs(float(big) + float(small) - 1 / 3) < 2.0 ** -20 / 3
    assert float(truncate_tf32(torch.tensor([1 + 3 * ulp / 4]))) == 1.0


def test_three_tf32_passes_keep_fp32_accuracy_and_one_does_not(rng):
    """The sub band's second layer: K = In + H = 384 + 384 = 768, A rows
    [x_t | h] (x ~ N(0, 1), h in (-1, 1)), weights U(+-1/sqrt(H)) as
    torch's init."""
    m, k, n = 256, 768, 512
    a = np.concatenate([rng.standard_normal((m, 384)),
                        rng.uniform(-1, 1, (m, 384))], 1).astype(np.float32)
    w = (rng.uniform(-1, 1, (k, n)) * 384 ** -0.5).astype(np.float32)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    exact = ta.double() @ tw.double()
    scale = float(exact.abs().max())

    def rel(c):
        return float((c.double() - exact).abs().max()) / scale

    three = rel(matmul_3xtf32(ta, tw))
    one = rel(tf32(ta) @ tf32(tw))
    assert three <= 1e-6
    assert three <= 2 * rel(ta @ tw)  # no worse than fp32 cuBLAS-style sums
    assert one > 1e-5


# (path, layer, In, H, Bf of batch B, {B: step}) on 132 SMs
VARIANTS = [
    ("fullsubnet full band", 257, 512, lambda b: b,
     {4: "split", 32: "split", 256: "split"}),
    ("fullsubnet full band", 512, 512, lambda b: b,
     {4: "split", 32: "split", 256: "split"}),
    ("fullsubnet sub band", 32, 384, lambda b: 257 * b,
     {1: "split", 2: "tensor_core", 4: "tensor_core", 32: "tensor_core",
      256: "tensor_core"}),
    ("fullsubnet sub band", 384, 384, lambda b: 257 * b,
     {4: "tensor_core", 32: "tensor_core", 256: "tensor_core"}),
    ("dccrn clstm", 512, 128, lambda b: 2 * b,
     {4: "split", 32: "split", 256: "split"}),
    ("dccrn clstm", 128, 128, lambda b: 2 * b,
     {4: "split", 32: "split", 256: "split"}),
    ("lstm", 161, 1024, lambda b: b,
     {4: "split", 32: "split", 128: "split", 129: "tensor_core",
      256: "tensor_core"}),
    ("lstm / crn", 1024, 1024, lambda b: b,
     {4: "split", 32: "split", 256: "tensor_core"}),
    ("gcrn glstm", 512, 512, lambda b: b,
     {4: "split", 32: "split", 256: "split"}),
    ("dpcrn intra", 128, 64, lambda b: 401 * b,
     {4: "split", 5: "split", 6: "tensor_core", 32: "tensor_core",
      256: "tensor_core"}),
    ("dpcrn inter", 128, 128, lambda b: 4 * b,
     {4: "split", 32: "split", 256: "split"}),
]


@pytest.mark.parametrize("path,in_dim,h,fold,want", VARIANTS,
                         ids=[f"{v[0]} {v[1]}-{v[2]}" for v in VARIANTS])
def test_step_variant_of_each_layer_call(path, in_dim, h, fold, want):
    got = {b: lstm.step_variant(fold(b), in_dim, h, 132) for b in want}
    assert got == want


def test_step_variant_takes_tensor_cores_where_split_rows_do_not_fit():
    assert lstm.step_variant(4, 7000, 1024, 132) == "tensor_core"
    assert lstm.step_variant(4, 6000, 1000, 132) == "split"
