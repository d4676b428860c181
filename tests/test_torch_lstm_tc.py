"""What surrounds the tensor-core LSTM kernels (csrc/lstm.cu: the large
fold's `lstm_step_tc`, the small fold's `lstm_proj_tc` and
`lstm_recur_persistent`), on the CPU: the kernels themselves run only on
the card (tests/test_torch_cuda.py), so their layouts, their arithmetic
and the persistent kernel's grid are held here in plain torch.

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
- The same for the small fold: the projection with `pack_input`'s weights
  and the recurrence with `pack_recurrent`'s, in fp32 or 3xTF32, and the
  recurrence-only product at K = H = 1024 within 1e-6 of max|C|.
- `step_variant` takes each layer call of the seven paths to the design
  the kernel's header names, on a 132-SM H100 (short sequences, DPCRN's
  intra LSTM over 4 bins, to the tensor-core step), and `persistent_plan`
  gives each small-fold call a grid that owns every (row, unit) once, fits
  in shared memory and is resident in one wave.
- The bf16 variants: bf16 packs (the same permutation), and h rounded to
  bf16 where the product takes it, held to the twin stepped along its own
  y within the same 1e-5. The small fold's projection (`lstm_proj_bf16`)
  takes an fp32 x in three bf16 pieces against the bf16 weights and a
  bf16-valued operand (the bf16 x; the rounded h, `lstm_recur_bf16`) in
  one exact product; 2 TF32 passes of an fp32 operand against a bf16 one
  (the widened bf16 kernels: the single DSConv block) are exact too. The
  bf16 step (`lstm_step_bf16`) takes
  `pack_weights_bf16` (the x rows padded to Kx, then the h rows to Kh:
  each K stage wholly x or wholly h), an fp32 x as three bf16 pieces
  (`split_bf16x3`: their sum is x bit for bit down to 1e-33), a bf16 x
  padded to a multiple of 8 elements (`aligned_x`), and h from its bf16
  shadow, one bf16 product each, summed in fp32 stage by stage.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from se_tpu.nn.recurrent import lstm_layer as j_lstm_layer
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


BF16 = torch.bfloat16


def round_bf16(v: torch.Tensor) -> torch.Tensor:
    """tc_common.cuh `round_bf16`: to nearest even, kept as fp32."""
    return v.to(BF16).float()


def matmul_passes(a: torch.Tensor, w: torch.Tensor, passes: int):
    """a @ w as the bf16 variants sum it against a bf16-valued w (exact in
    TF32, never split): 2 passes, small.w + big.w (a split as
    `split_tf32`); 1 pass, a.w, for a bf16-valued a (exact in TF32)."""
    if passes == 1:
        assert torch.equal(a, round_bf16(a))
        return a @ w
    big, small = split(a)
    return small @ w + big @ w


def split_bf16x3(v: torch.Tensor):
    """tc_common.cuh `split_bf16x3`: v = hi + mid + lo, each the bf16
    nearest (to nearest even) what the pieces before leave, the
    differences in fp32."""
    hi = round_bf16(v)
    rest = v - hi
    mid = round_bf16(rest)
    return hi, mid, round_bf16(rest - mid)


def bf16_step_gates(x_t, hs, wp, kx: int):
    """One frame's packed gate sums as lstm_step_bf16 forms them: x_t
    (Bf, In) zero-padded to Kx, an fp32 x as its three bf16 pieces (lo,
    mid, hi, one product each), a bf16 x as it is; then the shadow hs (Bf,
    Kh), h rounded to bf16; each product of bf16 values exact in fp32,
    summed in fp32 stage by stage (K_TILE a stage). wp: pack_weights_bf16's
    (4Hp, Kx + Kh)."""
    a = torch.nn.functional.pad(x_t.float(), (0, kx - x_t.shape[1]))
    pieces = split_bf16x3(a)[::-1] if x_t.dtype == torch.float32 else (a,)
    w = wp.float()
    acc = torch.zeros(x_t.shape[0], w.shape[0])
    for k0 in range(0, kx, lstm.K_TILE):
        for piece in pieces:
            acc = acc + piece[:, k0:k0 + lstm.K_TILE] @ \
                w[:, k0:k0 + lstm.K_TILE].t()
    for k0 in range(0, hs.shape[1], lstm.K_TILE):
        acc = acc + hs[:, k0:k0 + lstm.K_TILE] @ \
            w[:, kx + k0:kx + k0 + lstm.K_TILE].t()
    return acc


def _frames(t_len: int, reverse: bool, h_in):
    """(t, the h a frame's product takes from `h_in`: its y at the frame
    walked before, or None for the layer's own h) in walk order."""
    prev = None
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        yield t, None if h_in is None or prev is None else h_in[:, prev]
        prev = t


def _product(a, w, passes: str, a_bf16: bool):
    """a @ w as the kernel sums it: "fp32", "3xtf32", or "bf16" (the small
    fold's bf16 kernels against bf16 weights: a bf16-valued a in one exact
    product, an fp32 a in three bf16 pieces, lo first)."""
    if passes == "bf16":
        if a_bf16:
            return matmul_passes(a, w, 1)
        return sum(p @ w for p in split_bf16x3(a)[::-1])
    return matmul_3xtf32(a, w) if passes == "3xtf32" else a @ w


def packed_layer(x, wx, wh, b, passes: str, reverse: bool = False,
                 h_in=None, h0=None, c0=None):
    """One layer as the step kernels compute it, per frame, gates read
    back from the packed column order, the cell in fp32. "fp32" /
    "3xtf32" (lstm_step_tc): [x_t | h_{t-1}] zero-padded to Kp times
    pack_weights' (4Hp, Kp). "bf16" (lstm_step_bf16): `bf16_step_gates`
    with pack_weights_bf16's weights and h_{t-1} rounded to bf16 in the
    shadow. `h_in`: each frame's product takes h_in's h (as the twin's
    `h_in`)."""
    bf, t_len, in_dim = x.shape
    h_dim = wh.shape[0]
    if passes == "bf16":
        wp = lstm.pack_weights_bf16(wx, wh)
        kx = -(-in_dim // lstm.K_TILE) * lstm.K_TILE
        kh = wp.shape[1] - kx
    else:
        wp = lstm.pack_weights(wx, wh).float()
    hp, kp = wp.shape[0] // 4, wp.shape[1]
    h = torch.zeros(bf, h_dim) if h0 is None else h0
    c = torch.zeros(bf, h_dim) if c0 is None else c0
    ys = torch.empty(bf, t_len, h_dim)
    for t, forced in _frames(t_len, reverse, h_in):
        h = h if forced is None else forced
        if passes == "bf16":
            hs = torch.nn.functional.pad(round_bf16(h), (0, kh - h_dim))
            gp = bf16_step_gates(x[:, t], hs, wp, kx)
        else:
            a = torch.nn.functional.pad(torch.cat([x[:, t], h], 1),
                                        (0, kp - in_dim - h_dim))
            gp = _product(a, wp.t(), passes, False)
        gp = gp.view(bf, hp // lstm.GROUP, 4, lstm.GROUP)
        i, f, g, o = (gp[:, :, q].reshape(bf, hp)[:, :h_dim]
                      + b[q * h_dim:(q + 1) * h_dim].float()
                      for q in range(4))
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[:, t] = h
    return ys


def persistent_layer(x, wx, wh, b, passes: str, reverse: bool = False,
                     h0=None, c0=None, h_in=None):
    """One layer as the small fold computes it: XP = x . Wx + b with
    `pack_input`'s weights (lstm_proj_tc), then per frame h_{t-1}
    zero-padded to Hk times `pack_recurrent`'s (4Hk, Hk) weights
    (lstm_recur_persistent), gates read back from the packed order.
    "bf16" (lstm_proj_bf16, lstm_recur_bf16): the projection of an fp32 x
    in three bf16 pieces, of a bf16 x in one product, h rounded to bf16
    against the bf16 Wh in one; `h_in` as `packed_layer`'s."""
    bf, t_len, in_dim = x.shape
    h_dim = wh.shape[0]
    wi, wr = lstm.pack_input(wx).float(), lstm.pack_recurrent(wh).float()
    xk = torch.nn.functional.pad(x.float(), (0, wi.shape[1] - in_dim))
    xp = _product(xk.reshape(bf * t_len, -1), wi.t(), passes,
                  x.dtype == BF16)
    xp = (xp[:, :4 * h_dim] + b.float()).view(bf, t_len, 4 * h_dim)
    hk = wr.shape[1]
    h = torch.zeros(bf, h_dim) if h0 is None else h0
    c = torch.zeros(bf, h_dim) if c0 is None else c0
    ys = torch.empty(bf, t_len, h_dim)
    for t, forced in _frames(t_len, reverse, h_in):
        h = h if forced is None else forced
        hr = round_bf16(h) if passes == "bf16" else h
        gp = _product(torch.nn.functional.pad(hr, (0, hk - h_dim)), wr.t(),
                      passes, True)
        gp = gp.view(bf, hk // lstm.GROUP, 4, lstm.GROUP)
        i, f, g, o = (gp[:, :, q].reshape(bf, hk)[:, :h_dim]
                      + xp[:, t, q * h_dim:(q + 1) * h_dim] for q in range(4))
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[:, t] = h
    return ys, h, c


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


@pytest.mark.parametrize("in_dim,h", [(6, 20), (33, 44), (32, 16)])
def test_pack_input_and_recurrent_are_exact_permutations(rng, in_dim, h):
    _, wx, wh, _ = to_torch(lstm_inputs(rng, 1, 1, in_dim, h))
    wi, wr = lstm.pack_input(wx), lstm.pack_recurrent(wh)
    hk = -(-h // lstm.GROUP) * lstm.GROUP
    assert wi.shape == (-(-4 * h // lstm.COL_TILE) * lstm.COL_TILE,
                        -(-in_dim // lstm.K_TILE) * lstm.K_TILE)
    assert torch.equal(wi[:4 * h, :in_dim], wx.t())
    assert not wi[4 * h:].any() and not wi[:, in_dim:].any()
    want = torch.zeros(4 * hk, hk)
    for g in range(4):
        for u in range(h):
            want[(u // 8) * 32 + g * 8 + u % 8, :h] = wh[:, g * h + u]
    assert wr.is_contiguous() and torch.equal(wr, want)


@pytest.mark.parametrize("passes", ["fp32", "3xtf32"])
@pytest.mark.parametrize("reverse,carry", [(False, False), (True, False),
                                           (False, True)])
@pytest.mark.parametrize("bf,t,in_dim,h", [(5, 9, 6, 20), (19, 6, 33, 44)])
def test_persistent_layer_matches_reference_and_jax_scan(
        rng, passes, reverse, carry, bf, t, in_dim, h):
    """H = 20 (not a multiple of 4: the kernel's 4-byte staging) and 44
    (Hk = 48: a zero-filled 16-byte chunk); Bf = 19, two row chunks."""
    x, wx, wh, b = lstm_inputs(rng, bf, t, in_dim, h)
    h0 = c0 = None
    if carry:
        h0, c0 = to_torch((rng.uniform(-0.5, 0.5, (bf, h)).astype(np.float32),
                           rng.uniform(-0.5, 0.5, (bf, h)).astype(np.float32)))
    tx, twx, twh, tb = to_torch((x, wx, wh, b))
    got = persistent_layer(tx, twx, twh, tb, passes, reverse, h0, c0)
    ys, (hn, cn) = lstm._reference(tx, twx, twh, tb, reverse, h0, c0)
    close(got, [ys, hn, cn], ATOL)
    if not (reverse or carry):
        close([got[0]], [_scan_forward(x, wx, wh, b)], ATOL)


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


def test_three_tf32_passes_keep_fp32_accuracy_on_the_recurrent_product(rng):
    """lstm_recur_persistent's product at LSTMNet's K = H = 1024: A rows
    h_{t-1} in (-1, 1) (a 16-row chunk), B the packed Wh, U(+-1/32) as
    torch's init (a quarter of its 4096 columns)."""
    m, k, n = 16, 1024, 1024
    a = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    w = (rng.uniform(-1, 1, (k, n)) / 32).astype(np.float32)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    exact = ta.double() @ tw.double()
    scale = float(exact.abs().max())

    def rel(c):
        return float((c.double() - exact).abs().max()) / scale

    three = rel(matmul_3xtf32(ta, tw))
    assert three <= 1e-6
    assert three <= 2 * rel(ta @ tw)
    assert rel(tf32(ta) @ tf32(tw)) > 1e-5


# (path, layer In, H, Bf of batch B, T, {B: design}) on 132 SMs
VARIANTS = [
    ("fullsubnet full band", 257, 512, lambda b: b, 253,
     {4: "persistent", 32: "persistent", 256: "persistent"}),
    ("fullsubnet full band", 512, 512, lambda b: b, 253,
     {4: "persistent", 32: "persistent", 256: "persistent"}),
    ("fullsubnet sub band", 32, 384, lambda b: 257 * b, 253,
     {1: "persistent", 2: "tensor_core", 4: "tensor_core", 32: "tensor_core",
      256: "tensor_core"}),
    ("fullsubnet sub band", 384, 384, lambda b: 257 * b, 253,
     {4: "tensor_core", 32: "tensor_core", 256: "tensor_core"}),
    ("dccrn clstm", 512, 128, lambda b: 2 * b, 501,
     {4: "persistent", 32: "persistent", 256: "persistent"}),
    ("dccrn clstm", 128, 128, lambda b: 2 * b, 501,
     {4: "persistent", 32: "persistent", 256: "persistent"}),
    ("lstm", 161, 1024, lambda b: b, 401,
     {4: "persistent", 32: "persistent", 128: "persistent", 129: "tensor_core",
      256: "tensor_core"}),
    ("lstm / crn", 1024, 1024, lambda b: b, 401,
     {4: "persistent", 32: "persistent", 256: "tensor_core"}),
    ("gcrn glstm", 512, 512, lambda b: b, 401,
     {4: "persistent", 32: "persistent", 256: "persistent"}),
    # 4 frequency bins: too short for the small fold at any batch
    ("dpcrn intra", 128, 64, lambda b: 401 * b, 4,
     {4: "tensor_core", 5: "tensor_core", 6: "tensor_core",
      32: "tensor_core", 256: "tensor_core"}),
    ("dpcrn inter", 128, 128, lambda b: 4 * b, 401,
     {4: "persistent", 32: "persistent", 256: "persistent"}),
]


@pytest.mark.parametrize("path,in_dim,h,fold,t,want", VARIANTS,
                         ids=[f"{v[0]} {v[1]}-{v[2]}" for v in VARIANTS])
def test_step_variant_of_each_layer_call(path, in_dim, h, fold, t, want):
    got = {b: lstm.step_variant(fold(b), t, h, 132) for b in want}
    assert got == want


def test_step_variant_takes_tensor_cores_where_split_rows_do_not_fit():
    """The small fold's edge: at H = 1024 the 128 unit tiles' Wh slices
    (210 KB a block, one an SM) fit 132 SMs; at H = 1064 the 133 tiles do
    not, and at H = 1100 neither, so those take the tensor-core step however
    small the fold; on fewer SMs H = 1024 does not fit either."""
    assert lstm.step_variant(4, 401, 1024, 132) == "persistent"
    assert lstm.step_variant(4, 401, 1056, 132) == "persistent"
    assert lstm.step_variant(4, 401, 1064, 132) == "tensor_core"
    assert lstm.step_variant(4, 401, 1100, 132) == "tensor_core"
    assert lstm.step_variant(4, 401, 1024, 114) == "tensor_core"
    assert lstm.persistent_plan(4, 1064, 132) is None


@pytest.mark.parametrize("batch", [4, 5])
def test_step_variant_sends_short_sequences_to_tensor_cores(batch):
    """DPCRN's intra LSTM at B = 4 and 5 (Bf = 401 B rows over T = 4 bins)
    is a small fold, but its four frames do not repay the projection, the
    packing and the cooperative launch: it takes the tensor-core step. At
    SHORT_T frames the same fold takes the small fold, and one frame fewer
    the tensor-core step, at every small-fold shape."""
    bf = 401 * batch
    assert lstm.step_variant(bf, 4, 64, 132) == "tensor_core"
    assert lstm.step_variant(bf, lstm.SHORT_T, 64, 132) == "persistent"
    for bf, h in ((4, 1024), (8, 128), (16, 128), (4, 512),
                  (401 * batch, 64)):
        assert lstm.step_variant(bf, lstm.SHORT_T, h, 132) == "persistent"
        assert lstm.step_variant(bf, lstm.SHORT_T - 1, h, 132) \
            == "tensor_core"


# every small fold of the seven paths: the calls that take the persistent
# design over SHORT_T frames or more (DPCRN's intra LSTM at B = 4 included:
# its T = 4 sends it to the tensor-core step, but its grid is still planned
# and held here)
SMALL_FOLD = [(path, h, fold(b), b) for path, _, h, fold, _, want in VARIANTS
              for b in want if b in (4, 32, 256)
              and lstm.step_variant(fold(b), lstm.SHORT_T, h, 132)
              == "persistent"]


@pytest.mark.parametrize("path,h,bf,batch", SMALL_FOLD,
                         ids=[f"{v[0]} H{v[1]} B{v[3]}" for v in SMALL_FOLD])
def test_persistent_plan_of_each_small_fold_call(path, h, bf, batch):
    """Every (row, unit) owned by one block, the block's shared memory
    within the opt-in limit, the grid resident in one wave of 132 SMs."""
    plan = lstm.persistent_plan(bf, h, 132)
    assert plan is not None
    assert plan.smem == lstm.persistent_smem(h, plan.chunks) <= 232448
    assert plan.blocks_sm * (plan.smem + lstm.SMEM_RESERVED) <= lstm.SMEM_SM
    assert plan.blocks <= plan.blocks_sm * 132
    # block b: unit tile b % units, row chunks b // units + row_groups j
    # (csrc/lstm.cu lstm_recur_persistent)
    owner = np.zeros((bf, h), np.int64)
    for block in range(plan.blocks):
        tile, group = block % plan.units, block // plan.units
        chunks = range(group, -(-bf // 16), plan.row_groups)
        assert 1 <= len(chunks) <= plan.chunks
        for q in chunks:
            owner[16 * q:16 * q + 16, 8 * tile:8 * tile + 8] += 1
    assert (owner == 1).all()


# ------------------------------------------------ the bf16 variants

def _bf16_layer_inputs(rng, bf, t, in_dim, h, x_dtype):
    x, wx, wh, b = to_torch(lstm_inputs(rng, bf, t, in_dim, h))
    return (x.to(x_dtype), wx.to(BF16), wh.to(BF16), b.to(BF16))


@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bf,t,in_dim,h", [(5, 9, 6, 20), (3, 6, 33, 40)])
def test_bf16_packed_step_matches_twin(rng, x_dtype, reverse, bf, t, in_dim,
                                       h):
    """The bf16 step's arithmetic (an fp32 x in three bf16 pieces, a bf16
    x and the shadow of h in one product each): stepped along the twin's
    own y (no h flips between the two), within the fp32 designs' 1e-5."""
    x, wx, wh, b = _bf16_layer_inputs(rng, bf, t, in_dim, h, x_dtype)
    want, _ = lstm._reference(x, wx, wh, b, reverse)
    got = packed_layer(x, wx, wh, b, "bf16", reverse, h_in=want)
    close([got], [want], ATOL)


@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("bf,t,in_dim,h", [(5, 9, 6, 20), (19, 6, 33, 44)])
def test_bf16_persistent_layer_matches_twin(rng, x_dtype, bf, t, in_dim, h):
    x, wx, wh, b = _bf16_layer_inputs(rng, bf, t, in_dim, h, x_dtype)
    want, _ = lstm._reference(x, wx, wh, b)
    got, _, _ = persistent_layer(x, wx, wh, b, "bf16", h_in=want)
    close([got], [want], ATOL)


def test_bf16_packs_keep_the_weights_dtype(rng):
    """pack_weights, pack_input and pack_recurrent of bf16 weights are
    bf16 (half the fp32 packs' bytes) and the same permutation."""
    _, wx, wh, _ = to_torch(lstm_inputs(rng, 1, 1, 33, 44))
    for pack, args in ((lstm.pack_weights, (wx, wh)),
                       (lstm.pack_input, (wx,)),
                       (lstm.pack_recurrent, (wh,))):
        packed = pack(*(a.to(BF16) for a in args))
        assert packed.dtype == BF16
        assert torch.equal(packed.float(),
                           pack(*(round_bf16(a) for a in args)))


def _passes_tf32(a, w):
    """The widened bf16 kernels' (the single DSConv block's): 2 TF32
    passes of an fp32 a against a bf16-valued w."""
    return matmul_passes(a, w, 2)


def _pieces_bf16(a, w):
    """The bf16 step's (lstm_step_bf16): a's three bf16 pieces."""
    return sum(p @ w for p in split_bf16x3(a)[::-1])


@pytest.mark.parametrize("product,one_pass", [
    (_passes_tf32, tf32), (_pieces_bf16, round_bf16)],
    ids=["projection 2 tf32 passes", "step 3 bf16 pieces"])
def test_bf16_weights_take_two_passes_of_fp32_x_and_one_of_bf16_x(
        rng, product, one_pass):
    """The sub band's second layer, K = 768, against bf16 weights: an fp32
    A in the kernel's exact form (the projection's 2 TF32 passes, the
    step's 3 bf16 pieces) keeps fp32 accuracy against fp64 (one pass of A
    rounded to TF32 or bf16 would not); a bf16-valued A (a bf16 x, the
    rounded h) is exact in one pass."""
    m, k, n = 256, 768, 512
    a = np.concatenate([rng.standard_normal((m, 384)),
                        rng.uniform(-1, 1, (m, 384))], 1).astype(np.float32)
    w = (rng.uniform(-1, 1, (k, n)) * 384 ** -0.5).astype(np.float32)
    ta, tw = torch.from_numpy(a), round_bf16(torch.from_numpy(w))
    assert torch.equal(tf32(tw), tw)  # a bf16 value is exact in TF32

    def rel(c, aa):
        exact = aa.double() @ tw.double()
        return float((c.double() - exact).abs().max()) / float(
            exact.abs().max())

    assert rel(product(ta, tw), ta) <= 1e-6
    assert rel(one_pass(ta) @ tw, ta) > 1e-5
    ab = round_bf16(ta)
    assert rel(matmul_passes(ab, tw, 1), ab) <= 1e-6


def _exp_range(rng, n):
    """n fp32 values of random sign spanning the exponent range: random
    bit patterns, the NaN / inf exponent left out."""
    bits = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    v = torch.from_numpy(bits.view(np.int32)).view(torch.float32)
    return v[torch.isfinite(v)]


def _reassembled(v):
    hi, mid, lo = split_bf16x3(v)
    assert all(torch.equal(p, round_bf16(p)) for p in (hi, mid, lo))
    return hi.double() + mid.double() + lo.double()


def test_three_bf16_pieces_reassemble_fp32_x(rng):
    """split_bf16x3: hi + mid + lo is x bit for bit for |x| >= 1e-33
    across the exponent range, at bf16 ties (x halfway between two bf16
    values, each way), at +-0 and up to 3e38; below 1e-33 the last rest
    falls among the subnormals and the sum is off by less than 1e-40. So
    each piece's product with a bf16 weight is exact in fp32, as the one
    fp32 product of se_tpu's x . Wx."""
    v = _exp_range(rng, 1 << 22)
    v = v[v.abs() <= 3e38]
    one = torch.tensor([1.0 + 2.0 ** -8])  # halfway: 1 and 1 + 2^-7
    ties = torch.cat([one * 2.0 ** e for e in range(-100, 120, 7)])
    ties = torch.cat([ties, -ties, ties * (1 + 2.0 ** -20),
                      torch.tensor([0.0, -0.0, 3e38, -3e38, 1e-33])])
    for x in (v, ties):
        big = x.abs() >= 1e-33
        got = _reassembled(x)
        assert torch.equal(got[big], x[big].double())
        err = (got[~big] - x[~big].double()).abs()
        assert err.numel() == 0 or float(err.max()) < 1e-40
    zeros = split_bf16x3(torch.tensor([0.0, -0.0]))
    assert all(not p.any() for p in zeros)
    assert torch.signbit(zeros[0][1])
    tiny = torch.tensor([1e-34, 3e-38, 1e-40, 1e-45, -7e-39])
    assert float((_reassembled(tiny) - tiny.double()).abs().max()) < 1e-40


@pytest.mark.parametrize("in_dim,h", [(6, 20), (33, 44), (161, 20),
                                      (161, 44), (32, 384)])
def test_pack_weights_bf16_puts_x_and_h_at_their_padded_offsets(rng, in_dim,
                                                                 h):
    """pack_weights_bf16 is an exact permutation of [Wx; Wh], zero-padded:
    packed column (u // 8) 32 + 8 g + u % 8 is gate g of unit u, Wx's rows
    at K 0 .. In and Wh's at Kx .. Kx + H (Kx, Kh = In, H rounded up to
    the 32-deep K stage), bf16 in, bf16 out."""
    _, wx, wh, _ = to_torch(lstm_inputs(rng, 1, 1, in_dim, h))
    wx, wh = wx.to(BF16), wh.to(BF16)
    wp = lstm.pack_weights_bf16(wx, wh)
    hp = -(-h // lstm.UNIT_TILE) * lstm.UNIT_TILE
    kx = -(-in_dim // lstm.K_TILE) * lstm.K_TILE
    kh = -(-h // lstm.K_TILE) * lstm.K_TILE
    assert wp.shape == (4 * hp, kx + kh) and wp.is_contiguous()
    assert wp.dtype == BF16
    want = torch.zeros(4 * hp, kx + kh, dtype=BF16)
    for g in range(4):
        for u in range(h):
            col = (u // 8) * 32 + g * 8 + u % 8
            want[col, :in_dim] = wx[:, g * h + u]
            want[col, kx:kx + h] = wh[:, g * h + u]
    assert torch.equal(wp, want)
    # the fp32 pack's permutation of the same columns, the K blocks apart
    wf = lstm.pack_weights(wx.float(), wh.float())
    assert torch.equal(wp[:, :in_dim].float(), wf[:, :in_dim])
    assert torch.equal(wp[:, kx:kx + h].float(),
                       wf[:, in_dim:in_dim + h])


@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("bf,t,in_dim,h", [(5, 9, 6, 20), (3, 6, 161, 44),
                                           (19, 5, 40, 16)])
def test_bf16_step_order_matches_twin_and_se_tpu(rng, x_dtype, bf, t, in_dim,
                                                  h):
    """lstm_step_bf16's arithmetic, frame by frame in its order (x stages
    then h stages, fp32 sums stage by stage), with a carry: stepped along
    the twin's own y within 1e-5, and along se_tpu's bf16 scan
    (`lstm_layer` with bf16 weights: x . Wx in fp32, h.astype(bf16) . Wh)
    within 1e-5 max(1, max|ref|); at an fp32 x also along the Pallas
    layer's scan oracle `_scan_forward` (bf16 weights, no carry), the
    same."""
    x, wx, wh, b = _bf16_layer_inputs(rng, bf, t, in_dim, h, x_dtype)
    h0, c0 = to_torch((rng.uniform(-0.5, 0.5, (bf, h)).astype(np.float32),
                       rng.uniform(-0.5, 0.5, (bf, h)).astype(np.float32)))
    want, (hn, cn) = lstm._reference(x, wx, wh, b, False, h0, c0)
    got = packed_layer(x, wx, wh, b, "bf16", h_in=want, h0=h0, c0=c0)
    close([got], [want], ATOL)
    jx = jnp.asarray(x.float().numpy(),
                     jnp.bfloat16 if x_dtype == BF16 else jnp.float32)
    jw = [jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (wx, wh, b)]
    ref = np.array(j_lstm_layer(jx, *jw, carry=(jnp.asarray(h0.numpy()),
                                                jnp.asarray(c0.numpy()))),
                   np.float32)
    got = packed_layer(x, wx, wh, b, "bf16", h_in=torch.from_numpy(ref),
                       h0=h0, c0=c0)
    close([got], [ref], ATOL * max(1.0, float(np.abs(ref).max())))
    if x_dtype == torch.float32:  # the Pallas layer's scan oracle
        scan = np.array(_scan_forward(jx, *jw), np.float32)
        got = packed_layer(x, wx, wh, b, "bf16", h_in=torch.from_numpy(scan))
        close([got], [scan], ATOL * max(1.0, float(np.abs(scan).max())))


@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])
def test_padding_x_to_a_multiple_of_8_leaves_the_step_unchanged(rng,
                                                                x_dtype):
    """LSTMNet's In = 161: `aligned_x` pads x once to 168 with zeros (the
    16-byte copies of either dtype), and the step over the padded x with
    the same pack (its rows past In zero) gives the same result bit for
    bit. A row length already a multiple of 8 at an aligned address is
    taken as it is; one at an address off 16 bytes is copied."""
    x, wx, wh, b = _bf16_layer_inputs(rng, 4, 3, 161, 20, x_dtype)
    xa = lstm.aligned_x(x)
    assert xa.shape == (4, 3, 168) and xa.dtype == x_dtype
    assert xa.data_ptr() % 16 == 0 and xa.is_contiguous()
    assert torch.equal(xa[..., :161], x) and not xa[..., 161:].any()
    a = packed_layer(x, wx, wh, b, "bf16")
    wp = lstm.pack_weights_bf16(wx, wh)
    assert not wp[:, 161:192].any()
    got = packed_layer(xa, torch.nn.functional.pad(wx, (0, 0, 0, 7)), wh,
                       b, "bf16")
    assert torch.equal(got, a)
    x8 = torch.zeros(4, 3, 16, dtype=x_dtype)
    assert lstm.aligned_x(x8) is x8
    store = torch.zeros(4 * 3 * 16 + 1, dtype=x_dtype)
    off = store[1:].view(4, 3, 16)
    assert off.data_ptr() % 16 != 0
    moved = lstm.aligned_x(off)
    assert moved is not off and moved.data_ptr() % 16 == 0
    assert torch.equal(moved, off)


def test_shadow_holds_h0_rounded_and_zeros():
    """The shadow of h: (2, Bf, Kh) bf16, h0 rounded to nearest even in the
    first half's first H columns (se_tpu's h.astype(bf16)), zeros
    elsewhere (the K padding the h stages read); zeros without h0."""
    h0 = torch.tensor([[1.0 + 2.0 ** -8, -(1.0 + 3 * 2.0 ** -8), 0.3]])
    hs = lstm.shadow(h0, 1, 3, "cpu")
    assert hs.shape == (2, 1, 32) and hs.dtype == BF16
    assert hs[0, 0, :3].float().tolist() == [1.0, -(1.0 + 2.0 ** -6),
                                             float(h0[0, 2].to(BF16))]
    assert not hs[0, :, 3:].any() and not hs[1].any()
    assert not lstm.shadow(None, 2, 40, "cpu").any()
    assert lstm.shadow(None, 2, 40, "cpu").shape == (2, 2, 64)


# (layer call that takes the bf16 step, In, H, design): x part at least as
# long as the h part -> one m16 tile a warp, programmatic launches
BF16_STEP_DESIGNS = [
    ("fullsubnet sub band 1", 32, 384, (2, False)),
    ("fullsubnet sub band 2", 384, 384, (1, True)),
    ("lstm lstm1 B=256", 161, 1024, (2, False)),
    ("lstm / crn lstm2 B=256", 1024, 1024, (1, True)),
    ("dpcrn intra", 128, 64, (1, True)),
    ("H 20, In 33", 33, 20, (1, True)),
    ("H 44, In 33", 33, 44, (1, True)),
    ("H 44, In 20", 20, 44, (2, False)),
]


@pytest.mark.parametrize("path,in_dim,h,want", BF16_STEP_DESIGNS,
                         ids=[d[0] for d in BF16_STEP_DESIGNS])
def test_bf16_step_design_of_each_layer_call(path, in_dim, h, want):
    """bf16_step_design compares the padded K of the two parts (Kx = In,
    Kh = H rounded up to the 32-deep stage)."""
    assert lstm.bf16_step_design(in_dim, h) == want
