// The gated dilated DSConv blocks of the Uformer conformer, fp32 and bf16.
//
// Replaces: se_tpu/ops/pallas_dsconv.py
//   - `_pallas_dsconv` and its body `_kernel` / `_block_math` (entry
//     `dsconv_block`): one block, C entry `se_dsconv_block_tc`;
//   - `_pallas_pair` and its body `_pair_kernel` / `_pair_math` (entry
//     `dsconv_pair_block`): one conformer stage, the complex block, the
//     real block and the cross-branch fusion, C entry `se_dsconv_pair_tc`.
//
// Bound on the H100: by operations. At the main path's shapes (x (B, T,
// 4, 256) complex with Cm = 64, (B, T, 4, 128) real with Cm = 32) a row
// of x costs 4*Cin*Cm flops in the two 1x1 convs plus 2*Cm*Cm for each
// tap of the two dilated 3x3 convs that lands inside (T, F): at F = 4
// only 10 of 12 F-taps do, and at T = 401 with d = 128 only 947 of 1203
// T-taps. That is 175-186 kflop a row complex and 44-46 kflop real over
// the eight dilation pairs (82-87% of the 213 and 53 kflop with every tap
// counted), on 2*Cin*4 bytes (x read, out written): 86-91 and 43-45
// flops a byte, about the fp32-accurate tensor-core ridge of ~50 (165
// TFLOP/s over 3.35 TB/s).
//
// The TPU kernel held y = (T, F, Cm) of one batch item in VMEM. On the
// card that is 401*4*64*4 B = 410 KB, more than a block's shared memory,
// and each output row reads y at t +- d with d up to 128. So a stage is
// split at y, into two launches (y, 20 MB at B = 32, stays in the 50 MB
// L2 between them):
//
// dsconv_pre_tc: LN1 per component -> 1x1 conv -> PReLU of both branches,
// into the scratch tensors y. A GEMM a branch on the tensor cores (3xTF32
// mma.sync, tc_common.cuh `tc_ring`): M = rows, K = Cin (256 / 128), N =
// Cm (64 / 32). A block of 64 rows first takes each (row, component
// segment)'s mean and rstd, a warp a segment, four segments' loads in
// flight at once (a serial chain of 48 warp reductions cost a third more
// time), two passes as the twin (mean, then mean square deviation); the
// main loop's A tiles are x as it is,
// normalised in the fragments before the 3xTF32 split ((v - mean) * rstd
// * gamma + beta: tc_ring's `prep`). LN is not folded into the weights
// (x . (gamma W) - mean . colsum(gamma W)): that cancels badly where
// |mean| >> std. Bias and PReLU in the epilogue.
//
// dsconv_post_tc: the rest of both blocks and the fusion, 64 rows a block
// (16 frames of F = 4), every channel of both branches:
//   1. the two dilated 3x3 convs of a branch as implicit GEMMs through
//      tc_ring: K = 9 taps x Cmp (each tap's Cm zero-padded to a multiple
//      of 32: a stage lies in one tap), N = Cm; the copies gather y at (t +
//      (i - 1) d, f + j - 1), zero-filled outside [0, T) x [0, F). The d2
//      conv's gate sigmoid(g + bd2) goes to shared memory, then the d1
//      conv's a + bd1 multiplies it there (the same thread owns the same
//      (row, channel) in both: no barrier, half the accumulators live).
//   2. LN2 per component segment in shared memory (a thread a (row,
//      segment), two passes in fp32), then z * sigmoid(z) in place.
//   3. the output 1x1 conv: K = Cm, N = the fusion's channels, 32 a pass
//      (a pass's `ws` in the ring's space, the next loading during this
//      one's epilogue); A is z from shared memory. `ws` is packed
//      so that the thread holding complex re c also holds im c and the real
//      branch's m c (per 8 channels the n8 tiles re, im; then m), so bias,
//      the residual x and the fusion run in registers and oc, om are
//      written once.
// A block: 128 threads in 2 x 2 warps of 32 rows (4 complex, 2 real n8
// tiles a warp); shared memory 64.5 KB at the conformer's widths (a
// two-stage cp.async ring, both z tiles, LN2's statistics): three blocks
// an SM, which at B = 32 ran 30% faster than two with a three-stage ring
// (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// The single block (`se_dsconv_block_tc`: DSConvCplx / DSConvReal's module
// forward; the stage runs the pair entry) is the same design for its one
// branch, two launches: dsconv_block_pre_tc is `pre_branch` as the pair's
// pre kernel runs it; dsconv_block_post_tc runs `gated`, then LN2 and z *
// sigmoid(z) in shared memory, then the output 1x1 conv: K = Cm, N = Cin
// (256 complex, 128 real), CO = 32 channels a pass through the ring (the
// next pass loading during this one's epilogue), `ws` packed K-major (Cin
// rows of round_up(Cm, 8)), and an epilogue that adds bs and the residual
// x in registers and writes out once. 55 KB of shared memory a post block
// at Cm = 64: three an SM. The pair's post kernel keeps its own LN2 loop
// and pass loop: with them shared with the block (LN2 a branch at a time,
// a thread a (row, segment), every walk from channel 0) it ran 4% slower at
// B = 32 (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// The pair stage in bf16 (`se_dsconv_pair_tc_bf16`: dsconv_pre_bf16,
// dsconv_post_bf16): xc, xm, oc and om in bf16, the TPU kernel's rounding
// points (pallas_dsconv.py:292-321): x widened to fp32, every intermediate
// fp32 (the scratch y between the launches too: se_tpu never rounds it),
// the two outputs rounded once. The pre and post kernels' tiles, grids,
// packed orders and epilogues are the fp32 ones'; their products run on
// bf16 tensor cores (mma.sync.m16n8k16, fp32 accumulation) from a bf16
// cp.async ring (tc_common.cuh bfr::ring, 32-deep K stages, rows unpadded
// and swizzled) against bf16 packs (pack_pair_weights keeps w1, wd1, wd2
// and ws bf16; the vectors fp32). Every GEMM has an fp32 A operand (LN1's
// output, y's taps, z), which the fragments split in three bf16 pieces
// (split_bf16x3: their sum is the operand bit for bit), a product each:
// exact products, bound by operations at 989 / 3 = 329.7 TFLOP/s. The
// fp32 design templated on bf16 storage would widen x by synchronous loads,
// keep the weights in fp32 and run two TF32 passes (247.5 TFLOP/s).
//   - pre: x staged bf16 as it is (16-byte cp.async: Cin a multiple of 8),
//     LN1's statistics from the same values widened (row_stats, two
//     passes); in the fragments each pair widened, normalised in fp32 and
//     split. 4 stages of 8 KB.
//   - post: y's taps staged fp32 (bfr::swz32: conflict-free float2
//     fragment reads) against bf16 wd; z fp32 in shared memory at a row
//     stride of 8 mod 32 words (float2 reads), split against bf16 ws, a
//     pass's ws at a stride of 4 mod 32 words (ldmatrix); both widths
//     multiples of 16 (the output GEMM's k16). The ring's B side is half
//     the fp32 one's: 2 stages of 12 KB, 54.8 KB a block, four blocks an
//     SM where the fp32 post holds three. A stage at B = 32 took
//     0.41-0.44 ms so (the post 0.30 on the device), 0.55 with three
//     blocks of three stages (0.41), 0.51-0.54 with two blocks of four or
//     six; at B = 4, one block an SM whatever the residency, two to six
//     stages ran within 4% of each other; the pre's three and eight
//     stages no faster than its four (bf16_ring_sweep.py decoder and
//     pair, NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// The single block in bf16 (`se_dsconv_block_tc_bf16`:
// dsconv_block_pre_bf16, dsconv_block_post_bf16; the TPU kernel's
// `_pallas_dsconv` on a bf16 x, pallas_dsconv.py:107-108) is the bf16 pair
// stage's design for one branch, with its rounding points: x widened to
// fp32 inside, y and z fp32, out rounded once.
//   - pre: `pre_branch_bf16` (x staged bf16 by 16-byte cp.async: Cin a
//     multiple of 8; LN1's statistics from the same values widened; LN1's
//     output split in three bf16 pieces against the bf16 w1 on bfr::ring;
//     bias and PReLU in the epilogue).
//   - post: `gated_bf16` (y's taps staged fp32 and split against the bf16
//     wd1 and wd2), LN2 and z * sigmoid(z) in shared memory (z at a row
//     stride of tot + 8 floats, as the pair's), then the output 1x1 conv as
//     `out_gemm_bf16`: K = Cm, N = Cin (256 complex, 128 real), CO = 32
//     channels a pass, a pass's bf16 ws (K-major, Cin rows of Cm) loading
//     during the previous pass's epilogue; + bs + x, out written once. Cm a
//     multiple of 16 (the k16 steps).
// Other bf16 widths run the fp32 block on widened inputs (ops/dsconv.py
// `block_design`'s "tc_widened"). Bound at the main path's shapes by
// operations at 329.7 TFLOP/s (an fp32 operand against a bf16 one: three
// bf16 pieces, the fewest exact products). With the pair's ring depths and
// four blocks an SM (no other setting of bf16_ring_sweep.py block was
// faster at both B = 4 and 32), the 16 B = 4 calls of the conformer's
// shapes took 0.93 ms on the device, against 1.00 for the fp32 design on
// bf16 storage (two TF32 passes) that it replaced; at B = 32 a call 0.26
// complex and 0.11 real, against 0.33 and 0.13 (chip_smoke.py shapes,
// NVIDIA H100 80GB HBM3, 700 W; PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"
#include "unet_common.cuh"

namespace {

constexpr float LN_EPS = 1e-5f;

using bf16 = __nv_bfloat16;

// ------------------------------------- the pair stage, tensor cores

namespace tcp {

constexpr int TM = 64;        // rows a block
constexpr int TK = 32;        // K a stage
constexpr int PRE_STAGES = 3;   // cp.async ring depth, pre kernel
constexpr int POST_STAGES = 2;  // post: 64.5 KB a block, three an SM
constexpr int LDS = TK + 4;   // ring row stride in floats
constexpr int WM = 2;         // warps down the rows
constexpr int WN = 2;         // warps across the columns
constexpr int THREADS = 32 * WM * WN;
constexpr int NT_C = 4;       // n8 tiles a warp: complex N <= 64
constexpr int NT_M = 2;       // real N <= 32
constexpr int N_C = WN * NT_C * 8;
constexpr int N_M = WN * NT_M * 8;
constexpr int CO = 32;        // fusion channels an output pass

// Floats of a cp.async ring of `stages` A and B stages.
__host__ __device__ constexpr int ring_floats(int stages) {
  return stages * (TM + N_C) * LDS;
}

// One block's weights: the 13-tuple, w1 (N, K1p), g1 and b1 (K1p), wd1 and
// wd2 (N, 9 Cmp) and ws packed (ops/dsconv.py `pack_pair_weights`), the
// other vectors as they are.
struct Branch {
  const float *w1, *g1, *b1, *bb1, *alpha, *wd1, *bd1, *wd2, *bd2, *g2, *b2,
      *ws, *bs;
};

// TF32 passes of the pair's GEMMs: fp32 A and B (3), or fp32 A and a
// bf16-valued B (2) when the stage runs in bf16 (storage T).
template <class T>
__host__ __device__ constexpr int pair_passes() {
  return sizeof(T) == 2 ? 2 : 3;
}

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[mi][g][hh * 2 + j] of the warp (wm, wn) is local row wm 32 + mi 16 +
// hh 8 + lane / 4, column wn NT 8 + 8 g + 2 (lane % 4) + j: fn(row, col, v).
template <int NT, class Fn>
__device__ __forceinline__ void each_frag(float (&acc)[2][NT][4], Fn&& fn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int g = 0; g < NT; ++g)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          fn(wm * 32 + mi * 16 + hh * 8 + (lane >> 2),
             wn * NT * 8 + g * 8 + 2 * (lane & 3) + j, acc[mi][g][hh * 2 + j]);
}

// LN1's statistics of rows r0 .. r0 + TM of x (M, cin), nseg component
// segments a row: a warp a (row, segment), STAT_U of them at once (their
// loads in flight together), the mean, then the mean square deviation, as
// the twin. mu[row * 2 + s], rs likewise; 0 past M.
constexpr int STAT_U = 4;

template <class T>
__device__ void row_stats(const T* __restrict__ x, int M, int cin,
                          int nseg, int r0, float* mu, float* rs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cs = cin / nseg;
  // TM nseg is a multiple of the warps' STAT_U (TM = 64)
  for (int q0 = warp * STAT_U; q0 < TM * nseg;
       q0 += THREADS / 32 * STAT_U) {
    const T* v[STAT_U];
    float sum[STAT_U], mean[STAT_U], sq[STAT_U];
#pragma unroll
    for (int u = 0; u < STAT_U; ++u) {
      const int q = q0 + u;
      const long p = (long)r0 + q / nseg;
      v[u] = x + (p < M ? p : 0) * cin + (q % nseg) * cs;  // row 0: unused
      sum[u] = sq[u] = 0.f;
    }
    for (int i = lane; i < cs; i += 32)
#pragma unroll
      for (int u = 0; u < STAT_U; ++u) sum[u] += to_f(v[u][i]);
#pragma unroll
    for (int u = 0; u < STAT_U; ++u) mean[u] = warp_sum(sum[u]) / cs;
    for (int i = lane; i < cs; i += 32)
#pragma unroll
      for (int u = 0; u < STAT_U; ++u) {
        const float d = to_f(v[u][i]) - mean[u];
        sq[u] += d * d;
      }
#pragma unroll
    for (int u = 0; u < STAT_U; ++u) {
      const float rstd = rsqrtf(warp_sum(sq[u]) / cs + LN_EPS);
      const int q = q0 + u;
      const bool live = (long)r0 + q / nseg < M;
      if (lane == 0) {
        mu[(q / nseg) * 2 + q % nseg] = live ? mean[u] : 0.f;
        rs[(q / nseg) * 2 + q % nseg] = live ? rstd : 0.f;
      }
    }
  }
}

// One branch of dsconv_pre_tc: y (M, tot) = PReLU(LN1(x) . w1 + bb1) for
// rows r0 .. r0 + TM, x (M, cin) in nseg component segments, fp32 or bf16
// storage T.
template <int NT, class T>
__device__ void pre_branch(float* sm, const T* __restrict__ x,
                           const Branch& p, float* __restrict__ y, int M,
                           int cin, int tot, int nseg, int r0) {
  constexpr int NB_COLS = WN * NT * 8;
  float* As = sm;
  float* Bs = sm + PRE_STAGES * TM * LDS;
  float* mu = sm + ring_floats(PRE_STAGES);  // TM x 2
  float* rs = mu + 2 * TM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM, gid = lane >> 2, tq = lane & 3;
  const int kp = round_up(cin, TK), nk = kp / TK, cs = cin / nseg;
  row_stats(x, M, cin, nseg, r0, mu, rs);
  __syncthreads();
  // the statistics of the thread's fragment rows, segment 0 and 1 (for
  // one segment the same twice: past Cin gamma and beta are 0)
  float m_[2][2][2], r_[2][2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int q = (wm * 32 + mi * 16 + hh * 8 + gid) * 2 +
                      (s < nseg ? s : 0);
        m_[mi][hh][s] = mu[q];
        r_[mi][hh][s] = rs[q];
      }

  constexpr int CH = TK / 4, RSTEP = THREADS / CH;  // 8 chunks a row
  constexpr int NA = TM / RSTEP, NB = NB_COLS / RSTEP;
  const int crow = tid / CH, cq = tid % CH;
  const float* wq = p.w1 + (size_t)crow * kp + 4 * cq;
  auto load = [&](int kt, int slot) {
    const int k0 = kt * TK, ci = k0 + 4 * cq;
    float* bs = Bs + slot * NB_COLS * LDS + crow * LDS + 4 * cq;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      cp_async16(bs + i * RSTEP * LDS, wq + (size_t)i * RSTEP * kp + k0, 16);
    float* as = As + slot * TM * LDS + crow * LDS + 4 * cq;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const long row = (long)r0 + crow + i * RSTEP;
      const bool ok = row < M && ci < cin;
      copy4(as + i * RSTEP * LDS, ok ? x + row * cin + ci : x, ok);
    }
  };
  // LN1 on the A fragments: register j of a[mi] is row hh = j & 1 at K
  // index k + tq + 4 (j >> 1)
  const float* __restrict__ g1 = p.g1;
  const float* __restrict__ b1 = p.b1;
  auto prep = [&](int k, uint32_t (&a)[2][4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = k + tq + 4 * h;
      const float g = __ldg(g1 + kk), b = __ldg(b1 + kk);
      const bool s1 = kk >= cs;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float mean = s1 ? m_[mi][hh][1] : m_[mi][hh][0];
          const float rstd = s1 ? r_[mi][hh][1] : r_[mi][hh][0];
          const float v = __uint_as_float(a[mi][2 * h + hh]);
          a[mi][2 * h + hh] = __float_as_uint(fmaf((v - mean) * rstd, g, b));
        }
    }
  };
  float acc[2][NT][4];
  tc_ring<TM, NB_COLS, TK, LDS, PRE_STAGES, NT, true, pair_passes<T>()>(
      acc, As, Bs, nk, wm * 32, wn * NT * 8, load, prep);
  const float alpha = *p.alpha;
  each_frag<NT>(acc, [&](int r, int c, float v) {
    const long row = (long)r0 + r;
    if (row < M && c < tot) {
      v += p.bb1[c];
      y[row * tot + c] = v >= 0.f ? v : alpha * v;
    }
  });
  __syncthreads();  // the ring and the statistics are reused
}

template <class T>
__global__ void __launch_bounds__(THREADS, 4)
dsconv_pre_tc(const T* __restrict__ xc, Branch pc, float* __restrict__ yc,
              const T* __restrict__ xm, Branch pm, float* __restrict__ ym,
              int M, int cm, int totc, int totm) {
  extern __shared__ __align__(16) float sm[];
  const int r0 = blockIdx.x * TM;
  pre_branch<NT_C>(sm, xc, pc, yc, M, 2 * cm, totc, 2, r0);
  pre_branch<NT_M>(sm, xm, pm, ym, M, cm, totm, 1, r0);
}

// acc = the dilated 3x3 conv of y (M, tot) = (B, T, F, tot) with w (N, 9
// totp) packed, for rows r0 .. r0 + TM: A's row r is the 9 taps (i, j) of
// row r0 + r at (t + (i - 1) d, f + j - 1), each zero-padded to totp;
// PASSES as tc_ring's.
template <int NT, int PASSES = 3>
__device__ void dilated(float (&acc)[2][NT][4], float* ring,
                        const float* __restrict__ y,
                        const float* __restrict__ w, int M, int T, int F,
                        int tot, int d, int r0) {
  constexpr int NB_COLS = WN * NT * 8;
  float* As = ring;
  float* Bs = ring + POST_STAGES * TM * LDS;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int totp = round_up(tot, TK), kp = 9 * totp, nk = kp / TK;
  constexpr int CH = TK / 4, RSTEP = THREADS / CH;
  constexpr int NA = TM / RSTEP, NB = NB_COLS / RSTEP;
  const int crow = tid / CH, cq = tid % CH;
  const float* wq = w + (size_t)crow * kp + 4 * cq;
  int tt[NA], ff[NA];  // the thread's A rows' frame and bin; tt < 0: past M
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int p = r0 + crow + i * RSTEP;
    ff[i] = p % F;
    tt[i] = p < M ? (p / F) % T : -(1 << 30);
  }
  auto load = [&](int kt, int slot) {
    const int k0 = kt * TK, tap = k0 / totp;
    const int ci = k0 - tap * totp + 4 * cq;
    const int dt = (tap / 3 - 1) * d, df = tap % 3 - 1;
    float* bs = Bs + slot * NB_COLS * LDS + crow * LDS + 4 * cq;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      cp_async16(bs + i * RSTEP * LDS, wq + (size_t)i * RSTEP * kp + k0, 16);
    float* as = As + slot * TM * LDS + crow * LDS + 4 * cq;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int ts = tt[i] + dt, fs = ff[i] + df;
      const bool ok = ci < tot && ts >= 0 && ts < T && fs >= 0 && fs < F;
      const long src = (long)r0 + crow + i * RSTEP + (long)dt * F + df;
      cp_async16(as + i * RSTEP * LDS, ok ? y + src * tot + ci : y,
                 ok ? 16 : 0);
    }
  };
  tc_ring<TM, NB_COLS, TK, LDS, POST_STAGES, NT, true, PASSES>(
      acc, As, Bs, nk, wm * 32, wn * NT * 8, load);
  __syncthreads();  // every warp is done with the ring before it is reused
}

// z (TM, ldz) = (wd1 * y + bd1) * sigmoid(wd2 * y + bd2) for the block's
// rows, columns tot .. kz zero; the gate waits in z for the d1 conv.
template <int NT, int PASSES = 3>
__device__ void gated(float* ring, const float* __restrict__ y,
                      const Branch& p, float* z, int ldz, int kz, int M,
                      int T, int F, int tot, int d1, int d2, int r0) {
  float acc[2][NT][4];
  dilated<NT, PASSES>(acc, ring, y, p.wd2, M, T, F, tot, d2, r0);
  each_frag<NT>(acc, [&](int r, int c, float v) {
    if (c < kz) z[r * ldz + c] = c < tot ? sigmoidf(v + p.bd2[c]) : 0.f;
  });
  dilated<NT, PASSES>(acc, ring, y, p.wd1, M, T, F, tot, d1, r0);
  each_frag<NT>(acc, [&](int r, int c, float v) {
    if (c < kz)
      z[r * ldz + c] = c < tot ? (v + p.bd1[c]) * z[r * ldz + c] : 0.f;
  });
}

// Floats of dsconv_post_tc's shared memory.
__host__ __device__ inline int post_smem_floats(int totc, int totm) {
  return ring_floats(POST_STAGES) + TM * (round_up(totc, 8) + 4) +
         TM * (round_up(totm, 8) + 4) + 6 * TM;
}

// The rest of both blocks and the fusion for rows r0 .. r0 + TM; xc (M,
// 2cm) = [re | im] and xm (M, cm) the stage's inputs (fp32 or bf16 storage
// Tx, as oc and om), yc (M, totc) and ym (M, totm) the pre kernel's.
template <class Tx>
__global__ void __launch_bounds__(THREADS, 3)
dsconv_post_tc(const Tx* __restrict__ xc, const float* __restrict__ yc,
               Branch pc, const Tx* __restrict__ xm,
               const float* __restrict__ ym, Branch pm,
               Tx* __restrict__ oc, Tx* __restrict__ om, int M, int T,
               int F, int cm, int totc, int totm, int d1, int d2) {
  constexpr int P = pair_passes<Tx>();
  extern __shared__ __align__(16) float sm[];
  const int kc = round_up(totc, 8), km = round_up(totm, 8);
  const int ldc = kc + 4, ldm = km + 4;  // odd multiples of 4: no conflicts
  float* ring = sm;
  float* zc = sm + ring_floats(POST_STAGES);  // TM x ldc
  float* zm = zc + TM * ldc;  // TM x ldm
  float* mu = zm + TM * ldm;  // TM x 3: complex segments 0 and 1, real
  float* rs = mu + 3 * TM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM, gid = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.x * TM;

  // 1. the gated dilated convs of both branches
  gated<NT_C, P>(ring, yc, pc, zc, ldc, kc, M, T, F, totc, d1, d2, r0);
  gated<NT_M, P>(ring, ym, pm, zm, ldm, km, M, T, F, totm, d1, d2, r0);

  // the output GEMM's packed ws, a pass (CO channels: 2 CO complex rows of
  // kc, CO real rows of km) in the ring; pass 0 loads during LN2
  const int npass = (cm + CO - 1) / CO;
  float* bc = ring;
  float* bm = bc + 2 * CO * ldc;
  auto load_ws = [&](int ps) {
    const int qc = kc / 4, qm = km / 4;
    for (int e = tid; e < 2 * CO * qc; e += THREADS)
      cp_async16(bc + (e / qc) * ldc + 4 * (e % qc),
                 pc.ws + ((size_t)ps * 2 * CO + e / qc) * kc + 4 * (e % qc),
                 16);
    for (int e = tid; e < CO * qm; e += THREADS)
      cp_async16(bm + (e / qm) * ldm + 4 * (e % qm),
                 pm.ws + ((size_t)ps * CO + e / qm) * km + 4 * (e % qm), 16);
  };
  load_ws(0);
  cp_async_commit();
  __syncthreads();  // both z tiles are complete

  // 2. LN2 per component segment: a thread a (row, segment)
  const int csc = totc / 2;
  for (int q = tid; q < 3 * TM; q += THREADS) {
    const int r = q / 3, s = q % 3;
    const float* v = s < 2 ? zc + r * ldc + s * csc : zm + r * ldm;
    const int n = s < 2 ? csc : totm;
    float sum = 0.f;
    for (int i = 0; i < n; ++i) sum += v[i];
    const float mean = sum / n;
    float sq = 0.f;
    for (int i = 0; i < n; ++i) {
      const float dv = v[i] - mean;
      sq += dv * dv;
    }
    mu[q] = mean;
    rs[q] = rsqrtf(sq / n + LN_EPS);
  }
  __syncthreads();
  for (int e = tid; e < TM * kc; e += THREADS) {
    const int r = e / kc, c = e % kc;
    if (c >= totc) continue;
    const int q = r * 3 + (c >= csc);
    float* v = zc + r * ldc + c;
    const float zn = (*v - mu[q]) * rs[q] * pc.g2[c] + pc.b2[c];
    *v = zn * sigmoidf(zn);
  }
  for (int e = tid; e < TM * km; e += THREADS) {
    const int r = e / km, c = e % km;
    if (c >= totm) continue;
    const int q = r * 3 + 2;
    float* v = zm + r * ldm + c;
    const float zn = (*v - mu[q]) * rs[q] * pm.g2[c] + pm.b2[c];
    *v = zn * sigmoidf(zn);
  }

  // 3. the output 1x1 convs, + bias + x, and the fusion, CO channels a pass
  const float* za = zc + wm * 32 * ldc + lane_a_offset(lane, ldc);
  const float* zb = zm + wm * 32 * ldm + lane_a_offset(lane, ldm);
  NoPrep none;
  for (int ps = 0; ps < npass; ++ps) {
    cp_async_wait<0>();  // pass ps has landed
    __syncthreads();     // ... for all; (ps 0) z is normalised
    float sc[2][NT_C][4], sg[2][NT_M][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int g = 0; g < NT_C; ++g) sc[mi][g][j] = 0.f;
#pragma unroll
        for (int g = 0; g < NT_M; ++g) sg[mi][g][j] = 0.f;
      }
    const float* wb = bc + wn * NT_C * 8 * ldc + lane_b_offset(lane, ldc);
    for (int k = 0; k < kc; k += 8)
      mma_step<NT_C, P>(sc, za + k, ldc, wb + k, ldc, k, none);
    const float* wr = bm + wn * NT_M * 8 * ldm + lane_b_offset(lane, ldm);
    for (int k = 0; k < km; k += 8)
      mma_step<NT_M, P>(sg, zb + k, ldm, wr + k, ldm, k, none);
    __syncthreads();  // every warp is done with this pass's ws
    if (ps + 1 < npass) load_ws(ps + 1);  // lands during the epilogue
    cp_async_commit();
    // sc[mi][2 g + part][hh * 2 + j]: row gid + 8 hh of m tile mi, channel
    // ps CO + wn 16 + 8 g + 2 tq + j, part re (0) or im (1); sg[mi][g] m
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long row = (long)r0 + wm * 32 + mi * 16 + hh * 8 + gid;
        if (row >= M) continue;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int c = ps * CO + wn * 16 + g * 8 + 2 * tq;
          if (c >= cm) continue;  // cm % 4 == 0: c + 1 < cm too
          const Tx* xr = xc + row * 2 * cm + c;
          const Tx* xq = xm + row * cm + c;
          float o_re[2], o_im[2], o_m[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float re =
                sc[mi][2 * g][hh * 2 + j] + pc.bs[c + j] + to_f(xr[j]);
            const float im = sc[mi][2 * g + 1][hh * 2 + j] + pc.bs[cm + c + j] +
                             to_f(xr[cm + j]);
            const float m =
                sg[mi][g][hh * 2 + j] + pm.bs[c + j] + to_f(xq[j]);
            const float s = sigmoidf(m);
            o_re[j] = re + s;
            o_im[j] = im + s;
            o_m[j] = m + sigmoidf(sqrtf(fmaxf(re * re + im * im, FUSION_EPS)));
          }
          Tx* orow = oc + row * 2 * cm + c;
          put2(orow, o_re[0], o_re[1]);
          put2(orow + cm, o_im[0], o_im[1]);
          put2(om + row * cm + c, o_m[0], o_m[1]);
        }
      }
  }
  cp_async_wait<0>();
}

// ------------------------------- the pair stage, bf16 tensor cores (k16)

constexpr int PRE_BF_STAGES = 4;   // pre: 4 x 8 KB
constexpr int POST_BF_STAGES = 2;  // post: 2 x 12 KB, 54.3 KB a block ...
constexpr int POST_BF_BLOCKS = 4;  // ... four an SM

// A branch's tuple for the bf16 kernels: the packed weights bf16, the
// vectors fp32.
struct BranchBf {
  const bf16* w1;
  const float *g1, *b1, *bb1, *alpha;
  const bf16* wd1;
  const float* bd1;
  const bf16* wd2;
  const float *bd2, *g2, *b2;
  const bf16* ws;
  const float* bs;
};

// Bytes of the bf16 rings: pre, A and B bf16; post, A (y's taps) fp32.
__host__ __device__ constexpr int pre_bf_ring() {
  return PRE_BF_STAGES * (TM + N_C) * bfr::BK * 2;
}
__host__ __device__ constexpr int post_bf_ring() {
  return POST_BF_STAGES * (TM * 4 + N_C * 2) * bfr::BK;
}

// pre_branch on bf16 tensor cores: y (M, tot) = PReLU(LN1(x) . w1 + bb1)
// for rows r0 .. r0 + TM, x (M, cin) bf16 (cin a multiple of 8) staged as
// it is by 16-byte cp.async; in the fragments each pair of x widened,
// normalised in fp32 ((v - mean) * rstd * gamma + beta, the statistics
// row_stats' from the same bf16 values) and split in three bf16 pieces, a
// product each against the bf16 w1.
template <int NT>
__device__ void pre_branch_bf16(unsigned char* smb, const bf16* __restrict__ x,
                                const BranchBf& p, float* __restrict__ y,
                                int M, int cin, int tot, int nseg, int r0) {
  constexpr int NB_COLS = WN * NT * 8;
  constexpr int NA = TM / 32, NB = NB_COLS / 32;  // rows a thread copies
  float* mu = reinterpret_cast<float*>(smb + pre_bf_ring());  // TM x 2
  float* rs = mu + 2 * TM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM, gid = lane >> 2, tq = lane & 3;
  const int kp = round_up(cin, bfr::BK), nk = kp / bfr::BK, cs = cin / nseg;
  row_stats(x, M, cin, nseg, r0, mu, rs);
  __syncthreads();
  float m_[2][2][2], r_[2][2][2];  // as pre_branch's
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int q = (wm * 32 + mi * 16 + hh * 8 + gid) * 2 +
                      (s < nseg ? s : 0);
        m_[mi][hh][s] = mu[q];
        r_[mi][hh][s] = rs[q];
      }

  const int crow = tid >> 2, cq = tid & 3, dst = bfr::swz16(crow, cq);
  const bf16* wq = p.w1 + (size_t)crow * kp + 8 * cq;
  auto load = [&](int kt, bf16* as, bf16* bs) {
    const int k0 = kt * bfr::BK, ci = k0 + 8 * cq;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      cp_async16(bs + dst + 32 * i * bfr::BK, wq + (size_t)32 * i * kp + k0,
                 16);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const long row = (long)r0 + crow + 32 * i;
      const bool ok = row < M && ci < cin;
      cp_async16(as + dst + 32 * i * bfr::BK, ok ? x + row * cin + ci : x,
                 ok ? 16 : 0);
    }
  };
  // register i = 2 h + hh of m tile mi: row hh of the tile's halves, K
  // index k + 2 tq (+1) + 8 h; one segment for both (cs is even)
  int a_ld[2];
  bfr::a_lanes(wm * 32, a_ld);
  const float* __restrict__ g1 = p.g1;
  const float* __restrict__ b1 = p.b1;
  auto frag = [&](int ps, int k, const bf16* as, uint32_t (&a)[3][2][4]) {
    uint32_t raw[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_x4(raw[mi], as + a_ld[ps] + 16 * mi * bfr::BK);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = k + 2 * tq + 8 * h;
      const float g0 = __ldg(g1 + kk), g1v = __ldg(g1 + kk + 1);
      const float c0 = __ldg(b1 + kk), c1 = __ldg(b1 + kk + 1);
      const bool s1 = kk >= cs;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float mean = s1 ? m_[mi][hh][1] : m_[mi][hh][0];
          const float rstd = s1 ? r_[mi][hh][1] : r_[mi][hh][0];
          float2 v = unpack_bf16x2(raw[mi][2 * h + hh]);
          v.x = fmaf((v.x - mean) * rstd, g0, c0);
          v.y = fmaf((v.y - mean) * rstd, g1v, c1);
          bfr::split3(v, a, mi, 2 * h + hh);
        }
    }
  };
  float acc[2][NT][4];
  bfr::ring<TM, NB_COLS, PRE_BF_STAGES, NT, 3, bf16>(acc, smb, nk,
                                                     wn * NT * 8, load, frag);
  const float alpha = *p.alpha;
  each_frag<NT>(acc, [&](int r, int c, float v) {
    const long row = (long)r0 + r;
    if (row < M && c < tot) {
      v += p.bb1[c];
      y[row * tot + c] = v >= 0.f ? v : alpha * v;
    }
  });
  __syncthreads();  // the ring and the statistics are reused
}

__global__ void __launch_bounds__(THREADS, 4)
dsconv_pre_bf16(const bf16* __restrict__ xc, BranchBf pc,
                float* __restrict__ yc, const bf16* __restrict__ xm,
                BranchBf pm, float* __restrict__ ym, int M, int cm, int totc,
                int totm) {
  extern __shared__ __align__(16) unsigned char smb[];
  const int r0 = blockIdx.x * TM;
  pre_branch_bf16<NT_C>(smb, xc, pc, yc, M, 2 * cm, totc, 2, r0);
  pre_branch_bf16<NT_M>(smb, xm, pm, ym, M, cm, totm, 1, r0);
}

// dilated on bf16 tensor cores: y's taps staged fp32 (8 16-byte chunks a
// row, zero-filled where dilated zero-fills) and split in three bf16
// pieces in the fragments, against the bf16 w.
template <int NT>
__device__ void dilated_bf16(float (&acc)[2][NT][4], unsigned char* smb,
                             const float* __restrict__ y,
                             const bf16* __restrict__ w, int M, int T, int F,
                             int tot, int d, int r0) {
  constexpr int NB_COLS = WN * NT * 8;
  constexpr int NA = TM / 16, NB = NB_COLS / 32;  // rows a thread copies
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int totp = round_up(tot, bfr::BK), kp = 9 * totp, nk = kp / bfr::BK;
  const int ar = tid >> 3, aq = tid & 7, a_dst = bfr::swz32(ar, aq);
  const int br = tid >> 2, bq = tid & 3, b_dst = bfr::swz16(br, bq);
  const bf16* wq = w + (size_t)br * kp + 8 * bq;
  int tt[NA], ff[NA];  // the thread's A rows' frame and bin; tt < 0: past M
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int p = r0 + ar + 16 * i;
    ff[i] = p % F;
    tt[i] = p < M ? (p / F) % T : -(1 << 30);
  }
  auto load = [&](int kt, float* as, bf16* bs) {
    const int k0 = kt * bfr::BK, tap = k0 / totp;
    const int ci = k0 - tap * totp + 4 * aq;
    const int dt = (tap / 3 - 1) * d, df = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      cp_async16(bs + b_dst + 32 * i * bfr::BK,
                 wq + (size_t)32 * i * kp + k0, 16);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int ts = tt[i] + dt, fs = ff[i] + df;
      const bool ok = ci < tot && ts >= 0 && ts < T && fs >= 0 && fs < F;
      const long src = (long)r0 + ar + 16 * i + (long)dt * F + df;
      cp_async16(as + a_dst + 16 * i * bfr::BK, ok ? y + src * tot + ci : y,
                 ok ? 16 : 0);
    }
  };
  int x_ld[4];
  bfr::x_lanes(wm * 32, x_ld);
  auto frag = [&](int ps, int, const float* as, uint32_t (&a)[3][2][4]) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        bfr::split3(*reinterpret_cast<const float2*>(
                        as + x_ld[2 * ps + (i >> 1)] +
                        (16 * mi + 8 * (i & 1)) * bfr::BK),
                    a, mi, i);
  };
  bfr::ring<TM, NB_COLS, POST_BF_STAGES, NT, 3, float>(acc, smb, nk,
                                                       wn * NT * 8, load,
                                                       frag);
  __syncthreads();  // every warp is done with the ring before it is reused
}

// gated on bf16 tensor cores.
template <int NT>
__device__ void gated_bf16(unsigned char* smb, const float* __restrict__ y,
                           const BranchBf& p, float* z, int ldz, int kz,
                           int M, int T, int F, int tot, int d1, int d2,
                           int r0) {
  float acc[2][NT][4];
  dilated_bf16<NT>(acc, smb, y, p.wd2, M, T, F, tot, d2, r0);
  each_frag<NT>(acc, [&](int r, int c, float v) {
    if (c < kz) z[r * ldz + c] = c < tot ? sigmoidf(v + p.bd2[c]) : 0.f;
  });
  dilated_bf16<NT>(acc, smb, y, p.wd1, M, T, F, tot, d1, r0);
  each_frag<NT>(acc, [&](int r, int c, float v) {
    if (c < kz)
      z[r * ldz + c] = c < tot ? (v + p.bd1[c]) * z[r * ldz + c] : 0.f;
  });
}

// Bytes of dsconv_post_bf16's shared memory (totc, totm multiples of 16):
// the ring, zc and zm at row strides of tot + 8 floats (8 mod 32: a
// half-warp's float2 fragment reads hit 32 distinct banks), LN2's
// statistics.
__host__ __device__ inline int post_bf_smem(int totc, int totm) {
  return post_bf_ring() + 4 * TM * (totc + 8 + totm + 8) + 4 * 6 * TM;
}

// sum[mi][g] += z . ws^T over K = kz (a multiple of 16) for the warp's 32
// rows of z (fp32, row stride ldz, from row wm 32; each pair split in
// three bf16 pieces) and NT n8 tiles of ws (bf16, row stride ldw, from
// row b_row0; ldw = 4 mod 32 words: conflict-free ldmatrix).
template <int NT>
__device__ __forceinline__ void out_gemm_bf16(float (&sum)[2][NT][4],
                                              const float* z, int ldz,
                                              const bf16* ws, int ldw,
                                              int kz, int b_row0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, gid = lane >> 2, tq = lane & 3;
  const float* za = z + (wm * 32 + gid) * ldz + 2 * tq;
  const bf16* wb = ws + (b_row0 + (lane & 7) + (lane >> 4) * 8) * ldw +
                   ((lane >> 3) & 1) * 8;
  for (int k = 0; k < kz; k += 16) {
    uint32_t a[3][2][4], b[NT][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        bfr::split3(*reinterpret_cast<const float2*>(
                        za + (16 * mi + 8 * (i & 1)) * ldz + k +
                        8 * (i >> 1)),
                    a, mi, i);
#pragma unroll
    for (int g = 0; g < NT; g += 2) ldsm_x4(b[g], wb + g * 8 * ldw + k);
#pragma unroll
    for (int pc = 0; pc < 3; ++pc)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int g = 0; g < NT; ++g) mma_bf16(sum[mi][g], a[pc][mi], b[g]);
  }
}

// dsconv_post_tc on bf16 tensor cores: xc, xm, oc, om bf16; yc, ym the pre
// kernel's fp32; the weights bf16. totc and totm multiples of 16.
__global__ void __launch_bounds__(THREADS, POST_BF_BLOCKS)
dsconv_post_bf16(const bf16* __restrict__ xc, const float* __restrict__ yc,
                 BranchBf pc, const bf16* __restrict__ xm,
                 const float* __restrict__ ym, BranchBf pm,
                 bf16* __restrict__ oc, bf16* __restrict__ om, int M, int T,
                 int F, int cm, int totc, int totm, int d1, int d2) {
  extern __shared__ __align__(16) unsigned char smb[];
  const int kc = totc, km = totm, ldc = kc + 8, ldm = km + 8;
  float* zc = reinterpret_cast<float*>(smb + post_bf_ring());  // TM x ldc
  float* zm = zc + TM * ldc;                                   // TM x ldm
  float* mu = zm + TM * ldm;  // TM x 3: complex segments 0 and 1, real
  float* rs = mu + 3 * TM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM, gid = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.x * TM;

  // 1. the gated dilated convs of both branches
  gated_bf16<NT_C>(smb, yc, pc, zc, ldc, kc, M, T, F, totc, d1, d2, r0);
  gated_bf16<NT_M>(smb, ym, pm, zm, ldm, km, M, T, F, totm, d1, d2, r0);

  // the output GEMM's packed ws, a pass (2 CO complex rows of kc, CO real
  // rows of km, at strides kc + 8 and km + 8) in the ring; pass 0 loads
  // during LN2
  const int npass = (cm + CO - 1) / CO;
  bf16* bc = reinterpret_cast<bf16*>(smb);
  bf16* bm = bc + 2 * CO * ldc;
  auto load_ws = [&](int ps) {
    const int qc = kc / 8, qm = km / 8;
    for (int e = tid; e < 2 * CO * qc; e += THREADS)
      cp_async16(bc + (e / qc) * ldc + 8 * (e % qc),
                 pc.ws + ((size_t)ps * 2 * CO + e / qc) * kc + 8 * (e % qc),
                 16);
    for (int e = tid; e < CO * qm; e += THREADS)
      cp_async16(bm + (e / qm) * ldm + 8 * (e % qm),
                 pm.ws + ((size_t)ps * CO + e / qm) * km + 8 * (e % qm), 16);
  };
  load_ws(0);
  cp_async_commit();
  __syncthreads();  // both z tiles are complete

  // 2. LN2 per component segment, two passes as the twin: a thread a (row,
  // segment), then z * sigmoid(z) in place
  const int csc = totc / 2;
  for (int q = tid; q < 3 * TM; q += THREADS) {
    const int r = q / 3, s = q % 3;
    const float* v = s < 2 ? zc + r * ldc + s * csc : zm + r * ldm;
    const int n = s < 2 ? csc : totm;
    float sum = 0.f;
    for (int i = 0; i < n; ++i) sum += v[i];
    const float mean = sum / n;
    float sq = 0.f;
    for (int i = 0; i < n; ++i) {
      const float dv = v[i] - mean;
      sq += dv * dv;
    }
    mu[q] = mean;
    rs[q] = rsqrtf(sq / n + LN_EPS);
  }
  __syncthreads();
  for (int e = tid; e < TM * kc; e += THREADS) {
    const int r = e / kc, c = e % kc, q = r * 3 + (c >= csc);
    float* v = zc + r * ldc + c;
    const float zn = (*v - mu[q]) * rs[q] * pc.g2[c] + pc.b2[c];
    *v = zn * sigmoidf(zn);
  }
  for (int e = tid; e < TM * km; e += THREADS) {
    const int r = e / km, c = e % km, q = r * 3 + 2;
    float* v = zm + r * ldm + c;
    const float zn = (*v - mu[q]) * rs[q] * pm.g2[c] + pm.b2[c];
    *v = zn * sigmoidf(zn);
  }

  // 3. the output 1x1 convs, + bias + x, and the fusion, CO channels a pass
  for (int ps = 0; ps < npass; ++ps) {
    cp_async_wait<0>();  // pass ps has landed
    __syncthreads();     // ... for all; (ps 0) z is normalised
    float sc[2][NT_C][4], sg[2][NT_M][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int g = 0; g < NT_C; ++g) sc[mi][g][j] = 0.f;
#pragma unroll
        for (int g = 0; g < NT_M; ++g) sg[mi][g][j] = 0.f;
      }
    out_gemm_bf16<NT_C>(sc, zc, ldc, bc, ldc, kc, wn * NT_C * 8);
    out_gemm_bf16<NT_M>(sg, zm, ldm, bm, ldm, km, wn * NT_M * 8);
    __syncthreads();  // every warp is done with this pass's ws
    if (ps + 1 < npass) load_ws(ps + 1);  // lands during the epilogue
    cp_async_commit();
    // as dsconv_post_tc's: sc[mi][2 g + part], sg[mi][g]
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long row = (long)r0 + wm * 32 + mi * 16 + hh * 8 + gid;
        if (row >= M) continue;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int c = ps * CO + wn * 16 + g * 8 + 2 * tq;
          if (c >= cm) continue;  // cm % 8 == 0: c + 1 < cm too
          const bf16* xr = xc + row * 2 * cm + c;
          const bf16* xq = xm + row * cm + c;
          float o_re[2], o_im[2], o_m[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float re =
                sc[mi][2 * g][hh * 2 + j] + pc.bs[c + j] + to_f(xr[j]);
            const float im = sc[mi][2 * g + 1][hh * 2 + j] +
                             pc.bs[cm + c + j] + to_f(xr[cm + j]);
            const float m =
                sg[mi][g][hh * 2 + j] + pm.bs[c + j] + to_f(xq[j]);
            const float s = sigmoidf(m);
            o_re[j] = re + s;
            o_im[j] = im + s;
            o_m[j] = m + sigmoidf(sqrtf(fmaxf(re * re + im * im, FUSION_EPS)));
          }
          bf16* orow = oc + row * 2 * cm + c;
          put2(orow, o_re[0], o_re[1]);
          put2(orow + cm, o_im[0], o_im[1]);
          put2(om + row * cm + c, o_m[0], o_m[1]);
        }
      }
  }
  cp_async_wait<0>();
}

// ------------------------------------- the single block, tensor cores

// One block's pre stage: y (M, tot) = PReLU(LN1(x) . w1 + bb1), x (M, cin)
// in nseg component segments, fp32 or bf16 storage T (y fp32 either way);
// NT n8 tiles a warp (N = 64 complex, 32 real).
template <int NT, class T>
__global__ void __launch_bounds__(THREADS, 4)
dsconv_block_pre_tc(const T* __restrict__ x, Branch p,
                    float* __restrict__ y, int M, int cin, int tot,
                    int nseg) {
  extern __shared__ __align__(16) float sm[];
  pre_branch<NT>(sm, x, p, y, M, cin, tot, nseg, blockIdx.x * TM);
}

// A block's LN2 per component segment of z (TM rows at stride ldz, tot
// columns in nseg segments), two passes as the twin: a thread a (row,
// segment), consecutive threads on consecutive rows, each starting its
// walk at channel r % cs (ldz = 4 mod 8 or 8 mod 32: at cs = 32 a warp's
// 32 rows read 32 distinct banks, where all starting at channel 0 read 8
// or 4); then z * sigmoid(z) in place on the columns below tot of kz. mu
// and rs hold 2 TM floats each.
__device__ void block_ln2_swish(float* z, int ldz, int kz, int tot, int nseg,
                                const float* __restrict__ g2,
                                const float* __restrict__ b2, float* mu,
                                float* rs) {
  const int tid = threadIdx.x, cs = tot / nseg;
  for (int q = tid; q < TM * nseg; q += THREADS) {
    const int r = q % TM, s = q / TM, j0 = r % cs;
    const float* v = z + r * ldz + s * cs;
    float sum = 0.f;
    for (int i = 0, j = j0; i < cs; ++i, j = j + 1 == cs ? 0 : j + 1)
      sum += v[j];
    const float mean = sum / cs;
    float sq = 0.f;
    for (int i = 0, j = j0; i < cs; ++i, j = j + 1 == cs ? 0 : j + 1) {
      const float dv = v[j] - mean;
      sq += dv * dv;
    }
    mu[r * 2 + s] = mean;
    rs[r * 2 + s] = rsqrtf(sq / cs + LN_EPS);
  }
  __syncthreads();
  for (int e = tid; e < TM * kz; e += THREADS) {
    const int r = e / kz, c = e % kz;
    if (c >= tot) continue;
    const int q = r * 2 + (c >= cs);
    float* v = z + r * ldz + c;
    const float zn = (*v - mu[q]) * rs[q] * g2[c] + b2[c];
    *v = zn * sigmoidf(zn);
  }
}

// Floats of dsconv_block_post_tc's shared memory.
__host__ __device__ inline int block_post_smem_floats(int tot) {
  return ring_floats(POST_STAGES) + TM * (round_up(tot, 8) + 4) + 4 * TM;
}

// The rest of one block for rows r0 .. r0 + TM: the gated dilated convs,
// LN2 and swish in shared memory, the output 1x1 conv (K = tot, N = cin,
// CO channels a pass: 2 x 2 warps of 32 rows x 16 channels), + bs + x; x
// and out in storage Tx (fp32; the bf16 block has kernels of its own).
template <int NT, class Tx>
__global__ void __launch_bounds__(THREADS, 3)
dsconv_block_post_tc(const Tx* __restrict__ x,
                     const float* __restrict__ y, Branch p,
                     Tx* __restrict__ out, int M, int T, int F, int cin,
                     int tot, int nseg, int d1, int d2) {
  constexpr int P = pair_passes<Tx>();
  extern __shared__ __align__(16) float sm[];
  const int kz = round_up(tot, 8), ldz = kz + 4;
  float* ring = sm;
  float* z = sm + ring_floats(POST_STAGES);  // TM x ldz
  float* mu = z + TM * ldz;                  // TM x 2 segments
  float* rs = mu + 2 * TM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM, gid = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.x * TM;

  gated<NT, P>(ring, y, p, z, ldz, kz, M, T, F, tot, d1, d2, r0);

  // ws packed K-major (cin rows of kz), a pass's CO rows in the ring, zero
  // past cin
  const int npass = (cin + CO - 1) / CO;
  float* bw = ring;
  auto load_ws = [&](int ps) {
    const int qz = kz / 4;
    for (int e = tid; e < CO * qz; e += THREADS) {
      const int row = ps * CO + e / qz;
      const bool ok = row < cin;
      cp_async16(bw + (e / qz) * ldz + 4 * (e % qz),
                 p.ws + (size_t)(ok ? row : 0) * kz + 4 * (e % qz),
                 ok ? 16 : 0);
    }
  };
  load_ws(0);
  cp_async_commit();
  __syncthreads();  // z is complete

  block_ln2_swish(z, ldz, kz, tot, nseg, p.g2, p.b2, mu, rs);

  // the output 1x1 conv, CO channels a pass (2 x 2 warps of 32 rows x 16
  // channels), + bs + x; pass 0's ws landed during LN2, pass ps + 1 loads
  // during pass ps's epilogue
  const float* za = z + wm * 32 * ldz + lane_a_offset(lane, ldz);
  const float* wb = bw + wn * 16 * ldz + lane_b_offset(lane, ldz);
  NoPrep none;
  for (int ps = 0; ps < npass; ++ps) {
    cp_async_wait<0>();  // pass ps has landed
    __syncthreads();     // ... for all; (ps 0) z is normalised
    float acc[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][g][j] = 0.f;
    for (int k = 0; k < kz; k += 8)
      mma_step<2, P>(acc, za + k, ldz, wb + k, ldz, k, none);
    __syncthreads();  // every warp is done with this pass's ws
    if (ps + 1 < npass) load_ws(ps + 1);
    cp_async_commit();
    // acc[mi][g][hh * 2 + j]: row gid + 8 hh of m tile mi, channel ps CO +
    // wn 16 + 8 g + 2 tq + j
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long row = (long)r0 + wm * 32 + mi * 16 + hh * 8 + gid;
        if (row >= M) continue;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int c = ps * CO + wn * 16 + g * 8 + 2 * tq;
          if (c >= cin) continue;  // cin % 4 == 0: c + 1 < cin too
          const Tx* xr = x + row * cin + c;
          put2(out + row * cin + c, acc[mi][g][hh * 2] + p.bs[c] + to_f(xr[0]),
               acc[mi][g][hh * 2 + 1] + p.bs[c + 1] + to_f(xr[1]));
        }
      }
  }
  cp_async_wait<0>();
}

// ------------------------------- the single block, bf16 tensor cores (k16)

// The block's bf16 kernels run with the pair's PRE_BF_STAGES,
// POST_BF_STAGES and POST_BF_BLOCKS (see the header). Bytes of
// dsconv_block_pre_bf16's shared memory (the ring, LN1's
// statistics) and of dsconv_block_post_bf16's (the ring, z at a row stride
// of tot + 8 floats as the pair's, LN2's statistics).
__host__ __device__ constexpr int block_pre_bf_smem() {
  return pre_bf_ring() + 16 * TM;
}
__host__ __device__ inline int block_post_bf_smem(int tot) {
  return post_bf_ring() + 4 * TM * (tot + 8) + 16 * TM;
}

// Component segments of the block whose N is NT n8 tiles a warp: 2 for
// the complex block (N = 64), 1 for the real one (N = 32); a constant, so
// the segment selects of LN1 and LN2 fold.
template <int NT>
__host__ __device__ constexpr int block_nseg() {
  return NT == NT_C ? 2 : 1;
}

// One block's pre stage on bf16 tensor cores: y (M, tot) = PReLU(LN1(x) .
// w1 + bb1), x (M, cin) bf16, y fp32; the pair's pre_branch_bf16.
template <int NT>
__global__ void __launch_bounds__(THREADS, 4)
dsconv_block_pre_bf16(const bf16* __restrict__ x, BranchBf p,
                      float* __restrict__ y, int M, int cin, int tot) {
  extern __shared__ __align__(16) unsigned char smb[];
  pre_branch_bf16<NT>(smb, x, p, y, M, cin, tot, block_nseg<NT>(),
                      blockIdx.x * TM);
}

// The rest of one block on bf16 tensor cores for rows r0 .. r0 + TM: the
// gated dilated convs (gated_bf16), LN2 and swish in shared memory, the
// output 1x1 conv (K = tot, N = cin, CO channels a pass: 2 x 2 warps of 32
// rows x 16 channels, out_gemm_bf16), + bs + x, out rounded to bf16 once.
// x and out bf16, y fp32, tot a multiple of 16.
template <int NT>
__global__ void __launch_bounds__(THREADS, POST_BF_BLOCKS)
dsconv_block_post_bf16(const bf16* __restrict__ x,
                       const float* __restrict__ y, BranchBf p,
                       bf16* __restrict__ out, int M, int T, int F, int cin,
                       int tot, int d1, int d2) {
  extern __shared__ __align__(16) unsigned char smb[];
  const int ldz = tot + 8;
  float* z = reinterpret_cast<float*>(smb + post_bf_ring());  // TM x ldz
  float* mu = z + TM * ldz;  // TM x 2 segments
  float* rs = mu + 2 * TM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM, gid = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.x * TM;

  gated_bf16<NT>(smb, y, p, z, ldz, tot, M, T, F, tot, d1, d2, r0);

  // ws packed K-major (cin rows of tot), a pass's CO rows in the ring at a
  // row stride of tot + 8 (the 8 rows an ldmatrix reads in distinct bank
  // groups), zero past cin
  const int npass = (cin + CO - 1) / CO;
  bf16* bw = reinterpret_cast<bf16*>(smb);
  auto load_ws = [&](int ps) {
    const int qz = tot / 8;
    for (int e = tid; e < CO * qz; e += THREADS) {
      const int row = ps * CO + e / qz;
      const bool ok = row < cin;
      cp_async16(bw + (e / qz) * ldz + 8 * (e % qz),
                 p.ws + (size_t)(ok ? row : 0) * tot + 8 * (e % qz),
                 ok ? 16 : 0);
    }
  };
  load_ws(0);
  cp_async_commit();
  __syncthreads();  // z is complete
  block_ln2_swish(z, ldz, tot, tot, block_nseg<NT>(), p.g2, p.b2, mu, rs);

  // the output 1x1 conv, CO channels a pass, + bs + x; pass 0's ws landed
  // during LN2, pass ps + 1 loads during pass ps's epilogue
  for (int ps = 0; ps < npass; ++ps) {
    cp_async_wait<0>();  // pass ps has landed
    __syncthreads();     // ... for all; (ps 0) z is normalised
    float acc[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][g][j] = 0.f;
    out_gemm_bf16<2>(acc, z, ldz, bw, ldz, tot, wn * 16);
    __syncthreads();  // every warp is done with this pass's ws
    if (ps + 1 < npass) load_ws(ps + 1);
    cp_async_commit();
    // as dsconv_block_post_tc's: acc[mi][g][hh * 2 + j]
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long row = (long)r0 + wm * 32 + mi * 16 + hh * 8 + gid;
        if (row >= M) continue;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int c = ps * CO + wn * 16 + g * 8 + 2 * tq;
          if (c >= cin) continue;  // cin % 8 == 0: c + 1 < cin too
          const bf16* xr = x + row * cin + c;
          put2(out + row * cin + c, acc[mi][g][hh * 2] + p.bs[c] + to_f(xr[0]),
               acc[mi][g][hh * 2 + 1] + p.bs[c + 1] + to_f(xr[1]));
        }
      }
  }
  cp_async_wait<0>();
}

}  // namespace tcp
}  // namespace

namespace {

bool misaligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
}

// Opt kernel `fn` into `smem` bytes of shared memory, then launch it.
template <class... P, class... A>
int launch_smem(void (*fn)(P...), unsigned blocks, int smem, cudaStream_t st,
                A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fn<<<blocks, tcp::THREADS, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <int NT, class Tx>
int block_tc(const Tx* x, const tcp::Branch& p, float* y, Tx* out, long M,
             int T, int F, int cin, int tot, int ncomp, int d1, int d2,
             cudaStream_t st) {
  const unsigned blocks = (unsigned)((M + tcp::TM - 1) / tcp::TM);
  const int pre_smem =
      (tcp::ring_floats(tcp::PRE_STAGES) + 4 * tcp::TM) * (int)sizeof(float);
  int err = launch_smem(tcp::dsconv_block_pre_tc<NT, Tx>, blocks, pre_smem,
                        st, x, p, y, (int)M, cin, tot, ncomp);
  if (err != 0) return err;
  const int post_smem = tcp::block_post_smem_floats(tot) * (int)sizeof(float);
  return launch_smem(tcp::dsconv_block_post_tc<NT, Tx>, blocks, post_smem, st,
                     x, (const float*)y, p, out, (int)M, T, F, cin, tot,
                     ncomp, d1, d2);
}

template <class Tx>
int block_entry(const Tx* x, const tcp::Branch& p, float* y, Tx* out, int B,
                int T, int F, int cin, int tot, int ncomp, int d1, int d2,
                cudaStream_t st) {
  const int n_max = ncomp == 2 ? tcp::N_C : tcp::N_M;
  if ((ncomp != 1 && ncomp != 2) || cin % 4 != 0 || tot % 4 != 0 ||
      cin <= 0 || tot <= 0 || tot > n_max || misaligned(x) || misaligned(y))
    return (int)cudaErrorInvalidValue;
  const long M = (long)B * T * F;
  if (M == 0) return 0;
  if (ncomp == 2)
    return block_tc<tcp::NT_C>(x, p, y, out, M, T, F, cin, tot, ncomp, d1,
                               d2, st);
  return block_tc<tcp::NT_M>(x, p, y, out, M, T, F, cin, tot, ncomp, d1, d2,
                             st);
}

}  // namespace

// One gated dilated DSConv block (se_tpu's `dsconv_block`) on the tensor
// cores: x (B, T, F, cin) -> out of the same shape, residual included. The
// 13 pointers in the tuple's order, w1, g1, b1, wd1, wd2 packed by
// ops/dsconv.py `_pack_branch` (N = 64 for ncomp 2, 32 for ncomp 1) and ws
// K-major (cin rows of round_up(tot, 8)); y (B, T, F, tot) is scratch for
// the pre stage. Needs cin and tot multiples of 4, tot <= 64 (ncomp 2) or
// 32 (ncomp 1), and x, y 16-byte aligned.
extern "C" int se_dsconv_block_tc(
    const float* x, const float* w1, const float* g1, const float* b1,
    const float* bb1, const float* alpha, const float* wd1, const float* bd1,
    const float* wd2, const float* bd2, const float* g2, const float* b2,
    const float* ws, const float* bs, float* y, float* out, int B, int T,
    int F, int cin, int tot, int ncomp, int d1, int d2, void* stream) {
  const tcp::Branch p{w1, g1, b1, bb1, alpha, wd1, bd1,
                      wd2, bd2, g2, b2, ws, bs};
  return block_entry(x, p, y, out, B, T, F, cin, tot, ncomp, d1, d2,
                     (cudaStream_t)stream);
}

namespace {

template <int NT>
int block_bf16(const bf16* x, const tcp::BranchBf& p, float* y, bf16* out,
               long M, int T, int F, int cin, int tot, int d1, int d2,
               cudaStream_t st) {
  const unsigned blocks = (unsigned)((M + tcp::TM - 1) / tcp::TM);
  const int err = launch_smem(tcp::dsconv_block_pre_bf16<NT>, blocks,
                              tcp::block_pre_bf_smem(), st, x, p, y, (int)M,
                              cin, tot);
  if (err != 0) return err;
  return launch_smem(tcp::dsconv_block_post_bf16<NT>, blocks,
                     tcp::block_post_bf_smem(tot), st, x, (const float*)y, p,
                     out, (int)M, T, F, cin, tot, d1, d2);
}

}  // namespace

// The block on bf16 tensor cores (dsconv_block_pre_bf16,
// dsconv_block_post_bf16): x and out bf16; the packed weights
// (pack_block_weights' layout, in bf16) bf16; the vectors and the scratch
// y fp32; otherwise as se_dsconv_block_tc. Needs cin a multiple of 8
// (16-byte copies of x), tot a multiple of 16 (the output GEMM's k16
// steps), tot <= 64 (ncomp 2) or 32 (ncomp 1), and x, y 16-byte aligned.
extern "C" int se_dsconv_block_tc_bf16(
    const bf16* x, const bf16* w1, const float* g1, const float* b1,
    const float* bb1, const float* alpha, const bf16* wd1, const float* bd1,
    const bf16* wd2, const float* bd2, const float* g2, const float* b2,
    const bf16* ws, const float* bs, float* y, bf16* out, int B, int T,
    int F, int cin, int tot, int ncomp, int d1, int d2, void* stream) {
  const int n_max = ncomp == 2 ? tcp::N_C : tcp::N_M;
  if ((ncomp != 1 && ncomp != 2) || cin % 8 != 0 || tot % 16 != 0 ||
      cin <= 0 || tot <= 0 || tot > n_max || misaligned(x) || misaligned(y))
    return (int)cudaErrorInvalidValue;
  const long M = (long)B * T * F;
  if (M == 0) return 0;
  const tcp::BranchBf p{w1, g1, b1, bb1, alpha, wd1, bd1,
                        wd2, bd2, g2, b2, ws, bs};
  const cudaStream_t st = (cudaStream_t)stream;
  if (ncomp == 2)
    return block_bf16<tcp::NT_C>(x, p, y, out, M, T, F, cin, tot, d1, d2,
                                 st);
  return block_bf16<tcp::NT_M>(x, p, y, out, M, T, F, cin, tot, d1, d2, st);
}

// The bf16 block's two kernels' resources at (ncomp, tot) (tc_common.cuh
// kernel_resources): out[0..3] dsconv_block_pre_bf16's, out[4..7]
// dsconv_block_post_bf16's.
extern "C" int se_dsconv_block_tc_bf16_resources(int ncomp, int tot,
                                                 int* out) {
  const int pre = tcp::block_pre_bf_smem();
  const int post = tcp::block_post_bf_smem(tot);
  const int err =
      ncomp == 2
          ? kernel_resources(tcp::dsconv_block_pre_bf16<tcp::NT_C>,
                             tcp::THREADS, pre, out)
          : kernel_resources(tcp::dsconv_block_pre_bf16<tcp::NT_M>,
                             tcp::THREADS, pre, out);
  if (err != 0) return err;
  return ncomp == 2
             ? kernel_resources(tcp::dsconv_block_post_bf16<tcp::NT_C>,
                                tcp::THREADS, post, out + 4)
             : kernel_resources(tcp::dsconv_block_post_bf16<tcp::NT_M>,
                                tcp::THREADS, post, out + 4);
}

namespace {

template <class T>
int pair_tc(const T* xc, const T* xm, const tcp::Branch& pc,
            const tcp::Branch& pm, float* yc, float* ym, T* oc, T* om, int B,
            int T_, int F, int cm, int totc, int totm, int d1, int d2,
            cudaStream_t st) {
  if (cm % 4 != 0 || totc % 4 != 0 || totm % 4 != 0 || cm <= 0 ||
      totc <= 0 || totm <= 0 || totc > tcp::N_C || totm > tcp::N_M ||
      misaligned(xc) || misaligned(xm) || misaligned(yc) || misaligned(ym))
    return (int)cudaErrorInvalidValue;
  const long M = (long)B * T_ * F;
  if (M == 0) return 0;
  const unsigned blocks = (unsigned)((M + tcp::TM - 1) / tcp::TM);
  const int pre_smem =
      (tcp::ring_floats(tcp::PRE_STAGES) + 4 * tcp::TM) * (int)sizeof(float);
  const int err = launch_smem(tcp::dsconv_pre_tc<T>, blocks, pre_smem, st,
                              xc, pc, yc, xm, pm, ym, (int)M, cm, totc, totm);
  if (err != 0) return err;
  const int post_smem =
      tcp::post_smem_floats(totc, totm) * (int)sizeof(float);
  return launch_smem(tcp::dsconv_post_tc<T>, blocks, post_smem, st, xc,
                     (const float*)yc, pc, xm, (const float*)ym, pm, oc, om,
                     (int)M, T_, F, cm, totc, totm, d1, d2);
}

}  // namespace

// One conformer stage (se_tpu's `dsconv_pair_block`) on the tensor cores:
// xc (B, T, F, 2cm) and xm (B, T, F, cm) -> oc, om of the same shapes. Each
// branch's 13 pointers in the tuple's order, w1, g1, b1, wd1, wd2 and ws
// packed by ops/dsconv.py `pack_pair_weights`. yc (B, T, F, totc) and ym
// (B, T, F, totm) are scratch for the pre stage. Needs cm, totc and totm
// multiples of 4, totc <= 64, totm <= 32, and xc, xm, yc, ym 16-byte
// aligned.
extern "C" int se_dsconv_pair_tc(
    const float* xc, const float* xm, const float* w1c, const float* g1c,
    const float* b1c, const float* bb1c, const float* ac, const float* wd1c,
    const float* bd1c, const float* wd2c, const float* bd2c,
    const float* g2c, const float* b2c, const float* wsc, const float* bsc,
    const float* w1m, const float* g1m, const float* b1m, const float* bb1m,
    const float* am, const float* wd1m, const float* bd1m, const float* wd2m,
    const float* bd2m, const float* g2m, const float* b2m, const float* wsm,
    const float* bsm, float* yc, float* ym, float* oc, float* om, int B,
    int T, int F, int cm, int totc, int totm, int d1, int d2, void* stream) {
  const tcp::Branch pc{w1c, g1c, b1c, bb1c, ac, wd1c, bd1c,
                       wd2c, bd2c, g2c, b2c, wsc, bsc};
  const tcp::Branch pm{w1m, g1m, b1m, bb1m, am, wd1m, bd1m,
                       wd2m, bd2m, g2m, b2m, wsm, bsm};
  return pair_tc(xc, xm, pc, pm, yc, ym, oc, om, B, T, F, cm, totc, totm, d1,
                 d2, (cudaStream_t)stream);
}

// The stage on bf16 tensor cores (dsconv_pre_bf16, dsconv_post_bf16): xc,
// xm, oc, om bf16; the packed weights (pack_pair_weights' layout, in bf16)
// bf16; the vectors and the scratch yc, ym fp32; otherwise as
// se_dsconv_pair_tc. Needs cm a multiple of 8 (16-byte copies of x),
// totc and totm multiples of 16 (the output GEMM's k16 steps), totc <= 64,
// totm <= 32, and xc, xm, yc, ym 16-byte aligned.
extern "C" int se_dsconv_pair_tc_bf16(
    const bf16* xc, const bf16* xm, const bf16* w1c, const float* g1c,
    const float* b1c, const float* bb1c, const float* ac, const bf16* wd1c,
    const float* bd1c, const bf16* wd2c, const float* bd2c, const float* g2c,
    const float* b2c, const bf16* wsc, const float* bsc, const bf16* w1m,
    const float* g1m, const float* b1m, const float* bb1m, const float* am,
    const bf16* wd1m, const float* bd1m, const bf16* wd2m, const float* bd2m,
    const float* g2m, const float* b2m, const bf16* wsm, const float* bsm,
    float* yc, float* ym, bf16* oc, bf16* om, int B, int T, int F, int cm,
    int totc, int totm, int d1, int d2, void* stream) {
  if (cm % 8 != 0 || totc % 16 != 0 || totm % 16 != 0 || cm <= 0 ||
      totc <= 0 || totm <= 0 || totc > tcp::N_C || totm > tcp::N_M ||
      misaligned(xc) || misaligned(xm) || misaligned(yc) || misaligned(ym))
    return (int)cudaErrorInvalidValue;
  const long M = (long)B * T * F;
  if (M == 0) return 0;
  const tcp::BranchBf pc{w1c, g1c, b1c, bb1c, ac, wd1c, bd1c,
                         wd2c, bd2c, g2c, b2c, wsc, bsc};
  const tcp::BranchBf pm{w1m, g1m, b1m, bb1m, am, wd1m, bd1m,
                         wd2m, bd2m, g2m, b2m, wsm, bsm};
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((M + tcp::TM - 1) / tcp::TM);
  const int err = launch_smem(tcp::dsconv_pre_bf16, blocks,
                              tcp::pre_bf_ring() + 16 * tcp::TM, st, xc, pc,
                              yc, xm, pm, ym, (int)M, cm, totc, totm);
  if (err != 0) return err;
  return launch_smem(tcp::dsconv_post_bf16, blocks,
                     tcp::post_bf_smem(totc, totm), st, xc, (const float*)yc,
                     pc, xm, (const float*)ym, pm, oc, om, (int)M, T, F, cm,
                     totc, totm, d1, d2);
}

// The bf16 stage's resources at (totc, totm) (tc_common.cuh
// kernel_resources): out[0..3] dsconv_pre_bf16's, out[4..7]
// dsconv_post_bf16's.
extern "C" int se_dsconv_pair_tc_bf16_resources(int totc, int totm,
                                                int* out) {
  const int err = kernel_resources(tcp::dsconv_pre_bf16, tcp::THREADS,
                                   tcp::pre_bf_ring() + 16 * tcp::TM, out);
  if (err != 0) return err;
  return kernel_resources(tcp::dsconv_post_bf16, tcp::THREADS,
                          tcp::post_bf_smem(totc, totm), out + 4);
}
