// One Uformer decoder level, both branches, fp32 or bf16: stride-(1, 2) (2, 5)
// transposed conv of the [skip, x] concat in phase-split form -> (BN
// affine -> PReLU when has_bn) for the complex (interleaved [re | im]) and
// the real branch, then `fusion`:
//   yc = [r + s | i + s], ym = g + sigmoid(sqrt(max(r^2 + i^2, eps))),
//   s = sigmoid(g).
// Even output columns 2q come from taps wf0/2/4 over x[q-1..q+1], odd ones
// 2q+1 from wf1/3 over x[q..q+1]; the t-taps are causal (rows t-1 and t),
// so the output keeps the input's T.
//
// Replaces: se_tpu/ops/pallas_decoder.py, `_pallas_level` and its body
// `_kernel` / `_level_math` / `_tconv_phase_split` (entry `decoder_level`).
//
// Bound on the H100: by operations at the deep levels, by bytes at the
// last ones. An input position (b, t, q) yields two output columns at
// 2*10*5*Cc*Cout flops (Cc = the per-component concat width) against
// (3*Cc + 2*3*Cout)*4 bytes read once or written: level 0 (Cc = 256,
// Cout = 128) ~530 flops a byte, level 5 (Cc = 16, Cout = 1) ~7. The
// fp32-accurate tensor-core ridge is ~50 (165 TFLOP/s over 3.35 TB/s).
//
// Two designs; ops/decoder.py `level_design` picks one a level, by shape.
// (Times: chip_smoke.py phase 3, B = 4 x 4 s, NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md.)
//
// decoder_level_tc (Cout >= 8: Uformer's levels 0-4): an implicit GEMM a
// branch on the tensor cores, 3xTF32 mma.sync.m16n8k8 with fp32
// accumulation (tc_common.cuh: the main loop `tc_ring` that csrc/lstm.cu
// runs too; one TF32 pass is off by ~1e-3 relative at K = 3072).
//   - M = B T F input positions; K = 6 taps (t-tap it, f-tap jf: input
//     x[t - 1 + it, q - 1 + jf]) x Cin, each tap's Cin zero-padded to
//     Cinp, a multiple of 32, so a K stage of 32 lies in one tap; N = the
//     even and odd columns of the block's 16 channels. The odd phase sits
//     in the same 6-tap K with zero weights on its jf = 0 tap: one K loop,
//     20% of the products wasted (a second K loop for the odd phase would
//     load A twice).
//   - A is gathered at copy time: a row's stage is 32 consecutive channels
//     of one input position, 16-byte cp.async chunks zero-filled where the
//     tap falls before t = 0, outside [0, F), past Cin or past M. No
//     im2col tensor reaches device memory.
//   - Each K stage sums into a fresh fragment, added to the running sums
//     with fp32 adds: the mma's own accumulation rounds toward zero, and
//     one fragment over all of K = 3072 drifted to 1.4-1.6e-5 of max|out|
//     on the card (3-6e-7 this way, as fp32; ~10% more time).
//   - Weights packed once a model (ops/decoder.py `pack_decoder_weights`),
//     K-major, Cout padded to 16 with zeros. Packed column order: per 8
//     channels, the complex branch's re even, im even, re odd, im odd
//     columns (4 n8 tiles), the real branch's m even, m odd (2 n8 tiles).
//     The mma's accumulator layout then gives the thread that holds (row,
//     channel) of one tile the same (row, channel) of all six: r, i and g
//     of both output columns, so bias, BN, PReLU and the fusion run in
//     registers and the interleaved columns 2q, 2q+1 are written straight
//     into (B, T, 2F, .).
//   - A block: 64 positions x 16 channels, 128 threads in 2 x 2 warps of
//     32 positions x 8 channels. The complex K loop (K = 6 Cinp_c, 64
//     packed columns), then the real one (K = 6 Cinp_m, 32 columns),
//     through the same 3-stage cp.async ring (rows padded to 36 floats:
//     conflict-free ldmatrix), 55 KB of shared memory and at most 128
//     registers (127, no spills), four blocks an SM: 5-8% faster at
//     levels 0-3 than three blocks at 139 registers. A 1-D grid, channel
//     tiles fastest: the blocks of a row tile run together and read its
//     taps from L2.
//   - Level 4 (Cout 8) fills half of each block's channels and still ran
//     2.3-2.6x faster here than on the CUDA cores.
//
// decoder_level_cc (Cout < 8: level 5, Cout 1, bounded by bytes at ~7
// flops a byte): one thread a position computes both output columns of
// all three outputs, CO channels a pass. A block stages the level's
// weights once (3.2 KB at level 5), then walks chunks of 128 positions:
// the chunk's input rows, positions p0 - F - 1 .. p0 + 128 of [xc | xm]
// (both row-contiguous, so one coalesced run each), go to shared memory
// at a stride of 3 Cc + 1 floats (lanes on consecutive rows hit distinct
// banks), and every tap reads them there; weights are warp-wide
// broadcasts. The grid is one wave of resident blocks.
//
// bf16 (`se_decoder_level_tc_bf16`, `se_decoder_level_cc_bf16`): xc, xm
// (the skip concat of bf16 tensors), yc and ym in bf16, the TPU kernel's
// rounding points (pallas_decoder.py:101-113): every sum, the bias, the BN
// affine, PReLU and the fusion fp32, the two outputs rounded once; the
// tail vectors fp32.
//   - decoder_level_tc_bf16 (levels 0-4): decoder_level_tc's tile, grid,
//     K and column order and epilogue on bf16 tensor cores, bound by
//     operations at 989 TFLOP/s. mma.sync.m16n8k16 bf16 with fp32
//     accumulation, one product a k16 (bf16 times bf16 is exact in fp32),
//     a fresh fragment a K stage of 32 as above (m16n8k16's accumulator
//     layout is m16n8k8's: the epilogue is unchanged). The fp32 design
//     templated on bf16 storage would stage A by synchronous widening
//     loads, so its ring would overlap only B's copies, keep B in fp32
//     (twice the bytes through L2 and shared memory) and run a TF32 k8
//     instruction for every 8 of K. Here the packs stay bf16
//     (pack_decoder_weights), and A (gathered at copy time in 16-byte
//     chunks of 8 channels: Cin a multiple of 8, zero-filled as above)
//     and B pass through a bf16 cp.async ring (tc_common.cuh bfr::ring)
//     of 8 KB stages, rows unpadded and swizzled (bfr::swz16:
//     conflict-free ldmatrix). Four
//     stages (32 KB) and at most 96 registers (no spills): five blocks an
//     SM. Levels 0-5 at B = 32 took 4.62-4.65 ms so (five stages: 4.60),
//     4.79 at six blocks of three stages (80 registers, spills) and 5.00
//     at four blocks of six (bf16_ring_sweep.py decoder, NVIDIA H100
//     80GB HBM3, 700 W; PERF.md).
//   - decoder_level_cc<.., bf16> (level 5) is the fp32 design on the
//     storage: weights as they are in fp32 holding bf16 values, the input
//     tile widened as it is staged.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"
#include "unet_common.cuh"

namespace {

// ------------------------------------------------ tensor cores (3xTF32)

constexpr int TM = 64;        // positions a block
constexpr int CT = 16;        // output channels a block
constexpr int TK = 32;        // K a stage
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int LDS = TK + 4;   // shared row stride in floats
constexpr int WM = TM / 32;   // warps down the positions
constexpr int WN = CT / 8;    // warps across the channels
constexpr int TC_THREADS = 32 * WM * WN;
constexpr int NT_C = 4;       // n8 tiles a warp, complex: re, im x even, odd
constexpr int NT_M = 2;       // real: even, odd
constexpr int TC_SMEM =
    STAGES * (TM + WN * NT_C * 8) * LDS * (int)sizeof(float);

// acc[m tile][n8 tile][fragment] += A . w^T over one branch: A's row r is
// the 6 taps of position r0 + r of x (M, Cin) = (B, T, F, Cin), each
// zero-padded to Cinp; w (ncols, 6 Cinp) packed, the block's columns from
// col0 on, NT n8 tiles a warp. T: x's storage.
template <int NT, class T>
__device__ __forceinline__ void branch_loop(float (&acc)[2][NT][4],
                                            float* sm,
                                            const T* __restrict__ x,
                                            const float* __restrict__ w,
                                            int M, int Tn, int F, int cin,
                                            int cinp, int r0, int col0) {
  constexpr int NB_COLS = WN * NT * 8;  // packed columns a block
  float* As = sm;                       // STAGES x TM x LDS
  float* Bs = sm + STAGES * TM * LDS;   // STAGES x NB_COLS x LDS
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int kp = 6 * cinp, nk = kp / TK;
  constexpr int CH = TK / 4, RSTEP = TC_THREADS / CH;  // 8 chunks a row
  constexpr int NA = TM / RSTEP, NB = NB_COLS / RSTEP;
  const int crow = tid / CH, cq = tid % CH;
  const float* wq = w + ((size_t)col0 + crow) * kp + 4 * cq;
  // the thread's A rows: position, and which taps fall outside the input
  int pos[NA];
  bool live[NA], t0[NA], qlo[NA], qhi[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int p = r0 + crow + i * RSTEP;
    const int q = p % F;
    live[i] = p < M;
    pos[i] = p;
    t0[i] = (p / F) % Tn == 0;
    qlo[i] = q == 0;
    qhi[i] = q == F - 1;
  }

  auto load_stage = [&](int kt, int slot) {
    const int k0 = kt * TK, tap = k0 / cinp;
    const int ci = k0 - tap * cinp + 4 * cq;
    const int it = tap / 3, jf = tap % 3;
    const long shift = (long)(it - 1) * F + (jf - 1);
    float* bs = Bs + slot * NB_COLS * LDS + crow * LDS + 4 * cq;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      cp_async16(bs + i * RSTEP * LDS, wq + (size_t)i * RSTEP * kp + k0, 16);
    float* as = As + slot * TM * LDS + crow * LDS + 4 * cq;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const bool in = live[i] && ci < cin && !(it == 0 && t0[i]) &&
                      !(jf == 0 && qlo[i]) && !(jf == 2 && qhi[i]);
      // outside: nothing read from a valid address, zeros stored
      copy4(as + i * RSTEP * LDS,
            in ? x + (size_t)(pos[i] + shift) * cin + ci : x, in);
    }
  };

  tc_ring<TM, NB_COLS, TK, LDS, STAGES, NT, true, passes_for<T>()>(
      acc, As, Bs, nk, wm * 32, wn * NT * 8, load_stage);
  __syncthreads();  // every warp is done with the ring before it is reused
}

template <class T>
__global__ void __launch_bounds__(TC_THREADS, 4)
decoder_level_tc(const T* __restrict__ xc, const T* __restrict__ xm,
                 const float* __restrict__ wcp, const float* __restrict__ wmp,
                 Tail P, T* __restrict__ yc, T* __restrict__ ym,
                 int M, int Tn, int F, int cc, int cout, int cinp_c,
                 int cinp_m, int has_bn) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tq = lane & 3;  // the mma's group and thread
  const int nct = (cout + CT - 1) / CT;
  const int ct = blockIdx.x % nct, r0 = (blockIdx.x / nct) * TM;
  float acc_c[2][NT_C][4], acc_m[2][NT_M][4];
  branch_loop<NT_C>(acc_c, sm, xc, wcp, M, Tn, F, 2 * cc, cinp_c, r0,
                    ct * WN * NT_C * 8);
  branch_loop<NT_M>(acc_m, sm, xm, wmp, M, Tn, F, cc, cinp_m, r0,
                    ct * WN * NT_M * 8);

  // acc[mi][tile][hh * 2 + cc]: position row gid + 8 hh of m tile mi,
  // channel 2 tq + cc of the warp's 8; tiles re, im (complex) and m (real)
  // of the even (ph = 0) and odd (ph = 1) column
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = r0 + wm * 32 + mi * 16 + hh * 8 + gid;
      if (p >= M) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = ct * CT + wn * 8 + 2 * tq + j;
        if (c >= cout) continue;
        const int f = hh * 2 + j;
#pragma unroll
        for (int ph = 0; ph < 2; ++ph)
          level_out(P, acc_c[mi][2 * ph][f], acc_c[mi][2 * ph + 1][f],
                    acc_m[mi][ph][f], (size_t)p * 2 + ph, c, cout,
                    has_bn != 0, yc, ym);
      }
    }
}

// ------------------------------------------- tensor cores, bf16 (k16)

using bf16 = __nv_bfloat16;
constexpr int BF_STAGES = 4;   // cp.async ring depth: 4 x 8 KB ...
constexpr int BF_BLOCKS = 5;   // ... five blocks an SM (96 registers)
constexpr int BF_SMEM = BF_STAGES * (TM + WN * NT_C * 8) * bfr::BK * 2;

// acc[m tile][n8 tile][fragment] = A . w^T over one branch, as branch_loop
// on bf16 tensor cores: x (M, Cin) bf16, Cin a multiple of 8; w (ncols, 6
// Cinp) bf16 packed. A stage is 32 channels of one tap: 4 16-byte chunks a
// row, zero-filled by the copy where branch_loop zero-fills.
template <int NT>
__device__ __forceinline__ void branch_loop_bf16(
    float (&acc)[2][NT][4], unsigned char* sm, const bf16* __restrict__ x,
    const bf16* __restrict__ w, int M, int Tn, int F, int cin, int cinp,
    int r0, int col0) {
  constexpr int NB_COLS = WN * NT * 8;  // packed columns a block
  constexpr int NA = TM / 32, NB = NB_COLS / 32;  // rows a thread copies
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int kp = 6 * cinp, nk = kp / bfr::BK;
  const int crow = tid >> 2, cq = tid & 3, dst = bfr::swz16(crow, cq);
  const bf16* wq = w + ((size_t)col0 + crow) * kp + 8 * cq;
  int pos[NA];
  bool live[NA], t0[NA], qlo[NA], qhi[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int p = r0 + crow + 32 * i;
    const int q = p % F;
    live[i] = p < M;
    pos[i] = p;
    t0[i] = (p / F) % Tn == 0;
    qlo[i] = q == 0;
    qhi[i] = q == F - 1;
  }
  auto load = [&](int kt, bf16* as, bf16* bs) {
    const int k0 = kt * bfr::BK, tap = k0 / cinp;
    const int ci = k0 - tap * cinp + 8 * cq;
    const int it = tap / 3, jf = tap % 3;
    const long shift = (long)(it - 1) * F + (jf - 1);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      cp_async16(bs + dst + 32 * i * bfr::BK, wq + (size_t)32 * i * kp + k0,
                 16);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const bool in = live[i] && ci < cin && !(it == 0 && t0[i]) &&
                      !(jf == 0 && qlo[i]) && !(jf == 2 && qhi[i]);
      // outside: nothing read from a valid address, zeros stored
      cp_async16(as + dst + 32 * i * bfr::BK,
                 in ? x + (size_t)(pos[i] + shift) * cin + ci : x,
                 in ? 16 : 0);
    }
  };
  int a_ld[2];
  bfr::a_lanes(wm * 32, a_ld);
  auto frag = [&](int p, int, const bf16* as, uint32_t (&a)[1][2][4]) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_x4(a[0][mi], as + a_ld[p] + 16 * mi * bfr::BK);
  };
  bfr::ring<TM, NB_COLS, BF_STAGES, NT, 1, bf16>(acc, sm, nk, wn * NT * 8,
                                                 load, frag);
  __syncthreads();  // every warp is done with the ring before it is reused
}

// decoder_level_tc's tile, grid and epilogue on bf16 tensor cores: xc, xm,
// the packed weights, yc and ym bf16; every sum and the epilogue fp32.
__global__ void __launch_bounds__(TC_THREADS, BF_BLOCKS)
decoder_level_tc_bf16(const bf16* __restrict__ xc, const bf16* __restrict__ xm,
                      const bf16* __restrict__ wcp,
                      const bf16* __restrict__ wmp, Tail P,
                      bf16* __restrict__ yc, bf16* __restrict__ ym, int M,
                      int Tn, int F, int cc, int cout, int cinp_c, int cinp_m,
                      int has_bn) {
  extern __shared__ __align__(16) unsigned char smb[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tq = lane & 3;
  const int nct = (cout + CT - 1) / CT;
  const int ct = blockIdx.x % nct, r0 = (blockIdx.x / nct) * TM;
  float acc_c[2][NT_C][4], acc_m[2][NT_M][4];
  branch_loop_bf16<NT_C>(acc_c, smb, xc, wcp, M, Tn, F, 2 * cc, cinp_c, r0,
                         ct * WN * NT_C * 8);
  branch_loop_bf16<NT_M>(acc_m, smb, xm, wmp, M, Tn, F, cc, cinp_m, r0,
                         ct * WN * NT_M * 8);
  // the fragment layout of m16n8k16's accumulator is m16n8k8's: as
  // decoder_level_tc
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = r0 + wm * 32 + mi * 16 + hh * 8 + gid;
      if (p >= M) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = ct * CT + wn * 8 + 2 * tq + j;
        if (c >= cout) continue;
        const int f = hh * 2 + j;
#pragma unroll
        for (int ph = 0; ph < 2; ++ph)
          level_out(P, acc_c[mi][2 * ph][f], acc_c[mi][2 * ph + 1][f],
                    acc_m[mi][ph][f], (size_t)p * 2 + ph, c, cout,
                    has_bn != 0, yc, ym);
      }
    }
}

// -------------------------------------------------- CUDA cores, narrow

constexpr int CC_THREADS = 128;  // positions a block pass, one a thread

// Floats of decoder_level_cc's shared memory: the staged weights, 10 taps
// (6 even, 4 odd) x (2 Cc x [re | im] + Cc) x coutp, then the input tile:
// the rows of positions p0 - F - 1 .. p0 + CC_THREADS, [xc | xm] each, at
// a stride of 3 Cc + 1 (odd for even Cc: lanes on consecutive rows hit
// distinct banks).
inline size_t cc_smem_floats(int cc, int coutp, int F) {
  return (size_t)50 * cc * coutp +
         (size_t)(CC_THREADS + F + 2) * (3 * cc + 1);
}

// Accumulate one input row (shared) through an even tap te and, if to >=
// 0, an odd tap: w (10, cin, parts, coutp), parts = 2 (re, im) or 1.
template <int CO, int PARTS>
__device__ __forceinline__ void row_accum(const float* xr, const float* w,
                                          int cin, int coutp, int c0, int te,
                                          int to, float (&acc)[2][PARTS][CO]) {
  const size_t tap = (size_t)cin * PARTS * coutp;
  const float* we = w + te * tap + c0;
  if (to < 0) {
    for (int ci = 0; ci < cin; ++ci) {
      const float xv = xr[ci];
      const float* wr = we + (size_t)ci * PARTS * coutp;
#pragma unroll
      for (int p = 0; p < PARTS; ++p)
#pragma unroll
        for (int j = 0; j < CO; ++j)
          acc[0][p][j] = fmaf(xv, wr[p * coutp + j], acc[0][p][j]);
    }
  } else {
    const float* wo = w + to * tap + c0;
    for (int ci = 0; ci < cin; ++ci) {
      const float xv = xr[ci];
      const size_t o = (size_t)ci * PARTS * coutp;
#pragma unroll
      for (int p = 0; p < PARTS; ++p)
#pragma unroll
        for (int j = 0; j < CO; ++j) {
          acc[0][p][j] = fmaf(xv, we[o + p * coutp + j], acc[0][p][j]);
          acc[1][p][j] = fmaf(xv, wo[o + p * coutp + j], acc[1][p][j]);
        }
    }
  }
}

template <int CO, class T>
__global__ void __launch_bounds__(CC_THREADS)
decoder_level_cc(const T* __restrict__ xc, const T* __restrict__ xm,
                 const float* __restrict__ wce, const float* __restrict__ wco,
                 const float* __restrict__ wme, const float* __restrict__ wmo,
                 Tail P, T* __restrict__ yc, T* __restrict__ ym,
                 int M, int Tn, int F, int cc, int cout, int has_bn) {
  extern __shared__ __align__(16) float ws[];
  const int coutp = (cout + CO - 1) / CO * CO, c2 = 2 * cc, ld = 3 * cc + 1;
  float* wc = ws;                                  // (10, 2 Cc, 2, coutp)
  float* wm = ws + (size_t)40 * cc * coutp;        // (10, Cc, 1, coutp)
  float* tile = ws + (size_t)50 * cc * coutp;      // rows x ld
  const int tid = threadIdx.x, rows = CC_THREADS + F + 2;
  for (int e = tid; e < 40 * cc * coutp; e += CC_THREADS) {
    const int c = e % coutp, part = (e / coutp) % 2, ci = (e / coutp / 2) % c2;
    const int tap = e / coutp / 2 / c2;
    float v = 0.f;
    if (c < cout) {
      const float* src = tap < 6 ? wce + (size_t)tap * c2 * 2 * cout
                                 : wco + (size_t)(tap - 6) * c2 * 2 * cout;
      v = src[(size_t)ci * 2 * cout + part * cout + c];
    }
    wc[e] = v;
  }
  for (int e = tid; e < 10 * cc * coutp; e += CC_THREADS) {
    const int c = e % coutp, ci = (e / coutp) % cc, tap = e / coutp / cc;
    float v = 0.f;
    if (c < cout) {
      const float* src = tap < 6 ? wme + (size_t)tap * cc * cout
                                 : wmo + (size_t)(tap - 6) * cc * cout;
      v = src[(size_t)ci * cout + c];
    }
    wm[e] = v;
  }

  for (long p0 = (long)blockIdx.x * CC_THREADS; p0 < M;
       p0 += (long)gridDim.x * CC_THREADS) {
    __syncthreads();  // the weights are staged; the last tile is consumed
    // the tile: position g0 + r at row r, zeros outside [0, M); both
    // inputs are row-contiguous, so each copy is one coalesced run
    const long g0 = p0 - F - 1;
    for (int e = tid; e < rows * c2; e += CC_THREADS) {
      const long gp = g0 + e / c2;
      tile[(e / c2) * ld + e % c2] =
          gp >= 0 && gp < M ? ldg_f(xc + g0 * c2 + e) : 0.f;
    }
    for (int e = tid; e < rows * cc; e += CC_THREADS) {
      const long gp = g0 + e / cc;
      tile[(e / cc) * ld + c2 + e % cc] =
          gp >= 0 && gp < M ? ldg_f(xm + g0 * cc + e) : 0.f;
    }
    __syncthreads();
    const long p = p0 + tid;
    if (p >= M) continue;
    const int q = (int)(p % F);
    const bool first_row = (p / F) % Tn == 0;
    for (int c0 = 0; c0 < coutp; c0 += CO) {
      float accc[2][2][CO], accm[2][1][CO];
#pragma unroll
      for (int ph = 0; ph < 2; ++ph)
#pragma unroll
        for (int j = 0; j < CO; ++j)
          accc[ph][0][j] = accc[ph][1][j] = accm[ph][0][j] = 0.f;
      for (int it = 0; it < 2; ++it) {
        if (it == 0 && first_row) continue;  // row t - 1 before the start
        for (int jf = 0; jf < 3; ++jf) {
          const int ff = q + jf - 1;
          if (ff < 0 || ff >= F) continue;
          // the tap's position p + (it - 1) F + jf - 1 is tile row
          // tid + it F + jf; even tap it * 3 + jf, odd taps 6 + it * 2 +
          // jf - 1 for jf >= 1
          const float* xr = tile + (size_t)(tid + it * F + jf) * ld;
          const int te = it * 3 + jf, to = jf >= 1 ? 6 + it * 2 + jf - 1 : -1;
          row_accum<CO, 2>(xr, wc, c2, coutp, c0, te, to, accc);
          row_accum<CO, 1>(xr + c2, wm, cc, coutp, c0, te, to, accm);
        }
      }
#pragma unroll
      for (int ph = 0; ph < 2; ++ph)
#pragma unroll
        for (int j = 0; j < CO; ++j)
          if (c0 + j < cout)
            level_out(P, accc[ph][0][j], accc[ph][1][j], accm[ph][0][j],
                      (size_t)p * 2 + ph, c0 + j, cout, has_bn != 0, yc, ym);
    }
  }
}

template <int CO, class T>
int run_cc(const T* xc, const T* xm, const float* wce, const float* wco,
           const float* wme, const float* wmo, const Tail& P, T* yc, T* ym,
           int M, int Tn, int F, int cc, int cout, int has_bn,
           cudaStream_t st) {
  const int coutp = (cout + CO - 1) / CO * CO;
  const size_t smem = cc_smem_floats(cc, coutp, F) * sizeof(float);
  auto kernel = decoder_level_cc<CO, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        CC_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const long need = ((long)M + CC_THREADS - 1) / CC_THREADS;
  const long wave = (long)sms * per_sm;
  const unsigned blocks = (unsigned)(need < wave ? need : wave);
  kernel<<<blocks, CC_THREADS, smem, st>>>(xc, xm, wce, wco, wme, wmo, P, yc,
                                          ym, M, Tn, F, cc, cout, has_bn);
  return (int)cudaGetLastError();
}

template <class T>
int level_tc(const T* xc, const T* xm, const float* wcp, const float* wmp,
             const float* bc, const float* sc, const float* tc,
             const float* ac, const float* bm, const float* sm,
             const float* tm, const float* am, T* yc, T* ym, int B, int Tn,
             int F, int cc, int cout, int cinp_c, int cinp_m, int has_bn,
             cudaStream_t st) {
  if (cc % 4 != 0 || cinp_c % TK != 0 || cinp_c < 2 * cc ||
      cinp_m % TK != 0 || cinp_m < cc ||
      reinterpret_cast<uintptr_t>(xc) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xm) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long M = (long)B * Tn * F;
  if (M == 0) return 0;
  auto kernel = decoder_level_tc<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((cout + CT - 1) / CT) * ((M + TM - 1) / TM);
  const Tail P{bc, sc, tc, ac, bm, sm, tm, am};
  kernel<<<(unsigned)blocks, TC_THREADS, TC_SMEM, st>>>(
      xc, xm, wcp, wmp, P, yc, ym, (int)M, Tn, F, cc, cout, cinp_c, cinp_m,
      has_bn);
  return (int)cudaGetLastError();
}

template <class T>
int level_cc(const T* xc, const T* xm, const float* wce, const float* wco,
             const float* bc, const float* sc, const float* tc,
             const float* ac, const float* wme, const float* wmo,
             const float* bm, const float* sm, const float* tm,
             const float* am, T* yc, T* ym, int B, int Tn, int F, int cc,
             int cout, int has_bn, cudaStream_t st) {
  const long M = (long)B * Tn * F;
  if (M == 0) return 0;
  const Tail P{bc, sc, tc, ac, bm, sm, tm, am};
  if (cout >= 8)
    return run_cc<8>(xc, xm, wce, wco, wme, wmo, P, yc, ym, (int)M, Tn, F, cc,
                     cout, has_bn, st);
  if (cout >= 4)
    return run_cc<4>(xc, xm, wce, wco, wme, wmo, P, yc, ym, (int)M, Tn, F, cc,
                     cout, has_bn, st);
  if (cout >= 2)
    return run_cc<2>(xc, xm, wce, wco, wme, wmo, P, yc, ym, (int)M, Tn, F, cc,
                     cout, has_bn, st);
  return run_cc<1>(xc, xm, wce, wco, wme, wmo, P, yc, ym, (int)M, Tn, F, cc,
                   cout, has_bn, st);
}

}  // namespace

// The tensor-core design. xc (B, T, F, 2cc), xm (B, T, F, cc) -> yc (B, T,
// 2F, 2cout), ym (B, T, 2F, cout). wcp / wmp: pack_decoder_weights' packed
// complex (4 coutp, 6 cinp_c) and real (2 coutp, 6 cinp_m) weights, coutp
// = cout rounded up to 16, cinp_c / cinp_m = 2cc / cc rounded up to 32;
// the tail vectors as the 12-tuple's (ops/decoder.py). Needs cc % 4 == 0
// and xc, xm 16-byte aligned.
extern "C" int se_decoder_level_tc(
    const float* xc, const float* xm, const float* wcp, const float* wmp,
    const float* bc, const float* sc, const float* tc, const float* ac,
    const float* bm, const float* sm, const float* tm, const float* am,
    float* yc, float* ym, int B, int T, int F, int cc, int cout, int cinp_c,
    int cinp_m, int has_bn, void* stream) {
  return level_tc(xc, xm, wcp, wmp, bc, sc, tc, ac, bm, sm, tm, am, yc, ym,
                  B, T, F, cc, cout, cinp_c, cinp_m, has_bn,
                  (cudaStream_t)stream);
}

// The CUDA-core design, the 12-tuple's weights as they are: wce (6, 2cc,
// 2cout), wco (4, 2cc, 2cout), wme (6, cc, cout), wmo (4, cc, cout).
// Needs its shared memory (cc_smem_floats: the staged weights, coutp =
// cout rounded up to the channels a pass, 1, 2, 4 or 8, and the input
// tile) to fit a block.
extern "C" int se_decoder_level_cc(
    const float* xc, const float* xm, const float* wce, const float* wco,
    const float* bc, const float* sc, const float* tc, const float* ac,
    const float* wme, const float* wmo, const float* bm, const float* sm,
    const float* tm, const float* am, float* yc, float* ym, int B, int T,
    int F, int cc, int cout, int has_bn, void* stream) {
  return level_cc(xc, xm, wce, wco, bc, sc, tc, ac, wme, wmo, bm, sm, tm, am,
                  yc, ym, B, T, F, cc, cout, has_bn, (cudaStream_t)stream);
}

// The tensor-core design in bf16 (decoder_level_tc_bf16): xc, xm, the
// packed weights (pack_decoder_weights' layout, in bf16), yc and ym bf16;
// the tail vectors fp32; otherwise as se_decoder_level_tc. Needs cc % 8 ==
// 0 (16-byte copies of 8 channels) and xc, xm 16-byte aligned.
extern "C" int se_decoder_level_tc_bf16(
    const bf16* xc, const bf16* xm, const bf16* wcp, const bf16* wmp,
    const float* bc, const float* sc, const float* tc, const float* ac,
    const float* bm, const float* sm, const float* tm, const float* am,
    bf16* yc, bf16* ym, int B, int T, int F, int cc, int cout, int cinp_c,
    int cinp_m, int has_bn, void* stream) {
  if (cc % 8 != 0 || cinp_c % bfr::BK != 0 || cinp_c < 2 * cc ||
      cinp_m % bfr::BK != 0 || cinp_m < cc ||
      reinterpret_cast<uintptr_t>(xc) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xm) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long M = (long)B * T * F;
  if (M == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      decoder_level_tc_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BF_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((cout + CT - 1) / CT) * ((M + TM - 1) / TM);
  const Tail P{bc, sc, tc, ac, bm, sm, tm, am};
  decoder_level_tc_bf16<<<(unsigned)blocks, TC_THREADS, BF_SMEM,
                          (cudaStream_t)stream>>>(
      xc, xm, wcp, wmp, P, yc, ym, (int)M, T, F, cc, cout, cinp_c, cinp_m,
      has_bn);
  return (int)cudaGetLastError();
}

// decoder_level_tc_bf16's resources (tc_common.cuh kernel_resources).
extern "C" int se_decoder_level_tc_bf16_resources(int* out) {
  return kernel_resources(decoder_level_tc_bf16, TC_THREADS, BF_SMEM, out);
}

// The CUDA-core design in bf16: xc, xm, yc, ym bf16; the weights (fp32
// holding bf16 values) and the tail vectors fp32; otherwise as above.
extern "C" int se_decoder_level_cc_bf16(
    const __nv_bfloat16* xc, const __nv_bfloat16* xm, const float* wce,
    const float* wco, const float* bc, const float* sc, const float* tc,
    const float* ac, const float* wme, const float* wmo, const float* bm,
    const float* sm, const float* tm, const float* am, __nv_bfloat16* yc,
    __nv_bfloat16* ym, int B, int T, int F, int cc, int cout, int has_bn,
    void* stream) {
  return level_cc(xc, xm, wce, wco, bc, sc, tc, ac, wme, wmo, bm, sm, tm, am,
                  yc, ym, B, T, F, cc, cout, has_bn, (cudaStream_t)stream);
}
