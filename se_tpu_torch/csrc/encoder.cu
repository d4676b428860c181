// One Uformer encoder level, both branches, fp32 or bf16: stride-(1, 2) (2, 5)
// conv (T pad (1, 0) causal, F pad (2, 2)) -> BN affine -> PReLU for the
// complex (interleaved [re | im]) and the real branch, then `fusion`.
//
// Replaces: se_tpu/ops/pallas_encoder.py, `_pallas_level` and its body
// `_kernel` / `_level_math` / `_conv_stride2` (entry `encoder_level`).
//
// Bound on the H100: by operations at the deep levels, by bytes at the
// shallow ones. An output position (b, t, f_out) costs 2*10*5*Cin*Cout
// flops against (2*3*Cin + 3*Cout)*4 bytes of activations read once or
// written: level 0 (Cin = 1, Cout = 8) ~7 flops a byte, level 5 (Cin =
// Cout = 128) ~360. The fp32-accurate tensor-core ridge is ~50 (165
// TFLOP/s over 3.35 TB/s).
//
// The TPU kernel read the stride-2 F taps through a parity view, because
// the TPU has no cheap strided loads. The card needs none: output position
// p = (b, t, fo) reads input row 2p + (it - 1) F + jf - 2 at tap (it, jf),
// it in {0, 1}, jf in 0..4 (F even, so (b, t, 2 fo) is row 2p).
//
// Two designs; ops/encoder.py `level_design` picks one a level, by shape.
//
// encoder_level_tc (Cin % 4 == 0: Uformer's levels 1-5): an implicit GEMM
// a branch on the tensor cores, 3xTF32 mma.sync.m16n8k8 with fp32
// accumulation (tc_common.cuh `tc_ring`, the decoder's main loop).
//   - M = B T F/2 output positions; K = 10 taps x Cinp, each tap's Cin
//     zero-padded to Cinp, a multiple of 32, so a K stage of 32 lies in
//     one tap; N = the re and im columns (complex) or m columns (real) of
//     the block's 32 channels.
//   - A is gathered at copy time: a row's stage is 32 consecutive channels
//     of one input row, 16-byte cp.async chunks zero-filled where the tap
//     falls before t = 0, outside [0, F), past Cin or past M (4-byte
//     copies where Cin % 4 != 0, so every level runs on either design). No
//     im2col tensor reaches device memory.
//   - Each K stage sums into a fresh fragment added to the running sums
//     by fp32 adds (the mma's accumulation rounds toward zero and drifts
//     over level 5's K = 2560).
//   - Weights packed once a model (ops/encoder.py `pack_encoder_weights`),
//     K-major, Cout padded to 32 with zeros. Packed column order: per 8
//     channels, the complex branch's re tile, then its im tile; the real
//     branch's m tile in its own matrix. The thread that holds (position,
//     channel c) of one n8 tile holds re c, im c and m c, so bias, BN,
//     PReLU and the fusion run in registers (unet_common.cuh `level_out`)
//     and yc[., c], yc[., Cout + c] and ym[., c] are written once.
//   - A block: 64 positions x 32 channels, 128 threads in 2 x 2 warps of
//     32 positions x 16 channels (4 complex and 2 real n8 tiles a warp,
//     the decoder's register budget). The complex K loop, then the real
//     one, through one 3-stage cp.async ring (rows padded to 36 floats:
//     conflict-free ldmatrix), 55 KB of shared memory. A 1-D grid, channel
//     tiles fastest: the blocks of a row tile run together and read its
//     taps from L2.
//
// encoder_level_cc (level 0: Cin 1, Cout 8, bounded by bytes at ~7 flops a
// byte): one thread an output position computes all three outputs of 8
// channels a pass (Cout padded to 8 with zero weights). A block stages the level's weights once (50 Cin Coutp
// floats: 1.6 KB at level 0), then walks chunks of 128 positions: the
// chunk's input rows 2 p0 - F - 2 .. 2 p0 + 256 of [xc | xm] (both
// row-contiguous, so one coalesced run each) go to shared memory at an odd
// stride (two lanes a bank: lanes read rows two apart), and every tap
// reads them there; weights are warp-wide broadcasts. The grid is one wave
// of resident blocks.
//
// bf16 (`se_encoder_level_tc_bf16`, `se_encoder_level_cc_bf16`): xc, xm,
// yc and ym in bf16, the TPU kernel's rounding points
// (pallas_encoder.py:91-94): the input and the weights are bf16 values,
// every sum, the bias, the BN affine, PReLU and the fusion fp32, the two
// outputs rounded once; the tail vectors fp32.
//   - encoder_level_tc_bf16 (Cin % 8 == 0: Uformer's levels 1-5):
//     encoder_level_tc's tile, grid, K order and packed column order and
//     epilogue on bf16 tensor cores (989 TFLOP/s: bound by operations at
//     the deep levels, by bytes at the shallow ones). mma.sync.m16n8k16
//     bf16 with fp32 accumulation, one product a k16 (bf16 times bf16 is
//     exact in fp32), a fresh fragment a K stage of 32 joined by fp32 adds
//     (level 5's K = 2560; m16n8k16's accumulator layout is m16n8k8's: the
//     epilogue is unchanged). The fp32 design templated on bf16 storage staged A by
//     synchronous 8-byte widening loads, so its ring overlapped only B's
//     copies, kept B in fp32 (twice the bytes through L2 and shared
//     memory) and ran a TF32 k8 instruction for every 8 of K. Here the
//     packs stay bf16 (pack_encoder_weights), and A (gathered at copy time
//     in 16-byte chunks of 8 channels of one input row, zero-filled where
//     the tap falls before t = 0, outside [0, F), past Cin or past M) and
//     B pass through the decoder's bf16 cp.async ring (tc_common.cuh
//     bfr::ring) of 8 KB stages, rows unpadded and swizzled (bfr::swz16:
//     conflict-free ldmatrix). ENC_BF_STAGES stages, ENC_BF_BLOCKS blocks
//     an SM: chosen by bf16_ring_sweep.py encoder (PERF.md).
//   - A bf16 level whose Cin is a multiple of 4 but not of 8 runs
//     encoder_level_tc on the inputs widened to fp32 and rounds its outputs
//     once (ops/encoder.py `level_design`, "tc_widened"): the same
//     rounding points.
//   - encoder_level_cc<bf16> (level 0, Cin 1) is the fp32 design on the
//     storage: weights as they are in fp32 holding bf16 values, the input
//     tile widened as it is staged (tc_common.cuh `ldg_f`); bound by
//     bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"
#include "unet_common.cuh"

namespace {

// ------------------------------------------------ tensor cores (3xTF32)

constexpr int TM = 64;        // positions a block
constexpr int CT = 32;        // output channels a block
constexpr int TK = 32;        // K a stage
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int LDS = TK + 4;   // shared row stride in floats
constexpr int WM = 2;         // warps down the positions
constexpr int WN = 2;         // warps across the channels
constexpr int TC_THREADS = 32 * WM * WN;
constexpr int NT_C = 4;       // n8 tiles a warp, complex: re, im x 2 x 8 ch
constexpr int NT_M = 2;       // real: 2 x 8 channels
constexpr int TAPS = 10;
constexpr int TC_SMEM =
    STAGES * (TM + WN * NT_C * 8) * LDS * (int)sizeof(float);

// acc[m tile][n8 tile][fragment] = A . w^T over one branch: A's row r is
// the 10 taps of output position r0 + r over x (B T F, cin), each
// zero-padded to cinp; w (ncols, 10 cinp) packed, the block's columns from
// col0 on, NT n8 tiles a warp. VEC: copies of 4 channels (cin % 4 == 0),
// else of one. T: x's storage.
template <int NT, bool VEC, class T>
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
  const int kp = TAPS * cinp, nk = kp / TK;
  constexpr int CH = TK / 4, RSTEP = TC_THREADS / CH;  // 8 chunks a row
  constexpr int NA = TM / RSTEP, NB = NB_COLS / RSTEP;
  const int crow = tid / CH, cq = tid % CH;
  const float* wq = w + ((size_t)col0 + crow) * kp + 4 * cq;
  // the thread's A rows: input row 2p of (t, 2 fo), and a bit a tap that
  // lands inside the input (none past M)
  long base[NA];
  unsigned inside[NA];
  const int fo_n = F / 2;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int p = r0 + crow + i * RSTEP;
    base[i] = 2L * p;
    unsigned bits = 0;
    if (p < M) {
      const int fo = p % fo_n, t = (p / fo_n) % Tn;
#pragma unroll
      for (int tap = 0; tap < TAPS; ++tap) {
        const int it = tap / 5, ff = 2 * fo + tap % 5 - 2;
        if ((it == 1 || t > 0) && ff >= 0 && ff < F) bits |= 1u << tap;
      }
    }
    inside[i] = bits;
  }

  auto load_stage = [&](int kt, int slot) {
    const int k0 = kt * TK, tap = k0 / cinp;
    const int ci = k0 - tap * cinp + 4 * cq;
    const long shift = (long)(tap / 5 - 1) * F + (tap % 5 - 2);
    float* bs = Bs + slot * NB_COLS * LDS + crow * LDS + 4 * cq;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      cp_async16(bs + i * RSTEP * LDS, wq + (size_t)i * RSTEP * kp + k0, 16);
    float* as = As + slot * TM * LDS + crow * LDS + 4 * cq;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const bool in = (inside[i] >> tap) & 1u;
      const T* src = x + (size_t)(base[i] + shift) * cin + ci;
      if (VEC) {
        // outside: nothing read from a valid address, zeros stored
        const bool ok = in && ci < cin;
        copy4(as + i * RSTEP * LDS, ok ? src : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = in && ci + e < cin;
          copy1(as + i * RSTEP * LDS + e, ok ? src + e : x, ok);
        }
      }
    }
  };

  tc_ring<TM, NB_COLS, TK, LDS, STAGES, NT, true, passes_for<T>()>(
      acc, As, Bs, nk, wm * 32, wn * NT * 8, load_stage);
  __syncthreads();  // every warp is done with the ring before it is reused
}

template <bool VEC, class T>
__global__ void __launch_bounds__(TC_THREADS, 4)
encoder_level_tc(const T* __restrict__ xc, const T* __restrict__ xm,
                 const float* __restrict__ wcp, const float* __restrict__ wmp,
                 Tail P, T* __restrict__ yc, T* __restrict__ ym,
                 int M, int Tn, int F, int cin, int cout, int cinp_c,
                 int cinp_m) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tq = lane & 3;  // the mma's group and thread
  const int nct = (cout + CT - 1) / CT;
  const int ct = blockIdx.x % nct, r0 = (blockIdx.x / nct) * TM;
  float acc_c[2][NT_C][4], acc_m[2][NT_M][4];
  branch_loop<NT_C, VEC>(acc_c, sm, xc, wcp, M, Tn, F, 2 * cin, cinp_c, r0,
                         ct * WN * NT_C * 8);
  branch_loop<NT_M, VEC>(acc_m, sm, xm, wmp, M, Tn, F, cin, cinp_m, r0,
                         ct * WN * NT_M * 8);

  // acc_c[mi][2 g + part][hh * 2 + j]: position row gid + 8 hh of m tile
  // mi, channel 8 g + 2 tq + j of the warp's 16, part re (0) or im (1);
  // acc_m[mi][g][hh * 2 + j] the real branch's
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = r0 + wm * 32 + mi * 16 + hh * 8 + gid;
      if (p >= M) continue;
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = ct * CT + wn * 16 + g * 8 + 2 * tq + j;
          if (c >= cout) continue;
          level_out(P, acc_c[mi][2 * g][hh * 2 + j],
                    acc_c[mi][2 * g + 1][hh * 2 + j], acc_m[mi][g][hh * 2 + j],
                    (size_t)p, c, cout, true, yc, ym);
        }
    }
}

// ------------------------------------------- tensor cores, bf16 (k16)

using bf16 = __nv_bfloat16;
constexpr int ENC_BF_STAGES = 4;  // cp.async ring depth: 4 x 8 KB ...
constexpr int ENC_BF_BLOCKS = 5;  // ... five blocks an SM (96 registers)
constexpr int BF_SMEM = ENC_BF_STAGES * (TM + WN * NT_C * 8) * bfr::BK * 2;

// acc[m tile][n8 tile][fragment] = A . w^T over one branch, as branch_loop
// on bf16 tensor cores: x (B T F, cin) bf16, cin a multiple of 8; w (ncols,
// 10 cinp) bf16 packed. A stage is 32 channels of one tap: 4 16-byte
// chunks a row, zero-filled by the copy where branch_loop zero-fills.
template <int NT>
__device__ __forceinline__ void branch_loop_bf16(
    float (&acc)[2][NT][4], unsigned char* sm, const bf16* __restrict__ x,
    const bf16* __restrict__ w, int M, int Tn, int F, int cin, int cinp,
    int r0, int col0) {
  constexpr int NB_COLS = WN * NT * 8;  // packed columns a block
  constexpr int NA = TM / 32, NB = NB_COLS / 32;  // rows a thread copies
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int kp = TAPS * cinp, nk = kp / bfr::BK;
  const int crow = tid >> 2, cq = tid & 3, dst = bfr::swz16(crow, cq);
  const bf16* wq = w + ((size_t)col0 + crow) * kp + 8 * cq;
  // the thread's A rows: input row 2p of (t, 2 fo), and a bit a tap that
  // lands inside the input (none past M)
  long base[NA];
  unsigned inside[NA];
  const int fo_n = F / 2;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int p = r0 + crow + 32 * i;
    base[i] = 2L * p;
    unsigned bits = 0;
    if (p < M) {
      const int fo = p % fo_n, t = (p / fo_n) % Tn;
#pragma unroll
      for (int tap = 0; tap < TAPS; ++tap) {
        const int it = tap / 5, ff = 2 * fo + tap % 5 - 2;
        if ((it == 1 || t > 0) && ff >= 0 && ff < F) bits |= 1u << tap;
      }
    }
    inside[i] = bits;
  }
  auto load = [&](int kt, bf16* as, bf16* bs) {
    const int k0 = kt * bfr::BK, tap = k0 / cinp;
    const int ci = k0 - tap * cinp + 8 * cq;
    const long shift = (long)(tap / 5 - 1) * F + (tap % 5 - 2);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      cp_async16(bs + dst + 32 * i * bfr::BK, wq + (size_t)32 * i * kp + k0,
                 16);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const bool in = ((inside[i] >> tap) & 1u) && ci < cin;
      // outside: nothing read from a valid address, zeros stored
      cp_async16(as + dst + 32 * i * bfr::BK,
                 in ? x + (size_t)(base[i] + shift) * cin + ci : x,
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
  bfr::ring<TM, NB_COLS, ENC_BF_STAGES, NT, 1, bf16>(acc, sm, nk,
                                                     wn * NT * 8, load, frag);
  __syncthreads();  // every warp is done with the ring before it is reused
}

// encoder_level_tc's tile, grid and epilogue on bf16 tensor cores: xc, xm,
// the packed weights, yc and ym bf16; every sum and the epilogue fp32.
__global__ void __launch_bounds__(TC_THREADS, ENC_BF_BLOCKS)
encoder_level_tc_bf16(const bf16* __restrict__ xc, const bf16* __restrict__ xm,
                      const bf16* __restrict__ wcp,
                      const bf16* __restrict__ wmp, Tail P,
                      bf16* __restrict__ yc, bf16* __restrict__ ym, int M,
                      int Tn, int F, int cin, int cout, int cinp_c,
                      int cinp_m) {
  extern __shared__ __align__(16) unsigned char smb[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tq = lane & 3;
  const int nct = (cout + CT - 1) / CT;
  const int ct = blockIdx.x % nct, r0 = (blockIdx.x / nct) * TM;
  float acc_c[2][NT_C][4], acc_m[2][NT_M][4];
  branch_loop_bf16<NT_C>(acc_c, smb, xc, wcp, M, Tn, F, 2 * cin, cinp_c, r0,
                         ct * WN * NT_C * 8);
  branch_loop_bf16<NT_M>(acc_m, smb, xm, wmp, M, Tn, F, cin, cinp_m, r0,
                         ct * WN * NT_M * 8);
  // the fragment layout of m16n8k16's accumulator is m16n8k8's: as
  // encoder_level_tc
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = r0 + wm * 32 + mi * 16 + hh * 8 + gid;
      if (p >= M) continue;
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = ct * CT + wn * 16 + g * 8 + 2 * tq + j;
          if (c >= cout) continue;
          level_out(P, acc_c[mi][2 * g][hh * 2 + j],
                    acc_c[mi][2 * g + 1][hh * 2 + j], acc_m[mi][g][hh * 2 + j],
                    (size_t)p, c, cout, true, yc, ym);
        }
    }
}

// -------------------------------------------------- CUDA cores, narrow

constexpr int CC_THREADS = 128;  // positions a block pass, one a thread
constexpr int CO = 8;            // output channels a pass

// Rows of the input tile of a chunk of CC_THREADS positions: input rows
// 2 p0 - F - 2 .. 2 (p0 + CC_THREADS - 1) + 2.
__host__ __device__ inline int cc_rows(int F) {
  return 2 * CC_THREADS + F + 3;
}

// The tile's row stride in floats: 3 cin ([xc | xm]) made odd.
__host__ __device__ inline int cc_ld(int cin) { return (3 * cin) | 1; }

// Floats of encoder_level_cc's shared memory: the staged weights, 10 taps
// x (2 cin x [re | im] + cin) x coutp, then the input tile.
inline size_t cc_smem_floats(int cin, int coutp, int F) {
  return (size_t)50 * cin * coutp + (size_t)cc_rows(F) * cc_ld(cin);
}

template <class T>
__global__ void __launch_bounds__(CC_THREADS)
encoder_level_cc(const T* __restrict__ xc, const T* __restrict__ xm,
                 const float* __restrict__ wc, const float* __restrict__ wm,
                 Tail P, T* __restrict__ yc, T* __restrict__ ym,
                 int M, int Tn, int F, int cin, int cout) {
  extern __shared__ __align__(16) float ws[];
  const int coutp = (cout + CO - 1) / CO * CO, c2 = 2 * cin, ld = cc_ld(cin);
  float* wcs = ws;                                 // (10, 2 cin, 2, coutp)
  float* wms = ws + (size_t)40 * cin * coutp;      // (10, cin, coutp)
  float* tile = ws + (size_t)50 * cin * coutp;     // rows x ld
  const int tid = threadIdx.x, rows = cc_rows(F), fo_n = F / 2;
  // wc (10, 2 cin, 2 cout), wm (10, cin, cout), both HWIO as they are
  for (int e = tid; e < 40 * cin * coutp; e += CC_THREADS) {
    const int c = e % coutp, part = (e / coutp) % 2;
    const int row = e / coutp / 2;  // tap * 2 cin + ci
    wcs[e] = c < cout ? wc[(size_t)row * 2 * cout + part * cout + c] : 0.f;
  }
  for (int e = tid; e < 10 * cin * coutp; e += CC_THREADS) {
    const int c = e % coutp, row = e / coutp;
    wms[e] = c < cout ? wm[(size_t)row * cout + c] : 0.f;
  }

  const long rows_in = 2L * M;  // input rows: B T F
  for (long p0 = (long)blockIdx.x * CC_THREADS; p0 < M;
       p0 += (long)gridDim.x * CC_THREADS) {
    __syncthreads();  // the weights are staged; the last tile is consumed
    // the tile: input row g0 + r at tile row r, zeros outside the input
    const long g0 = 2 * p0 - F - 2;
    for (int e = tid; e < rows * c2; e += CC_THREADS) {
      const long gr = g0 + e / c2;
      tile[(e / c2) * ld + e % c2] =
          gr >= 0 && gr < rows_in ? ldg_f(xc + g0 * c2 + e) : 0.f;
    }
    for (int e = tid; e < rows * cin; e += CC_THREADS) {
      const long gr = g0 + e / cin;
      tile[(e / cin) * ld + c2 + e % cin] =
          gr >= 0 && gr < rows_in ? ldg_f(xm + g0 * cin + e) : 0.f;
    }
    __syncthreads();
    const long p = p0 + tid;
    if (p >= M) continue;
    const int fo = (int)(p % fo_n);
    const bool first_row = (p / fo_n) % Tn == 0;
    for (int c0 = 0; c0 < coutp; c0 += CO) {
      float re[CO], im[CO], mg[CO];
#pragma unroll
      for (int j = 0; j < CO; ++j) re[j] = im[j] = mg[j] = 0.f;
      for (int tap = 0; tap < TAPS; ++tap) {
        const int it = tap / 5, jf = tap % 5, ff = 2 * fo + jf - 2;
        if ((it == 0 && first_row) || ff < 0 || ff >= F) continue;
        // input row 2p + (it - 1) F + jf - 2 is tile row 2 tid + it F + jf
        const float* xr = tile + (size_t)(2 * tid + it * F + jf) * ld;
        const float* wr = wcs + (size_t)tap * c2 * 2 * coutp + c0;
        for (int ci = 0; ci < c2; ++ci) {
          const float xv = xr[ci];
          const float* wv = wr + (size_t)ci * 2 * coutp;
#pragma unroll
          for (int j = 0; j < CO; ++j) {
            re[j] = fmaf(xv, wv[j], re[j]);
            im[j] = fmaf(xv, wv[coutp + j], im[j]);
          }
        }
        const float* wq = wms + (size_t)tap * cin * coutp + c0;
        for (int ci = 0; ci < cin; ++ci) {
          const float xv = xr[c2 + ci];
#pragma unroll
          for (int j = 0; j < CO; ++j)
            mg[j] = fmaf(xv, wq[(size_t)ci * coutp + j], mg[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < CO; ++j)
        if (c0 + j < cout)
          level_out(P, re[j], im[j], mg[j], (size_t)p, c0 + j, cout, true,
                    yc, ym);
    }
  }
}

template <class T>
int level_cc(const T* xc, const T* xm, const float* wc, const float* bc,
             const float* sc, const float* tc, const float* ac,
             const float* wm, const float* bm, const float* sm,
             const float* tm, const float* am, T* yc, T* ym, int B, int Tn,
             int F, int cin, int cout, cudaStream_t st) {
  if (F % 2 != 0) return (int)cudaErrorInvalidValue;
  const long M = (long)B * Tn * (F / 2);
  if (M == 0) return 0;
  const Tail P{bc, sc, tc, ac, bm, sm, tm, am};
  const int coutp = (cout + CO - 1) / CO * CO;
  const size_t smem = cc_smem_floats(cin, coutp, F) * sizeof(float);
  auto kernel = encoder_level_cc<T>;
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
  kernel<<<blocks, CC_THREADS, smem, st>>>(xc, xm, wc, wm, P, yc, ym, (int)M,
                                           Tn, F, cin, cout);
  return (int)cudaGetLastError();
}

template <class T>
int level_tc(const T* xc, const T* xm, const float* wcp, const float* wmp,
             const float* bc, const float* sc, const float* tc,
             const float* ac, const float* bm, const float* sm,
             const float* tm, const float* am, T* yc, T* ym, int B, int Tn,
             int F, int cin, int cout, int cinp_c, int cinp_m,
             cudaStream_t st) {
  if (F % 2 != 0 || cinp_c % TK != 0 || cinp_c < 2 * cin ||
      cinp_m % TK != 0 || cinp_m < cin ||
      reinterpret_cast<uintptr_t>(xc) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xm) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long M = (long)B * Tn * (F / 2);
  if (M == 0) return 0;
  const bool vec = cin % 4 == 0;
  auto kernel = vec ? encoder_level_tc<true, T> : encoder_level_tc<false, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((cout + CT - 1) / CT) * ((M + TM - 1) / TM);
  const Tail P{bc, sc, tc, ac, bm, sm, tm, am};
  kernel<<<(unsigned)blocks, TC_THREADS, TC_SMEM, st>>>(
      xc, xm, wcp, wmp, P, yc, ym, (int)M, Tn, F, cin, cout, cinp_c, cinp_m);
  return (int)cudaGetLastError();
}

}  // namespace

// The CUDA-core design, the 10-tuple's weights as they are: wc (2, 5, 2cin,
// 2cout), wm (2, 5, cin, cout). Needs F even and its shared memory
// (cc_smem_floats: the staged weights, coutp = cout rounded up to 8, and
// the input tile) to fit a block.
extern "C" int se_encoder_level_cc(
    const float* xc, const float* xm, const float* wc, const float* bc,
    const float* sc, const float* tc, const float* ac, const float* wm,
    const float* bm, const float* sm, const float* tm, const float* am,
    float* yc, float* ym, int B, int T, int F, int cin, int cout,
    void* stream) {
  return level_cc(xc, xm, wc, bc, sc, tc, ac, wm, bm, sm, tm, am, yc, ym, B,
                  T, F, cin, cout, (cudaStream_t)stream);
}

// The tensor-core design. xc (B, T, F, 2cin), xm (B, T, F, cin) -> yc (B,
// T, F/2, 2cout), ym (B, T, F/2, cout). wcp / wmp: pack_encoder_weights'
// packed complex (2 coutp, 10 cinp_c) and real (coutp, 10 cinp_m)
// weights, coutp = cout rounded up to 32, cinp_c / cinp_m = 2cin / cin
// rounded up to 32; the tail vectors as the 10-tuple's (ops/encoder.py).
// Needs F even and xc, xm 16-byte aligned.
extern "C" int se_encoder_level_tc(
    const float* xc, const float* xm, const float* wcp, const float* wmp,
    const float* bc, const float* sc, const float* tc, const float* ac,
    const float* bm, const float* sm, const float* tm, const float* am,
    float* yc, float* ym, int B, int T, int F, int cin, int cout, int cinp_c,
    int cinp_m, void* stream) {
  return level_tc(xc, xm, wcp, wmp, bc, sc, tc, ac, bm, sm, tm, am, yc, ym,
                  B, T, F, cin, cout, cinp_c, cinp_m, (cudaStream_t)stream);
}

// The CUDA-core design in bf16: xc, xm, yc, ym bf16; the weights (fp32
// holding bf16 values) and the tail vectors fp32; otherwise as above.
extern "C" int se_encoder_level_cc_bf16(
    const __nv_bfloat16* xc, const __nv_bfloat16* xm, const float* wc,
    const float* bc, const float* sc, const float* tc, const float* ac,
    const float* wm, const float* bm, const float* sm, const float* tm,
    const float* am, __nv_bfloat16* yc, __nv_bfloat16* ym, int B, int T,
    int F, int cin, int cout, void* stream) {
  return level_cc(xc, xm, wc, bc, sc, tc, ac, wm, bm, sm, tm, am, yc, ym, B,
                  T, F, cin, cout, (cudaStream_t)stream);
}

// The tensor-core design in bf16 (encoder_level_tc_bf16): xc, xm, the
// packed weights (pack_encoder_weights' layout, in bf16), yc and ym bf16;
// the tail vectors fp32; otherwise as se_encoder_level_tc. Needs cin % 8
// == 0 (16-byte copies of 8 channels of both branches), F even and xc, xm
// 16-byte aligned.
extern "C" int se_encoder_level_tc_bf16(
    const bf16* xc, const bf16* xm, const bf16* wcp, const bf16* wmp,
    const float* bc, const float* sc, const float* tc, const float* ac,
    const float* bm, const float* sm, const float* tm, const float* am,
    bf16* yc, bf16* ym, int B, int T, int F, int cin, int cout, int cinp_c,
    int cinp_m, void* stream) {
  if (F % 2 != 0 || cin % 8 != 0 || cinp_c % bfr::BK != 0 ||
      cinp_c < 2 * cin || cinp_m % bfr::BK != 0 || cinp_m < cin ||
      reinterpret_cast<uintptr_t>(xc) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xm) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long M = (long)B * T * (F / 2);
  if (M == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      encoder_level_tc_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BF_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((cout + CT - 1) / CT) * ((M + TM - 1) / TM);
  const Tail P{bc, sc, tc, ac, bm, sm, tm, am};
  encoder_level_tc_bf16<<<(unsigned)blocks, TC_THREADS, BF_SMEM,
                          (cudaStream_t)stream>>>(
      xc, xm, wcp, wmp, P, yc, ym, (int)M, T, F, cin, cout, cinp_c, cinp_m);
  return (int)cudaGetLastError();
}

// encoder_level_tc_bf16's resources (tc_common.cuh kernel_resources).
extern "C" int se_encoder_level_tc_bf16_resources(int* out) {
  return kernel_resources(encoder_level_tc_bf16, TC_THREADS, BF_SMEM, out);
}
