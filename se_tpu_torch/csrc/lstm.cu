// One single-direction LSTM layer over a whole sequence, fp32.
//
// Replaces: se_tpu/ops/pallas_lstm.py, `_pallas_lstm_tm` and its body
// `_lstm_kernel` (entry `pallas_lstm_layer`).
//
// Per frame t, for every row of the folded batch:
//   gates = x_t . Wx + h_{t-1} . Wh + b          (i, f, g, o: torch's order)
//   c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g);  h_t = sigmoid(o) tanh(c_t)
// with h and c in fp32. The input projection x_t . Wx is done inside the
// kernel: the (T, Bf, 4H) gate tensor never reaches device memory (at
// FullSubNet's sub-band fold at B = 256 it would be 253 x 65,792 x 1536 x
// 4 B = 102 GB). `reverse` walks t from T - 1 down by index.
//
// Bound on the H100: by operations. A frame costs 2 (In + H) 4H flops a
// row (sub band, H = 384: 0.64 and 1.18 Mflop for the two layers) on
// (In + H) 4 B of x and y a row: ~1,000 flops a byte, far above the ridge.
// Done in fp32-accurate 3xTF32 on the tensor cores (below), the least time
// is the flops over 495 / 3 = 165 TFLOP/s.
//
// Design. The TPU kernel walks time inside one call with h and c in VMEM;
// on the card blocks cannot wait on each other within a launch, so the C
// entry enqueues one step kernel per frame on the stream, and the stream
// orders the frames. Each step is a GEMM over K = In + H with the LSTM
// cell as its epilogue. A block owns a tile of rows x hidden units and
// computes the four gate columns of each of its units, so the cell update
// needs no other block's sums; it owns the c entries of its tile for the
// whole layer, updated in place, and writes h_t to the other half of a
// ping-pong buffer and to y. x is read in place from (Bf, T, In), h_{t-1}
// from the ping-pong buffer. Two step kernels; the wrapper
// (ops/lstm.py `step_variant`) picks one a layer call:
//   - lstm_step_tc when its grid, ceil(Bf / 64) x ceil(H / 16) blocks, gives
//     every SM at least one block (on 132 SMs: FullSubNet's sub band from
//     B = 2, DPCRN's intra BiLSTM from B = 6, LSTMNet's and CRN's H = 1024
//     from B = 129), or when the split kernel's rows would not fit in
//     shared memory;
//   - lstm_step_split otherwise (a small fold: the full band, DCCRN, GCRN,
//     DPCRN's inter LSTM): 8 rows x 8 units, the 32 gate columns one a
//     lane, K split over the block's 8 warps and summed in shared memory at
//     the end. The rows' [x_t | h_{t-1}] sit in shared memory and each lane
//     streams its weight column from L2 with no barrier inside the K loop,
//     so a step is one pass over the weights instead of a chain of K tiles,
//     and a batch of 4 still spreads over H / 8 blocks.
//
// lstm_step_tc, the large-fold step, on the tensor cores:
//   - 3xTF32 with mma.sync.m16n8k8 (.tf32, fp32 accumulate). Each operand
//     v is split into big, v rounded to TF32 (to nearest, ties away from
//     zero), and small = v - big, exact in fp32; a tile sums small.big +
//     big.small + big.big. Products of TF32 values are exact in fp32, so
//     the step keeps fp32's accuracy (tests/test_torch_lstm_tc.py: 6e-7 of
//     max|C| at K = 768, as plain fp32 sums; one TF32 pass is off by 2e-4,
//     which 253 recurrent frames would compound).
//   - Departure from cvt.rna.tf32.f32 for the split: on sm_90 it is no
//     single instruction but four (add, mask, an inf/NaN test, a select),
//     twice a value. Here big is the add and the mask (the same rounding
//     for finite values) and small goes to the mma as it is, which reads
//     its top 19 bits (truncation: |error| < 2^-21 |v|; in the emulation
//     the sums stay as close to fp64 as with cvt.rna). On an H100 SXM at
//     700 W that made the step 15-19% faster.
//   - Departure from a pre-split of the weights: B is split in registers
//     like A. Two packed weight tensors would double B's shared memory
//     (81 KB for three stages, two blocks an SM instead of four) to save
//     ALU work that is not the limit.
//   - Weights packed once a layer call by the wrapper (ops/lstm.py
//     `pack_weights`), K-major (4Hp, Kp) as torch's own weight_ih is, with
//     each run of 32 packed columns the i, f, g, o columns of 8 units. A
//     block's 64 columns are the four gates of its 16 units, and the mma's
//     accumulator layout then gives the thread that holds (row, unit) for
//     one gate the same (row, unit) of all four: the cell update stays in
//     registers. Hp = H rounded up to 16 and Kp = In + H rounded up to 32,
//     zero-padded, so B tiles need no bounds checks.
//   - A block: 64 rows x 64 packed columns, 128 threads in 2 x 2 warps of
//     32 x 32 (2 m16 x 4 n8 tiles, one n8 tile a gate). K walks in stages
//     of 32 through a 3-stage cp.async ring in dynamic shared memory
//     (rows padded to 36 floats: conflict-free ldmatrix reads of the
//     fragments, 16-byte aligned rows): one wait_group and one barrier a
//     stage. 16-byte copies where In and H are multiples of 4 and x is
//     16-byte aligned (every shape the seven paths use), 4-byte copies
//     otherwise; rows past Bf and K past In + H are zero-filled by the copy.
//     The grid runs the unit tiles of a row tile together, so a frame's A
//     is read from HBM once.
//   - 54 KB of shared memory and at most 128 registers a thread
//     (__launch_bounds__(128, 4)): four blocks an SM. At FullSubNet's
//     B = 4 fold (Bf = 1028, H = 384) the grid is 24 x 17 = 408 blocks, one
//     wave on 132 SMs. A 128-row tile (two blocks an SM, half the L2 reads
//     a flop) was no faster at B = 32 and slower at B = 4: the mma issue
//     rate, not L2, sets the pace (about a third of the card's TF32 peak).
//   - Not here: wgmma, TMA, clusters, persistent blocks, CUDA graphs, bf16.
//     A wgmma version takes TF32 only with A and B both K-major in shared
//     memory: the packed weights already are, and A's [x_t | h_{t-1}] rows
//     are K-contiguous; it needs 64-row warpgroup tiles, the 128-byte
//     swizzle in place of the padding, and the cell epilogue mapped to
//     wgmma's accumulator layout.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ void cell(const float* __restrict__ bias,
                                     float* __restrict__ c,
                                     float* __restrict__ h_next,
                                     float* __restrict__ y, float gi,
                                     float gf, float gg, float go, int row,
                                     int u, int T, int H, int t) {
  gi += bias[u];
  gf += bias[H + u];
  gg += bias[2 * H + u];
  go += bias[3 * H + u];
  const size_t ci = (size_t)row * H + u;
  const float cn = sigmoidf(gf) * c[ci] + sigmoidf(gi) * tanhf(gg);
  const float hn = sigmoidf(go) * tanhf(cn);
  c[ci] = cn;
  h_next[ci] = hn;
  y[((size_t)row * T + t) * H + u] = hn;
}

// Row r, column k of [x_t | h_{t-1}] (0 past the batch or past K).
__device__ __forceinline__ float a_at(const float* __restrict__ x,
                                      const float* __restrict__ h_prev,
                                      int row, int k, int Bf, int T, int In,
                                      int H, int t) {
  if (row >= Bf || k >= In + H) return 0.f;
  return k < In ? x[((size_t)row * T + t) * In + k]
                : h_prev[(size_t)row * H + (k - In)];
}

// ------------------------------------------------ tensor-core step (3xTF32)

constexpr int TM = 64;          // rows a block
constexpr int TU = 16;          // hidden units a block
constexpr int TN = 4 * TU;      // packed gate columns a block
constexpr int TK = 32;          // K a stage
constexpr int STAGES = 3;       // cp.async ring depth
constexpr int LDS = TK + 4;     // shared row stride in floats
constexpr int WM = TM / 32;     // warps down the rows (32 rows each)
constexpr int WN = TU / 8;      // warps across the units (8 units each)
constexpr int TC_THREADS = 32 * WM * WN;
constexpr int TC_BLOCKS_SM = 4; // resident blocks an SM (register cap)
constexpr int TC_SMEM = STAGES * (TM + TN) * LDS * (int)sizeof(float);

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = big + small: big is v rounded to TF32 (to nearest, ties away from
// zero, as cvt.rna: add half a unit of the 13 dropped bits to the
// magnitude, clear them), small = v - big exactly, which the mma reads as
// TF32 (its low 13 bits dropped).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// Four 8 x 4 fp32 matrices from shared memory, one a lane group of 8 rows
// (lane l gives the address of row l % 8 of matrix l / 8); register i of
// lane l holds word l % 4 of row l / 4 of matrix i: the m16n8k8 TF32
// fragment layout.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const float* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// d += a . b on a 16 x 8 x 8 tile, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One frame for TM rows x TU units. w: packed (4Hp, Kp), K-major; VEC:
// 16-byte copies of A (In % 4 == 0, H % 4 == 0, x 16-byte aligned).
template <bool VEC>
__global__ void __launch_bounds__(TC_THREADS, TC_BLOCKS_SM)
lstm_step_tc(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, const float* __restrict__ h_prev,
             float* __restrict__ h_next, float* __restrict__ c,
             float* __restrict__ y, int Bf, int T, int In, int H, int Kp,
             int t) {
  extern __shared__ __align__(16) float sm[];
  float* As = sm;                      // STAGES x TM x LDS
  float* Bs = sm + STAGES * TM * LDS;  // STAGES x TN x LDS
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tq = lane & 3;  // the mma's group and thread
  // unit tiles vary fastest: the blocks of one row tile run together and
  // read its [x_t | h_{t-1}] from L2 (at FullSubNet's B = 256 a frame's A
  // is 200 MB, the weights 4.7 MB)
  const int r0 = blockIdx.y * TM, u0 = blockIdx.x * TU;
  const int K = In + H, nk = Kp / TK;
  // a thread's copies: 16-byte chunk cq of rows crow + RSTEP i in every
  // stage (VEC; B always), so their row pointers are set once
  constexpr int CH = TK / 4, RSTEP = TC_THREADS / CH;  // 8 chunks a row
  constexpr int NA = TM / RSTEP, NB = TN / RSTEP;      // rows a thread copies
  const int crow = tid / CH, cq = tid % CH;
  const float* wq = w + ((size_t)blockIdx.x * TN + crow) * Kp + 4 * cq;
  const float* xrow[NA];
  const float* hrow[NA];
  bool live[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int row = r0 + crow + i * RSTEP;
    live[i] = row < Bf;
    const size_t r = live[i] ? row : 0;
    xrow[i] = x + (r * T + t) * In;
    hrow[i] = h_prev + r * H;
  }

  auto load_stage = [&](int kt, int slot) {
    const int k0 = kt * TK;
    float* as = As + slot * TM * LDS;
    float* bs = Bs + slot * TN * LDS + crow * LDS + 4 * cq;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      cp_async16(bs + i * RSTEP * LDS, wq + (size_t)i * RSTEP * Kp + k0, 16);
    if (VEC) {
      const int k = k0 + 4 * cq;
      const bool in_x = k < In, in_k = k < K;
#pragma unroll
      for (int i = 0; i < NA; ++i)  // past K: 0 bytes from a valid address
        cp_async16(as + (crow + i * RSTEP) * LDS + 4 * cq,
                   in_x || !in_k ? xrow[i] + (in_x ? k : 0)
                                 : hrow[i] + (k - In),
                   live[i] && in_k ? 16 : 0);
    } else {
#pragma unroll 4
      for (int i = 0; i < TM * TK / TC_THREADS; ++i) {
        const int e = tid + i * TC_THREADS, r = e / TK, kk = e % TK;
        const int row = r0 + r, k = k0 + kk;
        const float* src = x;
        int bytes = 0;
        if (row < Bf && k < K) {
          src = k < In ? x + ((size_t)row * T + t) * In + k
                       : h_prev + (size_t)row * H + (k - In);
          bytes = 4;
        }
        cp_async4(as + r * LDS + kk, src, bytes);
      }
    }
  };

  // acc[m tile][gate][fragment]: rows gid (+8), units 2 tq (+1)
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][g][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();              // ... for all, and stage kt - 1 is read
    const int next = kt + STAGES - 1;  // into the slot stage kt - 1 held
    if (next < nk) load_stage(next, next % STAGES);
    cp_async_commit();
    // ldmatrix row addresses: A's four 8 x 4 matrices are rows +0 / +8,
    // k +0 / +4 of an m16 tile (a0..a3); B's are k +0 / +4 of gate g, then
    // of gate g + 1 (b0, b1 of two n8 tiles)
    const float* as = As + (kt % STAGES) * TM * LDS +
                      (wm * 32 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                      (lane >> 4) * 4;
    const float* bs = Bs + (kt % STAGES) * TN * LDS +
                      (wn * 32 + (lane >> 4) * 8 + (lane & 7)) * LDS +
                      ((lane >> 3) & 1) * 4;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 8) {
      uint32_t a[2][4], b[4][2];
      uint32_t a_big[2][4], a_small[2][4], b_big[4][2], b_small[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) ldsm_x4(a[mi], as + mi * 16 * LDS + kk);
#pragma unroll
      for (int g = 0; g < 4; g += 2) ldsm_x4(b[g], bs + g * 8 * LDS + kk);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_tf32(__uint_as_float(a[mi][j]), a_big[mi][j], a_small[mi][j]);
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          split_tf32(__uint_as_float(b[g][j]), b_big[g][j], b_small[g][j]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          mma_tf32(acc[mi][g], a_small[mi], b_big[g]);
          mma_tf32(acc[mi][g], a_big[mi], b_small[g]);
          mma_tf32(acc[mi][g], a_big[mi], b_big[g]);
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + wm * 32 + mi * 16 + hh * 8 + gid;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int u = u0 + wn * 8 + 2 * tq + cc, j = hh * 2 + cc;
        if (row < Bf && u < H)
          cell(bias, c, h_next, y, acc[mi][0][j], acc[mi][1][j],
               acc[mi][2][j], acc[mi][3][j], row, u, T, H, t);
      }
    }
}

// Split-K step: RS rows x HS units a block, HS * 4 = 32 gate columns (one a
// lane), K split over WS warps.
constexpr int RS = 8, HS = 8, WS = 8;

__global__ void __launch_bounds__(WS * 32)
lstm_step_split(const float* __restrict__ x, const float* __restrict__ wx,
                const float* __restrict__ wh, const float* __restrict__ bias,
                const float* __restrict__ h_prev, float* __restrict__ h_next,
                float* __restrict__ c, float* __restrict__ y, int Bf, int T,
                int In, int H, int t) {
  extern __shared__ float sm[];
  const int K = In + H;
  float* A = sm;              // RS x K: the rows' [x_t | h_{t-1}]
  float* red = sm + RS * K;   // WS x RS x 32: per-warp partial sums
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = blockIdx.x * RS, j0 = blockIdx.y * HS;
  for (int e = threadIdx.x; e < RS * K; e += blockDim.x)
    A[e] = a_at(x, h_prev, r0 + e / K, e % K, Bf, T, In, H, t);
  __syncthreads();

  // lane -> gate g, unit u: a warp reads 4 runs of HS consecutive floats
  const int g = lane / HS, u = j0 + lane % HS;
  float acc[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) acc[r] = 0.f;
  if (u < H) {
    const size_t h4 = 4 * (size_t)H, col = (size_t)g * H + u;
#pragma unroll 8
    for (int k = w; k < In; k += WS) {
      const float wv = wx[(size_t)k * h4 + col];
#pragma unroll
      for (int r = 0; r < RS; ++r) acc[r] = fmaf(A[r * K + k], wv, acc[r]);
    }
#pragma unroll 8
    for (int k = w; k < H; k += WS) {
      const float wv = wh[(size_t)k * h4 + col];
#pragma unroll
      for (int r = 0; r < RS; ++r)
        acc[r] = fmaf(A[r * K + In + k], wv, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RS; ++r) red[(w * RS + r) * 32 + lane] = acc[r];
  __syncthreads();

  if (threadIdx.x < RS * HS) {
    const int r = threadIdx.x / HS, ul = threadIdx.x % HS;
    const int row = r0 + r, uu = j0 + ul;
    if (row < Bf && uu < H) {
      float gs[4];
#pragma unroll
      for (int gg = 0; gg < 4; ++gg) {
        float s = 0.f;
#pragma unroll
        for (int ww = 0; ww < WS; ++ww)
          s += red[(ww * RS + r) * 32 + gg * HS + ul];
        gs[gg] = s;
      }
      cell(bias, c, h_next, y, gs[0], gs[1], gs[2], gs[3], row, uu, T, H, t);
    }
  }
}

// Enqueue the T step kernels; `step(h_prev, h_next, t)` launches one.
template <class Step>
int run_layer(Step step, float* hbuf, int Bf, int T, int H, int reverse) {
  const size_t half = (size_t)Bf * H;
  for (int s = 0; s < T; ++s) {
    step(hbuf + (s & 1) * half, hbuf + ((s + 1) & 1) * half,
         reverse ? T - 1 - s : s);
    if (s == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

template <bool VEC>
int run_tc(const float* x, const float* wp, const float* b, float* hbuf,
           float* c, float* y, int Bf, int T, int In, int H, int Hp, int Kp,
           int reverse, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      lstm_step_tc<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TC_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lstm_step_tc<VEC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hp / TU, (Bf + TM - 1) / TM);
  return run_layer(
      [&](const float* hp, float* hn, int t) {
        lstm_step_tc<VEC><<<grid, TC_THREADS, TC_SMEM, st>>>(
            x, wp, b, hp, hn, c, y, Bf, T, In, H, Kp, t);
      },
      hbuf, Bf, T, H, reverse);
}

}  // namespace

// x (Bf, T, In), wx (In, 4H), wh (H, 4H), b (4H); hbuf (2, Bf, H) with h0
// in its first half; c (Bf, H) holding c0, updated in place; y (Bf, T, H).
// wp: NULL for the split-K step, else the tensor-core step's packed
// weights (4Hp, Kp) (ops/lstm.py `pack_weights`: Hp a multiple of 16 and
// Kp of 32, neither below H and In + H). After the call h_T is in half
// T % 2 of hbuf and c_T in c.
extern "C" int se_lstm_layer(const float* x, const float* wx, const float* wh,
                             const float* wp, const float* b, float* hbuf,
                             float* c, float* y, int Bf, int T, int In, int H,
                             int Hp, int Kp, int reverse, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (wp != nullptr) {
    if (Hp % TU != 0 || Hp < H || Kp % TK != 0 || Kp < In + H)
      return (int)cudaErrorInvalidValue;
    const bool vec = In % 4 == 0 && H % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
    return vec ? run_tc<true>(x, wp, b, hbuf, c, y, Bf, T, In, H, Hp, Kp,
                              reverse, st)
               : run_tc<false>(x, wp, b, hbuf, c, y, Bf, T, In, H, Hp, Kp,
                               reverse, st);
  }
  const size_t split_smem =
      ((size_t)RS * (In + H) + (size_t)WS * RS * 32) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_step_split, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)split_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Bf + RS - 1) / RS, (H + HS - 1) / HS);
  return run_layer(
      [&](const float* hp, float* hn, int t) {
        lstm_step_split<<<grid, WS * 32, split_smem, st>>>(
            x, wx, wh, b, hp, hn, c, y, Bf, T, In, H, t);
      },
      hbuf, Bf, T, H, reverse);
}
