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
// (In + H) 4 B of x and y a row: ~1,000 flops a byte, far above the fp32
// ridge of ~20 (67 TFLOP/s over 3.35 TB/s).
//
// Design. The TPU kernel walks time inside one call with h and c in VMEM;
// on the card blocks cannot wait on each other within a launch, so the C
// entry enqueues one step kernel per frame on the stream, and the stream
// orders the frames. Each step is a GEMM over K = In + H with the LSTM
// cell as its epilogue. A block owns a tile of rows x hidden units and
// computes the four gate columns j, H + j, 2H + j, 3H + j of each of its
// units, so the cell update needs no other block's sums; it owns the c
// entries of its tile for the whole layer, updated in place, and writes
// h_t to the other half of a ping-pong buffer and to y. x is read in place
// from (Bf, T, In), h_{t-1} from the ping-pong buffer. Two step kernels:
//   - lstm_step_tiled (a large folded batch, the sub band): 64 rows x 32
//     units, 256 threads, K in tiles of 16 staged in shared memory (two
//     buffers, the next tile's loads in registers while the current one is
//     multiplied), 4 rows x 2 units x 4 gates of sums a thread;
//   - lstm_step_split (a batch too small to give the tiled kernel one block
//     an SM, the full band): 8 rows x 8 units, the 32 gate columns one a
//     lane, K split over the block's 8 warps and summed in shared memory at
//     the end. The rows' [x_t | h_{t-1}] sit in shared memory and each lane
//     streams its weight column from L2 with no barrier inside the K loop,
//     so a step is one pass over the weights instead of a chain of K tiles,
//     and a batch of 4 still spreads over H / 8 blocks.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KT = 16;  // K tile

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

// Row k, gate g, unit u of [Wx; Wh] (0 past H or past K).
__device__ __forceinline__ float w_at(const float* __restrict__ wx,
                                      const float* __restrict__ wh, int k,
                                      int g, int u, int In, int H) {
  if (u >= H || k >= In + H) return 0.f;
  const size_t col = (size_t)g * H + u, h4 = 4 * (size_t)H;
  return k < In ? wx[(size_t)k * h4 + col] : wh[(size_t)(k - In) * h4 + col];
}

// Tiled step: RM = TR * NTY rows x HN = TU * NTX units a block.
template <int TR, int TU, int NTY, int NTX>
__global__ void __launch_bounds__(NTY * NTX)
lstm_step_tiled(const float* __restrict__ x, const float* __restrict__ wx,
                const float* __restrict__ wh, const float* __restrict__ bias,
                const float* __restrict__ h_prev, float* __restrict__ h_next,
                float* __restrict__ c, float* __restrict__ y, int Bf, int T,
                int In, int H, int t) {
  constexpr int RM = TR * NTY, HN = TU * NTX, NT = NTY * NTX, NC = 4 * HN;
  constexpr int NA = KT * RM / NT, NB = KT * NC / NT;  // loads a thread
  static_assert(KT * RM % NT == 0 && KT * NC % NT == 0, "tile shape");
  __shared__ float As[2][KT][RM + 1];  // +1: the fill writes down columns
  __shared__ float Bs[2][KT][NC];
  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  const int r0 = blockIdx.x * RM, j0 = blockIdx.y * HN;
  const int K = In + H;
  float ra[NA], rb[NB];

  // thread's q-th A element: k = e % KT (consecutive threads read
  // consecutive k of a row), row e / KT; q-th B element: column e % NC
  // (HN consecutive units of each gate), k e / NC
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < NA; ++q) {
      const int e = tid + q * NT;
      ra[q] = a_at(x, h_prev, r0 + e / KT, k0 + e % KT, Bf, T, In, H, t);
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int e = tid + q * NT, col = e % NC;
      rb[q] = w_at(wx, wh, k0 + e / NC, col / HN, j0 + col % HN, In, H);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < NA; ++q) {
      const int e = tid + q * NT;
      As[buf][e % KT][e / KT] = ra[q];
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int e = tid + q * NT;
      Bs[buf][e / NC][e % NC] = rb[q];
    }
  };

  float acc[4][TR][TU];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TU; ++j) acc[g][i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += KT) {
    const bool more = k0 + KT < K;
    if (more) load(k0 + KT);  // in flight while this tile is multiplied
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      float a[TR], bv[4][TU];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = As[buf][kk][ty + NTY * i];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < TU; ++j)
          bv[g][j] = Bs[buf][kk][g * HN + tx + NTX * j];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TU; ++j)
            acc[g][i][j] = fmaf(a[i], bv[g][j], acc[g][i][j]);
    }
    if (more) store(buf ^ 1);  // the other buffer: no one reads it now
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = r0 + ty + NTY * i;
#pragma unroll
    for (int j = 0; j < TU; ++j) {
      const int u = j0 + tx + NTX * j;
      if (row < Bf && u < H)
        cell(bias, c, h_next, y, acc[0][i][j], acc[1][i][j], acc[2][i][j],
             acc[3][i][j], row, u, T, H, t);
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

}  // namespace

// x (Bf, T, In), wx (In, 4H), wh (H, 4H), b (4H); hbuf (2, Bf, H) with h0
// in its first half; c (Bf, H) holding c0, updated in place; y (Bf, T, H).
// After the call h_T is in half T % 2 of hbuf and c_T in c.
extern "C" int se_lstm_layer(const float* x, const float* wx, const float* wh,
                             const float* b, float* hbuf, float* c, float* y,
                             int Bf, int T, int In, int H, int reverse,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const long tiled_blocks = (long)((Bf + 63) / 64) * ((H + 31) / 32);
  const size_t split_smem =
      ((size_t)RS * (In + H) + (size_t)WS * RS * 32) * sizeof(float);
  if (tiled_blocks < sms && split_smem <= (size_t)smem_max) {
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
  const dim3 grid((Bf + 63) / 64, (H + 31) / 32);
  return run_layer(
      [&](const float* hp, float* hn, int t) {
        lstm_step_tiled<4, 2, 16, 16><<<grid, 256, 0, st>>>(
            x, wx, wh, b, hp, hn, c, y, Bf, T, In, H, t);
      },
      hbuf, Bf, T, H, reverse);
}
