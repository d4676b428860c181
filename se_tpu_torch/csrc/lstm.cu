// One single-direction LSTM layer over a whole sequence, fp32, and its
// bf16 variants (bf16 weights; see "bf16" below).
//
// Replaces: se_tpu/ops/pallas_lstm.py, `_pallas_lstm_tm` and its body
// `_lstm_kernel` (entry `pallas_lstm_layer`).
//
// Per frame t, for every row of the folded batch:
//   gates = x_t . Wx + h_{t-1} . Wh + b          (i, f, g, o: torch's order)
//   c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g);  h_t = sigmoid(o) tanh(c_t)
// with h and c in fp32. `reverse` walks t from T - 1 down by index.
//
// Bound on the H100: by operations. A frame costs 2 (In + H) 4H flops a
// row (sub band, H = 384: 0.64 and 1.18 Mflop for the two layers) on
// (In + H) 4 B of x and y a row: ~1,000 flops a byte, far above the ridge.
// Done in fp32-accurate 3xTF32 on the tensor cores (below), the least time
// is the flops over 495 / 3 = 165 TFLOP/s.
//
// Design. The TPU kernel walks time inside one call with h and c in VMEM.
// The wrapper (ops/lstm.py `step_variant`) picks one of two designs a layer
// call, by shape:
//   - the large fold, when ceil(Bf / 64) x ceil(H / 16) step blocks give
//     every SM at least one (on 132 SMs: FullSubNet's sub band from B = 2,
//     DPCRN's intra BiLSTM from B = 6, LSTMNet's and CRN's H = 1024 from
//     B = 129), when the small fold's Wh slices do not fit, or when the
//     sequence is shorter than ops/lstm.py SHORT_T frames (DPCRN's intra
//     BiLSTM walks 4 bins: too few frames to repay the small fold's two
//     launches and packing): one lstm_step_tc launch a frame, enqueued by
//     one C call, the stream ordering the frames. Each step is a GEMM over K = In + H with the
//     cell as its epilogue; the projection x_t . Wx is inside it, so the
//     (T, Bf, 4H) gate tensor never reaches device memory (at FullSubNet's
//     sub band at B = 256 it would be 253 x 65,792 x 1536 x 4 B = 102 GB).
//   - the small fold otherwise (the full band, DCCRN, GCRN, DPCRN's inter
//     LSTM, LSTMNet and CRN up to B = 128): too few rows to fill the card a
//     frame, so a launch a frame is paced by launch spacing (7.7 us a step
//     at DCCRN's H = 128, of which cuDNN needs 2.3), and a step that redoes
//     x_t . Wx streams [Wx; Wh] from L2 every frame (32 MB at H = 1024).
//     Two launches a layer instead: lstm_proj_tc computes XP = x . Wx + b
//     for all frames as one GEMM over Bf T rows (the tensor-core step's main
//     loop with a store epilogue), then lstm_recur_persistent walks the
//     whole time loop in one cooperative launch, each block's slice of Wh
//     resident in shared memory and one grid barrier a frame. Here XP may
//     reach device memory: the small fold has ceil(Bf / 64) ceil(H / 16) <
//     132, so 4H Bf < 540k floats a frame, at most 1.1 GB at T = 501 (GCRN
//     at B = 256: 840 MB).
// Both keep the C entries' contract: h_{t-1} in one half of a ping-pong
// buffer, h_t written to the other half and to y, c updated in place.
//
// lstm_recur_persistent, the small fold's recurrence:
//   - A block owns 8 hidden units (the 32 packed columns of pack_recurrent,
//     the i, f, g, o of each unit) for the rows of some 16-row chunks. Its
//     Wh slice (H x 32 floats: 128 KB at H = 1024) and its c entries stay
//     in shared memory for the whole layer. A step, per chunk: h_{t-1} of
//     the 16 rows staged in shared memory, the 3xTF32 product (one m16 tile
//     x four n8 tiles, K split over 8 warps, the partial sums added in
//     shared memory), the cell with XP's four gate inputs, read before the
//     product. Then one grid barrier (cooperative_groups grid sync).
//   - Grid: ceil(H / 8) unit tiles x ng row groups, ng as large as the
//     resident blocks allow (ops/lstm.py `persistent_plan`, from the shared
//     memory a block needs and two blocks an SM at most); the entry checks
//     the occupancy and cudaLaunchCooperativeKernel refuses a grid that
//     does not fit, rather than hang at the barrier. H = 1024: 128 blocks of
//     210 KB, one an SM.
//   - Traps. h_{t-1} is written by other blocks: read only through L2
//     (cp.async.cg, __ldcg), never a cached L1 line; the grid sync orders
//     the writes before it (a fence and the barrier's atomic). h ping-pongs,
//     so a block writing h_t never races a block still reading h_{t-1}.
//     XP is indexed by t as x is, so reverse needs nothing else. Rows past
//     Bf, units past H and K past H are zero in the staged rows and in the
//     packed slice: no bounds check in the product. A cooperative launch is
//     stream-ordered, so it waits for the projection (and for any earlier
//     kernel, under the profiler too). A grid barrier costs about 1-3 us:
//     the floor of a step here.
//
// lstm_step_tc, the large-fold step, on the tensor cores (lstm_proj_tc runs
// the same main loop, tc_mainloop, over the Bf T rows of x with K = In, the
// weights from pack_input in torch's column order, and a store epilogue):
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
//   - Not here: wgmma, TMA, clusters, CUDA graphs. A wgmma version
//     takes TF32 only with A and B both K-major in shared memory: the
//     packed weights already are, and A's [x_t | h_{t-1}] rows
//     are K-contiguous; it needs 64-row warpgroup tiles, the 128-byte
//     swizzle in place of the padding, and the cell epilogue mapped to
//     wgmma's accumulator layout.

// bf16 (the `_bf16` entries; se_tpu's bf16 decode, pallas_lstm.py:14-16,
// :44-46, :84-85, and its scan, se_tpu/nn/recurrent.py:36-37, :150): the
// weights (and the combined bias) are bf16, stored so in device memory
// (half the fp32 packs' bytes) and widened to fp32 as they are loaded into
// shared memory, so every tile, plan and grid is the fp32 design's. x is
// fp32 or bf16 (x_bf16); XP, h, c and y are fp32. The one rounding point
// inside is se_tpu's `h.astype(wh.dtype)`: h_{t-1} rounded to bf16 (to
// nearest even) where the product takes it (lstm_step_tc: in the A
// fragments, RoundFrom; lstm_recur_persistent: as it is staged), never in
// the carry buffers. A bf16 value is exact in TF32, so the products keep
// fp32 accuracy in fewer passes (passes_for<TX, TW>): 2 for an fp32 x
// against bf16 weights (x split big + small), 1 where both operands are
// bf16-valued (a bf16 x; the rounded h against Wh). Bound: the same flops
// at 247.5 TFLOP/s (2 passes) or 989 (1 pass), or the bytes at 3.35 TB/s.
// A simple first version: the bf16 loads are plain loads widened in
// registers (no cp.async for them), not bf16 mma fragments.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int GROUP_UNITS = 8;  // packed columns: 4 gates x 8 units a run

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

template <class TB>
__device__ __forceinline__ void cell(const TB* __restrict__ bias,
                                     float* __restrict__ c,
                                     float* __restrict__ h_next,
                                     float* __restrict__ y, float gi,
                                     float gf, float gg, float go, int row,
                                     int u, int T, int H, int t) {
  gi += to_f(bias[u]);
  gf += to_f(bias[H + u]);
  gg += to_f(bias[2 * H + u]);
  go += to_f(bias[3 * H + u]);
  const size_t ci = (size_t)row * H + u;
  const float cn = sigmoidf(gf) * c[ci] + sigmoidf(gi) * tanhf(gg);
  const float hn = sigmoidf(go) * tanhf(cn);
  c[ci] = cn;
  h_next[ci] = hn;
  y[((size_t)row * T + t) * H + u] = hn;
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

// The bf16 variants' rounding of h: the A fragments' entries at K >= k0
// (the h_{t-1} columns of [x_t | h_{t-1}]) rounded to bf16 before the
// product, where se_tpu's `h.astype(wh.dtype)` rounds them
// (se_tpu/nn/recurrent.py:36-37, pallas_lstm.py:44); the carry in device
// memory stays fp32. Register j of a[mi] holds K index k + lane % 4 + 4 (j
// >> 1) (mma_step's `prep`).
struct RoundFrom {
  int k0;
  __device__ __forceinline__ void operator()(int k,
                                             uint32_t (&a)[2][4]) const {
    const int kl = k + (threadIdx.x & 3);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kl + 4 * (j >> 1) >= k0)
          a[mi][j] = __float_as_uint(round_bf16(__uint_as_float(a[mi][j])));
  }
};

// The TF32 main loop of one TM x TN tile: acc += A[r0 : r0 + TM, :K] .
// w[col0 : col0 + TN, :K]^T, K = In + H. Row r of A is [x_r,t | h_prev_r]:
// x (rows, T, In) read at frame t, h_prev (rows, H; unread when H = 0).
// w: packed (columns, Kp), K-major, zero-padded to whole tiles; rows past
// `rows` and K past In + H are zero-filled by the copies. VEC: 16-byte
// copies of A (In % 4 == 0, H % 4 == 0, x aligned to 4 elements). sm:
// STAGES x (TM + TN) x LDS floats. TX, TW: x's and w's storage (fp32, or
// bf16 widened as it is loaded); PASSES and prep as tc_ring's.
template <bool VEC, int PASSES, class TX, class TW, class Prep>
__device__ __forceinline__ void tc_mainloop(
    float (&acc)[2][4][4], float* sm, const TX* __restrict__ x,
    const float* __restrict__ h_prev, const TW* __restrict__ w, int rows,
    int T, int In, int H, int Kp, int t, int r0, int col0, Prep prep) {
  float* As = sm;                      // STAGES x TM x LDS
  float* Bs = sm + STAGES * TM * LDS;  // STAGES x TN x LDS
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int K = In + H, nk = Kp / TK;
  // a thread's copies: 16-byte chunk cq of rows crow + RSTEP i in every
  // stage (VEC; B always), so their row pointers are set once
  constexpr int CH = TK / 4, RSTEP = TC_THREADS / CH;  // 8 chunks a row
  constexpr int NA = TM / RSTEP, NB = TN / RSTEP;      // rows a thread copies
  const int crow = tid / CH, cq = tid % CH;
  const TW* wq = w + ((size_t)col0 + crow) * Kp + 4 * cq;
  const TX* xrow[NA];
  const float* hrow[NA];
  bool live[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int row = r0 + crow + i * RSTEP;
    live[i] = row < rows;
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
      copy4(bs + i * RSTEP * LDS, wq + (size_t)i * RSTEP * Kp + k0, true);
    if (VEC) {
      const int k = k0 + 4 * cq;
      const bool in_x = k < In, in_k = k < K;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        float* dst = as + (crow + i * RSTEP) * LDS + 4 * cq;
        if constexpr (sizeof(TX) == 4)  // past K: 0 bytes from a valid address
          cp_async16(dst,
                     in_x || !in_k ? xrow[i] + (in_x ? k : 0)
                                   : hrow[i] + (k - In),
                     live[i] && in_k ? 16 : 0);
        else if (in_x)
          copy4(dst, xrow[i] + k, live[i]);
        else if (in_k)
          copy4(dst, hrow[i] + (k - In), live[i]);
        else
          zero4(dst);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < TM * TK / TC_THREADS; ++i) {
        const int e = tid + i * TC_THREADS, r = e / TK, kk = e % TK;
        const int row = r0 + r, k = k0 + kk;
        const bool ok = row < rows && k < K;
        if constexpr (sizeof(TX) == 4) {
          const float* src = x;
          int bytes = 0;
          if (ok) {
            src = k < In ? x + ((size_t)row * T + t) * In + k
                         : h_prev + (size_t)row * H + (k - In);
            bytes = 4;
          }
          cp_async4(as + r * LDS + kk, src, bytes);
        } else if (ok && k < In) {
          copy1(as + r * LDS + kk, x + ((size_t)row * T + t) * In + k, true);
        } else if (ok) {
          cp_async4(as + r * LDS + kk, h_prev + (size_t)row * H + (k - In),
                    4);
        } else {
          as[r * LDS + kk] = 0.f;
        }
      }
    }
  };

  tc_ring<TM, TN, TK, LDS, STAGES, 4, false, PASSES>(
      acc, As, Bs, nk, wm * 32, wn * 32, load_stage, prep);
}

// One frame for TM rows x TU units: the main loop over [x_t | h_{t-1}],
// then the cell. w: pack_weights' (4Hp, Kp). fp32 (TX = TW = float): 3
// TF32 passes. bf16 weights (TW; bias in TW too): h_{t-1} rounded to bf16
// in the fragments (RoundFrom), then 2 passes for an fp32 x, 1 for a bf16
// x (passes_for<TX, TW>); h, c and y stay fp32.
template <bool VEC, class TX, class TW>
__global__ void __launch_bounds__(TC_THREADS, TC_BLOCKS_SM)
lstm_step_tc(const TX* __restrict__ x, const TW* __restrict__ w,
             const TW* __restrict__ bias, const float* __restrict__ h_prev,
             float* __restrict__ h_next, float* __restrict__ c,
             float* __restrict__ y, int Bf, int T, int In, int H, int Kp,
             int t) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tq = lane & 3;  // the mma's group and thread
  // unit tiles vary fastest: the blocks of one row tile run together and
  // read its [x_t | h_{t-1}] from L2 (at FullSubNet's B = 256 a frame's A
  // is 200 MB, the weights 4.7 MB)
  const int r0 = blockIdx.y * TM, u0 = blockIdx.x * TU;
  // acc[m tile][gate][fragment]: rows gid (+8), units 2 tq (+1)
  float acc[2][4][4];
  constexpr int PASSES = passes_for<TX, TW>();
  if constexpr (sizeof(TW) == 4)
    tc_mainloop<VEC, PASSES>(acc, sm, x, h_prev, w, Bf, T, In, H, Kp, t, r0,
                             blockIdx.x * TN, NoPrep());
  else
    tc_mainloop<VEC, PASSES>(acc, sm, x, h_prev, w, Bf, T, In, H, Kp, t, r0,
                             blockIdx.x * TN, RoundFrom{In});

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

// XP = x . Wx + b for all frames at once: the main loop over rows of x
// (M = Bf T rows, K = In), then a store. w: pack_input's (Np, Kp), torch's
// column order (no gate interleave: no cell here). A 1-D grid, column
// tiles fastest, so the blocks of a row tile run together and read it from
// L2. bf16 weights (TW, bias too): 2 TF32 passes for an fp32 x, 1 for a
// bf16 x; XP fp32 either way (se_tpu's preferred_element_type=fp32).
template <bool VEC, class TX, class TW>
__global__ void __launch_bounds__(TC_THREADS, TC_BLOCKS_SM)
lstm_proj_tc(const TX* __restrict__ x, const TW* __restrict__ w,
             const TW* __restrict__ bias, float* __restrict__ xp, int M,
             int In, int N, int Kp) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tq = lane & 3;
  const int ncol = (N + TN - 1) / TN;
  const int col0 = (blockIdx.x % ncol) * TN, r0 = (blockIdx.x / ncol) * TM;
  float acc[2][4][4];
  tc_mainloop<VEC, passes_for<TX, TW>()>(acc, sm, x, nullptr, w, M, 1, In,
                                         0, Kp, 0, r0, col0, NoPrep());

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + wm * 32 + mi * 16 + hh * 8 + gid;
      if (row >= M) continue;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        // N = 4H is even and col is: a float2 stays inside the row
        const int col = col0 + wn * 32 + g * 8 + 2 * tq;
        if (col < N)
          *reinterpret_cast<float2*>(xp + (size_t)row * N + col) =
              make_float2(acc[mi][g][hh * 2] + to_f(bias[col]),
                          acc[mi][g][hh * 2 + 1] + to_f(bias[col + 1]));
      }
    }
}

// ------------------------------------ persistent recurrence (small fold)

constexpr int PU = GROUP_UNITS;  // hidden units a block: 4 PU packed columns
constexpr int PR = 16;           // rows a chunk: one m16 tile
constexpr int PWARPS = 8;        // K split over the block's warps
constexpr int P_THREADS = 32 * PWARPS;
constexpr int P_BLOCKS_SM = 2;   // register cap (__launch_bounds__)
constexpr int RED_LD = 4 * PU + 4;  // partial-sum row stride, floats

// Dynamic shared memory of lstm_recur_persistent (ops/lstm.py
// `persistent_plan` computes the same; through se_lstm_recur_fit the card
// tests and chip_smoke.py check that the two agree): the Wh slice and the
// staged h rows, both with rows of Hk + 4 floats (conflict-free ldmatrix),
// the warps' partial sums, and the block's c.
size_t persistent_smem(int Hk, int chunks) {
  return ((size_t)(4 * PU + PR) * (Hk + 4) + (size_t)PWARPS * PR * RED_LD +
          (size_t)chunks * PR * PU) *
         sizeof(float);
}

// The whole time loop of one layer, one cooperative launch. Block b owns
// units ut * PU .. + PU (ut = b % nu) of the rows of chunks g, g + ng, ...
// (g = b / nu, chunks of PR rows). Its slice of Wh, whp rows 4 PU ut .. +
// 4 PU (pack_recurrent: the i, f, g, o columns of its PU units, K-major,
// zero-padded to Hk), sits in shared memory for the whole layer, and so do
// its c entries. A step, per chunk: stage h_{t-1} of the chunk's rows
// (cp.async.cg: from L2, never a stale L1 line), the 3xTF32 product over
// K = Hk split over the warps, the partial sums through shared memory, the
// cell (thread tid < PR PU owns row tid / PU, unit tid % PU) with the
// gate inputs xp read ahead; h_t goes to the other half of hbuf and to y.
// Then one grid barrier: every block's h_t is written before any block
// reads it. bf16 weights (TW): the slice widened to fp32 as it is loaded
// (the same shared memory as fp32, so the same plan), h_{t-1} rounded to
// bf16 as it is staged, one TF32 pass (both operands bf16-valued); xp, h,
// c and y stay fp32.
template <bool VEC, class TW>
__global__ void __launch_bounds__(P_THREADS, P_BLOCKS_SM)
lstm_recur_persistent(const float* __restrict__ xp,
                      const TW* __restrict__ whp, float* __restrict__ hbuf,
                      float* __restrict__ c, float* __restrict__ y, int Bf,
                      int T, int H, int Hk, int ng, int reverse) {
  extern __shared__ __align__(16) float sm[];
  const int ld = Hk + 4;
  float* Ws = sm;                            // 4 PU x ld
  float* As = Ws + 4 * PU * ld;              // PR x ld
  float* red = As + PR * ld;                 // PWARPS x PR x RED_LD
  float* cs = red + PWARPS * PR * RED_LD;    // chunks x PR x PU
  const int nu = (H + PU - 1) / PU, nr = (Bf + PR - 1) / PR;
  const int ut = blockIdx.x % nu, g0 = blockIdx.x / nu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const size_t half = (size_t)Bf * H, H4 = 4 * (size_t)H;
  // the cell's thread: row er of a chunk, unit eu of the block
  const int er = tid / PU, eu = tid % PU, unit = ut * PU + eu;
  const bool cell_thread = tid < PR * PU && unit < H;
  constexpr bool BF16 = sizeof(TW) == 2;

  const int q4 = Hk / 4;  // 16-byte chunks a row
  const TW* wsrc = whp + (size_t)ut * 4 * PU * Hk;
  for (int e = tid; e < 4 * PU * q4; e += P_THREADS)
    copy4(Ws + (e / q4) * ld + 4 * (e % q4),
          wsrc + (size_t)(e / q4) * Hk + 4 * (e % q4), true);
  cp_async_commit();
  for (int q = g0, j = 0; q < nr; q += ng, ++j) {
    const int row = q * PR + er;
    if (tid < PR * PU)
      cs[j * PR * PU + tid] =
          cell_thread && row < Bf ? c[(size_t)row * H + unit] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // ldmatrix row addresses, as in tc_common.cuh tc_ring: A's m16 tile,
  // B's n8 tiles g and g + 1
  const float* as = As + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                    (lane >> 4) * 4;
  const float* bs = Ws + ((lane >> 4) * 8 + (lane & 7)) * ld +
                    ((lane >> 3) & 1) * 4;
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* hp = hbuf + (size_t)(s & 1) * half;
    float* hn = hbuf + (size_t)((s + 1) & 1) * half;
    for (int q = g0, j = 0; q < nr; q += ng, ++j) {
      const int r0 = q * PR, row = r0 + er;
      const bool live = cell_thread && row < Bf;
      float xg[4] = {0.f, 0.f, 0.f, 0.f};
      if (live) {
        const float* p = xp + ((size_t)row * T + t) * H4 + unit;
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[g] = __ldg(p + g * H);
      }
      // h_{t-1} of rows r0 .. r0 + PR, zero past Bf and past H (bf16:
      // rounded to bf16, where se_tpu's h.astype(wh.dtype) rounds it)
      if (VEC && BF16) {
        for (int e = tid; e < PR * q4; e += P_THREADS) {
          const int r = e / q4, k = 4 * (e % q4);
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r0 + r < Bf && k < H)
            v = __ldcg(reinterpret_cast<const float4*>(
                hp + (size_t)(r0 + r) * H + k));
          *reinterpret_cast<float4*>(As + r * ld + k) =
              make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                          round_bf16(v.w));
        }
      } else if (VEC) {
        for (int e = tid; e < PR * q4; e += P_THREADS) {
          const int r = e / q4, k = 4 * (e % q4);
          const bool in = r0 + r < Bf && k < H;
          cp_async16(As + r * ld + k,
                     in ? hp + (size_t)(r0 + r) * H + k : hp, in ? 16 : 0);
        }
        cp_async_commit();
        cp_async_wait<0>();
      } else {
        for (int e = tid; e < PR * Hk; e += P_THREADS) {
          const int r = e / Hk, k = e % Hk;
          const float v = r0 + r < Bf && k < H
                              ? __ldcg(hp + (size_t)(r0 + r) * H + k)
                              : 0.f;
          As[r * ld + k] = BF16 ? round_bf16(v) : v;
        }
      }
      __syncthreads();

      float acc[4][4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
      for (int kk = warp * 8; kk < Hk; kk += PWARPS * 8) {
        uint32_t a[4], b[4][2], a_big[4], a_small[4], b_big[4][2],
            b_small[4][2];
        ldsm_x4(a, as + kk);
        ldsm_x4(b[0], bs + kk);
        ldsm_x4(b[2], bs + 16 * ld + kk);
        if constexpr (BF16) {  // bf16-valued operands: one exact pass
#pragma unroll
          for (int g = 0; g < 4; ++g) mma_tf32(acc[g], a, b[g]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_tf32(__uint_as_float(a[i]), a_big[i], a_small[i]);
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              split_tf32(__uint_as_float(b[g][i]), b_big[g][i],
                         b_small[g][i]);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            mma_tf32(acc[g], a_small, b_big[g]);
            mma_tf32(acc[g], a_big, b_small[g]);
            mma_tf32(acc[g], a_big, b_big[g]);
          }
        }
      }
      // acc[g]: rows gid (+8), packed columns g PU + 2 tq (+1)
      float* rw = red + warp * PR * RED_LD;
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rw[(gid + (i >> 1) * 8) * RED_LD + g * PU + 2 * tq + (i & 1)] =
              acc[g][i];
      __syncthreads();  // the partial sums are in; As may be restaged

      if (live) {
        float gs[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float sum = xg[g];
#pragma unroll
          for (int w = 0; w < PWARPS; ++w)
            sum += red[(w * PR + er) * RED_LD + g * PU + eu];
          gs[g] = sum;
        }
        float& cc = cs[j * PR * PU + tid];
        const float cn = sigmoidf(gs[1]) * cc + sigmoidf(gs[0]) * tanhf(gs[2]);
        const float hv = sigmoidf(gs[3]) * tanhf(cn);
        cc = cn;
        hn[(size_t)row * H + unit] = hv;
        y[((size_t)row * T + t) * H + unit] = hv;
      }
    }
    if (s + 1 < T) grid.sync();  // h_t of every block in before step s + 1
  }
  for (int q = g0, j = 0; q < nr; q += ng, ++j) {
    const int row = q * PR + er;
    if (cell_thread && row < Bf)
      c[(size_t)row * H + unit] = cs[j * PR * PU + tid];
  }
}

template <class K>
cudaError_t max_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

template <bool VEC, class TX, class TW>
int run_tc(const TX* x, const TW* wp, const TW* b, float* hbuf, float* c,
           float* y, int Bf, int T, int In, int H, int Hp, int Kp,
           int reverse, cudaStream_t st) {
  auto kernel = lstm_step_tc<VEC, TX, TW>;
  cudaError_t err = max_smem(kernel, TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hp / TU, (Bf + TM - 1) / TM);
  const size_t half = (size_t)Bf * H;
  for (int s = 0; s < T; ++s) {
    kernel<<<grid, TC_THREADS, TC_SMEM, st>>>(
        x, wp, b, hbuf + (s & 1) * half, hbuf + ((s + 1) & 1) * half, c, y,
        Bf, T, In, H, Kp, reverse ? T - 1 - s : s);
    if (s == 0 && (err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <bool VEC, class TX, class TW>
int run_proj(const TX* x, const TW* wp, const TW* b, float* xp, int M,
             int In, int N, int Kp, cudaStream_t st) {
  auto kernel = lstm_proj_tc<VEC, TX, TW>;
  cudaError_t err = max_smem(kernel, TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((N + TN - 1) / TN) * ((M + TM - 1) / TM);
  kernel<<<(unsigned)blocks, TC_THREADS, TC_SMEM, st>>>(x, wp, b, xp, M, In,
                                                        N, Kp);
  return (int)cudaGetLastError();
}

template <bool VEC, class TW>
int run_recur(const float* xp, const TW* whp, float* hbuf, float* c,
              float* y, int Bf, int T, int H, int Hk, int ng, int reverse,
              cudaStream_t st) {
  const int nu = (H + PU - 1) / PU, nr = (Bf + PR - 1) / PR;
  const unsigned blocks = (unsigned)nu * ng;
  const size_t smem = persistent_smem(Hk, (nr + ng - 1) / ng);
  auto kernel = lstm_recur_persistent<VEC, TW>;
  cudaError_t err = max_smem(kernel, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        P_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  // every block resident, or the grid barrier would never open
  if ((long)per_sm * sms < (long)blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&xp, (void*)&whp, (void*)&hbuf, (void*)&c,
                  (void*)&y,  (void*)&Bf,  (void*)&T,    (void*)&H,
                  (void*)&Hk, (void*)&ng,  (void*)&reverse};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                    dim3(P_THREADS), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// x aligned to 4 of its elements: the 16-byte (fp32) or 8-byte (bf16)
// copies of VEC
template <class TX>
bool aligned4(const TX* x) {
  return reinterpret_cast<uintptr_t>(x) % (4 * sizeof(TX)) == 0;
}

template <class TX, class TW>
int layer(const TX* x, const TW* wp, const TW* b, float* hbuf, float* c,
          float* y, int Bf, int T, int In, int H, int Hp, int Kp, int reverse,
          void* stream) {
  if (Hp % TU != 0 || Hp < H || Kp % TK != 0 || Kp < In + H)
    return (int)cudaErrorInvalidValue;
  const bool vec = In % 4 == 0 && H % 4 == 0 && aligned4(x);
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? run_tc<true>(x, wp, b, hbuf, c, y, Bf, T, In, H, Hp, Kp,
                            reverse, st)
             : run_tc<false>(x, wp, b, hbuf, c, y, Bf, T, In, H, Hp, Kp,
                             reverse, st);
}

template <class TX, class TW>
int project(const TX* x, const TW* wp, const TW* b, float* xp, int M, int In,
            int N, int Kp, void* stream) {
  if (Kp % TK != 0 || Kp < In || N % 2 != 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const bool vec = In % 4 == 0 && aligned4(x);
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? run_proj<true>(x, wp, b, xp, M, In, N, Kp, st)
             : run_proj<false>(x, wp, b, xp, M, In, N, Kp, st);
}

template <class TW>
int recur(const float* xp, const TW* whp, float* hbuf, float* c, float* y,
          int Bf, int T, int H, int Hk, int ng, int reverse, void* stream) {
  const int nr = (Bf + PR - 1) / PR;
  if (Hk % PU != 0 || Hk < H || ng < 1 || ng > nr)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return H % 4 == 0
             ? run_recur<true>(xp, whp, hbuf, c, y, Bf, T, H, Hk, ng,
                               reverse, st)
             : run_recur<false>(xp, whp, hbuf, c, y, Bf, T, H, Hk, ng,
                                reverse, st);
}

template <class TW>
int recur_fit(int H, int Hk, int chunks, long* smem, int* per_sm) {
  if (Hk % PU != 0 || Hk < H || chunks < 1) return (int)cudaErrorInvalidValue;
  *smem = (long)persistent_smem(Hk, chunks);
  auto fit = [&](auto kernel) {
    cudaError_t err = max_smem(kernel, (size_t)*smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                          P_THREADS, *smem);
    return (int)err;
  };
  return H % 4 == 0 ? fit(lstm_recur_persistent<true, TW>)
                    : fit(lstm_recur_persistent<false, TW>);
}

using bf16 = __nv_bfloat16;

}  // namespace

// The large fold, one lstm_step_tc a frame. x (Bf, T, In); wp: pack_weights'
// (4Hp, Kp) (Hp a multiple of 16 and Kp of 32, neither below H and In + H);
// b (4H); hbuf (2, Bf, H) with h0 in its first half; c (Bf, H) holding c0,
// updated in place; y (Bf, T, H). After the call h_T is in half T % 2 of
// hbuf and c_T in c.
extern "C" int se_lstm_layer(const float* x, const float* wp, const float* b,
                             float* hbuf, float* c, float* y, int Bf, int T,
                             int In, int H, int Hp, int Kp, int reverse,
                             void* stream) {
  return layer(x, wp, b, hbuf, c, y, Bf, T, In, H, Hp, Kp, reverse, stream);
}

// The same with bf16 weights: wp and b bf16, x fp32 or bf16 (x_bf16);
// hbuf, c and y fp32, h rounded to bf16 only where the product takes it.
extern "C" int se_lstm_layer_bf16(const void* x, int x_bf16, const bf16* wp,
                                  const bf16* b, float* hbuf, float* c,
                                  float* y, int Bf, int T, int In, int H,
                                  int Hp, int Kp, int reverse, void* stream) {
  return x_bf16 ? layer(static_cast<const bf16*>(x), wp, b, hbuf, c, y, Bf,
                        T, In, H, Hp, Kp, reverse, stream)
                : layer(static_cast<const float*>(x), wp, b, hbuf, c, y, Bf,
                        T, In, H, Hp, Kp, reverse, stream);
}

// The small fold's projection: xp (M, N) = x (M, In) . Wx + b, N = 4H. wp:
// pack_input's (Np, Kp), Np = N and Kp = In rounded up to 64 and 32.
extern "C" int se_lstm_project(const float* x, const float* wp,
                               const float* b, float* xp, int M, int In,
                               int N, int Kp, void* stream) {
  return project(x, wp, b, xp, M, In, N, Kp, stream);
}

// The same with bf16 weights (wp, b), x fp32 or bf16 (x_bf16), xp fp32.
extern "C" int se_lstm_project_bf16(const void* x, int x_bf16,
                                    const bf16* wp, const bf16* b, float* xp,
                                    int M, int In, int N, int Kp,
                                    void* stream) {
  return x_bf16 ? project(static_cast<const bf16*>(x), wp, b, xp, M, In, N,
                          Kp, stream)
                : project(static_cast<const float*>(x), wp, b, xp, M, In, N,
                          Kp, stream);
}

// The small fold's recurrence over xp (Bf, T, 4H), one cooperative launch:
// whp pack_recurrent's (4Hk, Hk), Hk = H rounded up to 8; hbuf, c and y as
// se_lstm_layer's; ng row groups (ops/lstm.py `persistent_plan`), so the
// grid is ceil(H / 8) ng blocks, every one resident or the call fails.
extern "C" int se_lstm_recur(const float* xp, const float* whp, float* hbuf,
                             float* c, float* y, int Bf, int T, int H, int Hk,
                             int ng, int reverse, void* stream) {
  return recur(xp, whp, hbuf, c, y, Bf, T, H, Hk, ng, reverse, stream);
}

// The same with a bf16 whp (xp, hbuf, c and y fp32).
extern "C" int se_lstm_recur_bf16(const float* xp, const bf16* whp,
                                  float* hbuf, float* c, float* y, int Bf,
                                  int T, int H, int Hk, int ng, int reverse,
                                  void* stream) {
  return recur(xp, whp, hbuf, c, y, Bf, T, H, Hk, ng, reverse, stream);
}

// What se_lstm_recur would ask for at H with `chunks` row chunks a block:
// the dynamic shared memory of a block (*smem) and the blocks an SM the
// occupancy API allows at that size (*per_sm). ops/lstm.py `recur_fit`
// holds its own plan (`persistent_smem`, PERSIST_BLOCKS_SM) against these.
extern "C" int se_lstm_recur_fit(int H, int Hk, int chunks, long* smem,
                                 int* per_sm) {
  return recur_fit<float>(H, Hk, chunks, smem, per_sm);
}

// The same for se_lstm_recur_bf16's kernel (the same shared memory: its
// slice is widened to fp32 as it is loaded).
extern "C" int se_lstm_recur_fit_bf16(int H, int Hk, int chunks, long* smem,
                                      int* per_sm) {
  return recur_fit<bf16>(H, Hk, chunks, smem, per_sm);
}
