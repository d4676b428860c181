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
// (half the fp32 packs' bytes). x is fp32 or bf16 (x_bf16); XP, h, c and y
// are fp32. The one rounding point inside is se_tpu's `h.astype(wh.dtype)`:
// h_{t-1} rounded to bf16 (to nearest even) where the product takes it,
// never in the carry buffers; x . Wx is the exact fp32 product.
//   - The small fold's projection, lstm_proj_bf16: tc_common.cuh's bf16
//     ring (bfr::ring, the decoder's and encoder's) over K stages of 32,
//     64 x 64 tiles of 2 x 2 warps, a 1-D grid with the column tiles
//     fastest. The weights are pack_input's in bf16; an fp32 x is staged
//     fp32 and split in three bf16 pieces in the fragments, a bf16 x read
//     by ldmatrix as it is; XP fp32. Bound: x . Wx at 989 / 3 TFLOP/s
//     (fp32 x) or 989 (bf16 x), or its bytes; at LSTMNet's B = 4 the
//     bytes of XP (26 MB a call) and the operations are of one order.
//   - The small fold's recurrence, lstm_recur_bf16: lstm_recur_persistent's
//     grid and grid barrier a frame, on bf16 mma.sync.m16n8k16. Its bound
//     by operations (round(h) . Wh at 989 TFLOP/s: 14 us a LSTMNet call)
//     is far below what sets its time: a chain of T frames, each an L2
//     round trip for h, the product, the partial sums and the cell, and a
//     grid barrier. What it does about the chain:
//     + the Wh slice stays bf16 in shared memory (64 KB at H = 1024 for 16
//       units: a block can own 16 units, so half the blocks meet at the
//       barrier), copied once by cp.async in K tiles of 32 (bfr::swz16)
//       and read by ldmatrix as B fragments;
//     + h comes from the shadow the step kernel uses: each cell writes
//       h_t rounded to bf16 beside its fp32 h and y, and the next frame
//       copies the rows by 16-byte cp.async.cg (half the fp32 bytes, no
//       rounding on the way in), one bf16 product a k16;
//     + each warp copies and waits for its own K slice of the rows alone
//       (no block barrier before the product), and restages it for the
//       block's next row chunk as soon as its fragments are read;
//     + XP's gate inputs are read a frame ahead, at the start of the frame
//       before (read just before the barrier, thread 0's fence in
//       grid.sync waited for them: 4% slower at LSTMNet's shape).
//     What is left is the chain itself: 2.2-2.3 us a frame at H = 128
//     with 8-16 blocks, 3.5 at H = 1024 (PERF.md, PR 22).
//     Units a block and warps are template parameters, in three designs
//     (16 x 8, 16 x 4, 8 x 4); the wrapper's plan takes, of the designs
//     for its H, the one with the fewest row chunks a block (ops/lstm.py
//     recur_bf16_designs, measured by lstm_bf16_sweep.py recur).
//   - The large fold's lstm_step_bf16 runs on bf16 tensor cores instead
//     (mma.sync.m16n8k16 bf16, fp32 accumulate). Bound: x . Wx at 989 / 3
//     TFLOP/s for an fp32 x (three bf16 products, the fewest exact; 989
//     for a bf16 x), round(h) . Wh at 989, or the bytes at 3.35 TB/s:
//     by operations at every shape the paths use. What it does about it:
//     + Two K loops a frame, not one mixed K: pack_weights_bf16 (ops/
//       lstm.py) lays Wx's rows zero-padded to Kx (In rounded up to the
//       32-deep stage BK), then Wh's to Kh, so a stage is wholly x or
//       wholly h and the fragments need no per-element K test.
//     + The weights stay bf16: 16-byte cp.async copies into a ring of
//       bf16 shared memory (4 stages for an fp32 x, 6 for a bf16 one: 48
//       KB, four blocks an SM), rows unpadded and swizzled (swz16: the 8
//       rows of an ldmatrix matrix in 8 bank groups; the 64-byte swizzle
//       of wgmma's K-major layout), read by ldmatrix as B fragments.
//     + h in one pass: each frame's cell also writes h_t rounded to bf16
//       into a shadow, a ping-pong pair (2, Bf, Kh) zero past H (16-byte
//       rows for any H; the wrapper fills its first half with h0 rounded
//       alike), which the next frame stages by cp.async and reads by
//       ldmatrix as A fragments: one bf16 mma a k16.
//     + An fp32 x is staged as fp32 (swz32) and split in the fragments in
//       three bf16 pieces (tc_common.cuh split_bf16x3: their sum is x bit
//       for bit down to |x| ~ 1e-33, each piece's product with a bf16
//       weight exact in fp32): three mmas a k16 on one B fragment, against
//       the four TF32 instructions of two TF32 passes. A bf16 x takes one
//       (the wrapper pads In to a multiple of 8 where it is not: LSTMNet's
//       161). x is never split in device memory (at FullSubNet's B = 256
//       that would add ~38 GB).
//     + The block tile (64 rows x 16 units x 4 gates, 4 warps), a launch
//       a frame and the grid order (unit tiles fastest) are the fp32
//       step's, and so are the packed gate interleave and the cell in
//       registers (m16n8k16's accumulator layout is m16n8k8's). The warps
//       take one of two layouts (ops/lstm.py bf16_step_design, from
//       lstm_bf16_sweep.py): where the x part is at least as long as the
//       h part, one m16 tile x 8 n8 tiles a warp (wgmma's m64n64 split:
//       each fp32 x fragment split by one warp, not two) and the frames
//       after the first launched as programmatic dependents (a frame's
//       blocks start once every block of the frame before has, run their x
//       stages, then wait, griddepcontrol.wait, before they read the shadow
//       and c: the x part overlaps the frame before's tail); else two m16
//       x 4 n8 tiles a warp (20% fewer ldmatrix bytes a k16 for the h
//       stages, which shared memory's bandwidth bounds) and plain launches
//       (early blocks there only slow the frame before's h stages).
//     + The epilogue's bias is read before the main loop and c right after
//       the wait, so their latency hides under the mmas.
//   - Not here: wgmma + TMA (the 64 x 64 tile is one warpgroup tile, B's
//     layout is wgmma's 64-byte swizzle; ldmatrix then leaves the loop and
//     the warpgroup shares A and B in shared memory, half the bytes a k16
//     of mma.sync's 2 x 2 warps), CUDA graphs, a persistent time loop.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int GROUP_UNITS = 8;  // packed columns: 4 gates x 8 units a run

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// The cell from the four gate inputs (biases in): c updated in place;
// returns h_t.
__device__ __forceinline__ float lstm_cell(float gi, float gf, float gg,
                                           float go, float& c) {
  c = sigmoidf(gf) * c + sigmoidf(gi) * tanhf(gg);
  return sigmoidf(go) * tanhf(c);
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
  float cn = c[ci];
  const float hn = lstm_cell(gi, gf, gg, go, cn);
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

// The TF32 main loop of one TM x TN tile: acc += A[r0 : r0 + TM, :K] .
// w[col0 : col0 + TN, :K]^T, K = In + H. Row r of A is [x_r,t | h_prev_r]:
// x (rows, T, In) read at frame t, h_prev (rows, H; unread when H = 0).
// w: packed (columns, Kp), K-major, zero-padded to whole tiles; rows past
// `rows` and K past In + H are zero-filled by the copies. VEC: 16-byte
// copies of A (In % 4 == 0, H % 4 == 0, x aligned to 4 elements). sm:
// STAGES x (TM + TN) x LDS floats; PASSES as tc_ring's.
template <bool VEC, int PASSES>
__device__ __forceinline__ void tc_mainloop(
    float (&acc)[2][4][4], float* sm, const float* __restrict__ x,
    const float* __restrict__ h_prev, const float* __restrict__ w, int rows,
    int T, int In, int H, int Kp, int t, int r0, int col0) {
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
  const float* wq = w + ((size_t)col0 + crow) * Kp + 4 * cq;
  const float* xrow[NA];
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
        const bool ok = row < rows && k < K;
        const float* src = x;
        int bytes = 0;
        if (ok) {
          src = k < In ? x + ((size_t)row * T + t) * In + k
                       : h_prev + (size_t)row * H + (k - In);
          bytes = 4;
        }
        cp_async4(as + r * LDS + kk, src, bytes);
      }
    }
  };

  tc_ring<TM, TN, TK, LDS, STAGES, 4, false, PASSES>(
      acc, As, Bs, nk, wm * 32, wn * 32, load_stage);
}

// One frame for TM rows x TU units: the main loop over [x_t | h_{t-1}],
// then the cell. w: pack_weights' (4Hp, Kp). fp32: 3 TF32 passes (the bf16
// weights take lstm_step_bf16).
template <bool VEC>
__global__ void __launch_bounds__(TC_THREADS, TC_BLOCKS_SM)
lstm_step_tc(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, const float* __restrict__ h_prev,
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
  tc_mainloop<VEC, 3>(acc, sm, x, h_prev, w, Bf, T, In, H, Kp, t, r0,
                      blockIdx.x * TN);

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

// ------------------------------------ bf16 step (bf16 tensor cores)

// Programmatic dependent launch (sm_90): let the next frame's grid start
// (launch_dependents), and wait until the frame before has finished and
// its writes are visible (wait; at once where the launch was not
// programmatic).
__device__ __forceinline__ void dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

constexpr int BK = 32;  // K a stage: two k16 steps, 4 16-byte chunks of a
                        // bf16 row, 8 of an fp32 one
// a ring slot, in bytes: A (TM rows of x, fp32 or bf16, or of the bf16
// shadow of h) and B (TN packed bf16 weight columns), unpadded (swizzled)
template <class TX>
__host__ __device__ constexpr int bf_a_slot() {
  return TM * BK * (int)sizeof(TX);
}
constexpr int BF_B_SLOT = TN * BK * 2;
// the ring's depth: 4 stages of 12 KB (fp32 x) or 6 of 8 KB (bf16 x), 48
// KB a block either way, four blocks an SM
template <class TX>
__host__ __device__ constexpr int bf_stages() {
  return sizeof(TX) == 4 ? 4 : 6;
}
template <class TX>
__host__ __device__ constexpr int bf_smem() {
  return bf_stages<TX>() * (bf_a_slot<TX>() + BF_B_SLOT);
}
// Element offsets in the swizzled tiles (rows of BK, no padding):
// bf16, 16-byte chunk c of row r at chunk c ^ ((r >> 1) & 3), so the 8 rows
// an ldmatrix matrix reads fall in 8 distinct bank groups; fp32, chunk c
// (4 floats) of row r at c ^ 2 (r & 3), so the float2 fragment reads of a
// half-warp (4 rows x 2 chunks) do. Both keep a thread's copies 16 bytes.
__device__ __forceinline__ int swz16(int r, int c) {
  return r * BK + ((c ^ ((r >> 1) & 3)) << 3);
}
__device__ __forceinline__ int swz32(int r, int c) {
  return r * BK + ((c ^ ((r & 3) << 1)) << 2);
}

// One frame of the bf16 layer for TM rows x TU units on bf16 mma.sync
// (m16n8k16, fp32 accumulate), then the cell. w: pack_weights_bf16's (4Hp,
// Kx + Kh), K-major: Wx's rows zero-padded to Kx, then Wh's to Kh (both
// multiples of BK), so a K stage is wholly x or wholly h. x (Bf, T, In):
// fp32 or bf16, In a multiple of 8 and x 16-byte aligned (the wrapper pads
// where not). hs_prev / hs_next: the bf16 shadow of h, (Bf, Kh) each, h
// rounded to bf16 (nearest even) by the frame before, zero past H. The x
// stages take three bf16 mmas a k16 for an fp32 x (split_bf16x3 in the
// fragments: exact products, as se_tpu's fp32 x . bf16 Wx), one for a bf16
// x; the h stages one (the shadow is bf16 already). h_t goes to h_next
// and y in fp32 and, rounded, to hs_next; c stays fp32. MT: m16 tiles a
// warp (1: 4 x 1 warps of 16 x 64; 2: 2 x 2 of 32 x 32). Every frame lets
// the next start (dep_launch) and reads what the frame before wrote (the
// shadow, c) only after dep_wait, so either launch mode is safe.
template <class TX, int MT>
__global__ void __launch_bounds__(TC_THREADS, TC_BLOCKS_SM)
lstm_step_bf16(const TX* __restrict__ x, const bf16* __restrict__ w,
               const bf16* __restrict__ bias,
               const bf16* __restrict__ hs_prev, bf16* __restrict__ hs_next,
               float* __restrict__ h_next, float* __restrict__ c,
               float* __restrict__ y, int Bf, int T, int In, int H, int Kx,
               int Kh, int t) {
  extern __shared__ __align__(16) unsigned char smb[];
  dep_launch();
  constexpr bool XF = sizeof(TX) == 4;
  constexpr int STAGES = bf_stages<TX>(), A_SLOT = bf_a_slot<TX>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.y * TM, u0 = blockIdx.x * TU;
  const int Kp = Kx + Kh, nkx = Kx / BK, nk = Kp / BK;
  auto a_slot = [&](int slot) { return smb + slot * A_SLOT; };
  auto b_slot = [&](int slot) {
    return reinterpret_cast<bf16*>(smb + STAGES * A_SLOT + slot * BF_B_SLOT);
  };

  // a thread's 16-byte copies in every stage, so their row pointers and
  // (swizzled) destinations are set once: chunk bq of bf16 rows brow + 32 i
  // (B, the shadow, a bf16 x), chunk xq of x's rows xr + XR i
  constexpr int XE = 16 / sizeof(TX);            // x elements a chunk
  constexpr int XN = TM * BK / XE / TC_THREADS;  // x chunks a thread
  constexpr int XR = TC_THREADS * XE / BK;       // their row step
  const int brow = tid >> 2, bq = tid & 3;
  const int xr = tid / (BK / XE), xq = tid % (BK / XE);
  const int b_dst = swz16(brow, bq);
  const int x_dst = XF ? swz32(xr, xq) : swz16(xr, xq);
  const bf16* wq = w + (size_t)(blockIdx.x * TN + brow) * Kp + 8 * bq;
  const bf16* hrow[2];
  bool hlive[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + brow + 32 * i;
    hlive[i] = row < Bf;
    hrow[i] = hs_prev + (size_t)(hlive[i] ? row : 0) * Kh + 8 * bq;
  }
  const TX* xrow[XN];
  bool xlive[XN];
#pragma unroll
  for (int i = 0; i < XN; ++i) {
    const int row = r0 + xr + XR * i;
    xlive[i] = row < Bf;
    xrow[i] = x + ((size_t)(xlive[i] ? row : 0) * T + t) * In + XE * xq;
  }

  // the warp's tile: MT m16 tiles (rows wm 16 MT ..) x NT n8 tiles (packed
  // columns wn 8 NT ..; n8 tile 4 q + g of the warp is gate g of its unit
  // group q: pack_weights' interleave); MT = 1 is wgmma's m64n64 split of
  // the block tile over its 4 warps
  constexpr int NT = 8 / MT, WMB = 4 / MT, NQ = NT / 4;
  const int wm = warp % WMB, wn = warp / WMB;
  const int ue = u0 + 8 * NQ * wn + 2 * tq;   // even; units ue + 8 q (+1)
  const int row0 = r0 + 16 * MT * wm + gid;   // rows row0 + 16 mi (+8)
  // c of the thread's rows and units, read when the frame before has
  // finished (it writes c), ahead of the h stages
  float c2[MT][NQ][2][2];
  auto fetch_c = [&]() {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + 16 * mi + 8 * hh, u = ue + 8 * q;
          const float* cp = c + (size_t)(row < Bf ? row : 0) * H + u;
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
            c2[mi][q][hh][cc] = row < Bf && u + cc < H ? cp[cc] : 0.f;
        }
  };

  // stage kt into ring slot `slot`; rows past Bf and x past In zero-filled
  // (XR and 32 keep a row's swizzle)
  auto load = [&](int kt, int slot) {
    bf16* bs = b_slot(slot) + b_dst;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      cp_async16(bs + 32 * i * BK, wq + (size_t)32 * i * Kp + kt * BK, 16);
    if (kt < nkx) {
      const int k = kt * BK;
      TX* as = reinterpret_cast<TX*>(a_slot(slot)) + x_dst;
#pragma unroll
      for (int i = 0; i < XN; ++i) {
        const bool ok = xlive[i] && k + XE * xq < In;
        cp_async16(as + XR * i * BK, ok ? xrow[i] + k : x, ok ? 16 : 0);
      }
    } else {
      if (kt == nkx) {  // the shadow and c are the frame before's
        dep_wait();
        fetch_c();
      }
      const int k = (kt - nkx) * BK;
      bf16* as = reinterpret_cast<bf16*>(a_slot(slot)) + b_dst;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        cp_async16(as + 32 * i * BK, hrow[i] + k, hlive[i] ? 16 : 0);
    }
  };
  // wait for stage kt, queue stage kt + STAGES - 1 into the slot stage
  // kt - 1 held (every warp is past it: the barrier); stage kt's slot
  auto advance = [&](int kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < nk) load(next, next % STAGES);
    cp_async_commit();
    return kt % STAGES;
  };

  // acc[mi][n8 tile][fragment]: rows gid (+8) of m tile mi, packed
  // columns 2 tq (+1) of the n8 tile
  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  // the epilogue's bias, read ahead of the main loop, which hides its
  // latency: the four gates' at units ue + 8 q (+1) (bf16 pairs, zero past
  // H)
  uint32_t bias2[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int u = ue + 8 * q;
      const unsigned short* bp =
          reinterpret_cast<const unsigned short*>(bias + g * H + u);
      bias2[q][g] = (u < H ? (uint32_t)__ldg(bp) : 0u) |
                    (u + 1 < H ? (uint32_t)__ldg(bp + 1) << 16 : 0u);
    }
  // ldmatrix addresses, in bf16 elements, for k16 step p of a stage (k
  // 16 p): A's m16 x k16 tiles (matrices rows +0 / +8, k +0 / +8), B's n8 x
  // k16 tiles j and j + 1 (k +0 / +8 of each) from row 8 j; every row a
  // lane names has the swizzle (lane >> 1) & 3 (its tile's first row is a
  // multiple of 8)
  const int sw = (lane >> 1) & 3;
  const int a_row = 16 * MT * wm + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_row = 8 * NT * wn + (lane & 7) + (lane >> 4) * 8;
  int a_ld[2], b_ld[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    a_ld[p] = a_row * BK + (((2 * p + (lane >> 4)) ^ sw) << 3);
    b_ld[p] = b_row * BK + (((2 * p + ((lane >> 3) & 1)) ^ sw) << 3);
  }
  auto load_b = [&](const bf16* bs, int p, uint32_t (&b)[NT][2]) {
#pragma unroll
    for (int j = 0; j < NT; j += 2) ldsm_x4(b[j], bs + b_ld[p] + j * 8 * BK);
  };
  int kt = 0;
  if constexpr (XF) {
    // fp32 x: register i of m tile mi's A fragment is row gid (+8 for i
    // odd), k 2 tq, 2 tq + 1 (+8 for i >= 2) of the k16 step: a float2,
    // split in three bf16 pieces. x_ld[p]: the offset of its k 8 p, row
    // 16 MT wm + gid
    int x_ld[4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      x_ld[p] = (16 * MT * wm + gid) * BK +
                (((2 * p + (tq >> 1)) ^ ((gid & 3) << 1)) << 2) +
                2 * (tq & 1);
    for (; kt < nkx; ++kt) {
      const int slot = advance(kt);
      const float* xs = reinterpret_cast<const float*>(a_slot(slot));
      const bf16* bs = b_slot(slot);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t hi[MT][4], mid[MT][4], lo[MT][4], b[NT][2];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_bf16x3(*reinterpret_cast<const float2*>(
                             xs + x_ld[2 * p + (i >> 1)] +
                             (16 * mi + 8 * (i & 1)) * BK),
                         hi[mi][i], mid[mi][i], lo[mi][i]);
        load_b(bs, p, b);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            mma_bf16(acc[mi][j], lo[mi], b[j]);
            mma_bf16(acc[mi][j], mid[mi], b[j]);
            mma_bf16(acc[mi][j], hi[mi], b[j]);
          }
      }
    }
  }
  // a bf16 x and the shadow of h: one pass
  for (; kt < nk; ++kt) {
    const int slot = advance(kt);
    const bf16* as = reinterpret_cast<const bf16*>(a_slot(slot));
    const bf16* bs = b_slot(slot);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldsm_x4(a[mi], as + a_ld[p] + 16 * mi * BK);
      load_b(bs, p, b);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[mi][j], a[mi], b[j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 16 * mi + 8 * hh, u = ue + 8 * q;
        if (row >= Bf || u >= H) continue;
        float hv[2];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          float g4[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float2 bv = unpack_bf16x2(bias2[q][g]);
            g4[g] = acc[mi][4 * q + g][2 * hh + cc] + (cc ? bv.y : bv.x);
          }
          hv[cc] = lstm_cell(g4[0], g4[1], g4[2], g4[3], c2[mi][q][hh][cc]);
        }
        const size_t ci = (size_t)row * H + u;
        bf16* hs = hs_next + (size_t)row * Kh + u;
        float* yr = y + ((size_t)row * T + t) * H + u;
        c[ci] = c2[mi][q][hh][0];
        h_next[ci] = hv[0];
        yr[0] = hv[0];
        if (u + 1 < H) {
          c[ci + 1] = c2[mi][q][hh][1];
          h_next[ci + 1] = hv[1];
          yr[1] = hv[1];
          *reinterpret_cast<uint32_t*>(hs) = pack_bf16x2(hv[0], hv[1]);
        } else {
          *hs = __float2bfloat16_rn(hv[0]);
        }
      }
}

// XP = x . Wx + b for all frames at once: the main loop over rows of x
// (M = Bf T rows, K = In), then a store. w: pack_input's (Np, Kp), torch's
// column order (no gate interleave: no cell here). A 1-D grid, column
// tiles fastest, so the blocks of a row tile run together and read it from
// L2. (bf16 weights: lstm_proj_bf16.)
template <bool VEC>
__global__ void __launch_bounds__(TC_THREADS, TC_BLOCKS_SM)
lstm_proj_tc(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ xp, int M,
             int In, int N, int Kp) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tq = lane & 3;
  const int ncol = (N + TN - 1) / TN;
  const int col0 = (blockIdx.x % ncol) * TN, r0 = (blockIdx.x / ncol) * TM;
  float acc[2][4][4];
  tc_mainloop<VEC, 3>(acc, sm, x, nullptr, w, M, 1, In, 0, Kp, 0, r0, col0);

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
              make_float2(acc[mi][g][hh * 2] + bias[col],
                          acc[mi][g][hh * 2 + 1] + bias[col + 1]);
      }
    }
}

// The same on bf16 tensor cores for bf16 weights (lstm.cu header, "bf16"):
// tc_common.cuh bfr::ring over K stages of 32, a 1-D grid of TM x
// PROJ_COLS tiles (column tiles fastest). x (M, In) fp32 or bf16, In a
// multiple of 8 elements and x 16-byte aligned (ops/lstm.py aligned_x), K
// past In zero-filled by the copies; w pack_input's (Np, Kp) in bf16, rows
// past N zero-filled too. An fp32 x is staged fp32 (swz32) and split in
// three bf16 pieces in the fragments (split3: exact products, as se_tpu's
// fp32 x . bf16 Wx), a bf16 x (swz16) read as it is; XP = the fp32 sums
// plus the bf16 bias, stored fp32.
constexpr int PROJ_NT = 4;       // n8 tiles a warp: 2 x 2 warps of 32 x 32
constexpr int PROJ_STAGES = 4;   // bf16 ring depth
constexpr int PROJ_BLOCKS = 3;   // register cap: 168 a thread (an fp32
                                 // x's three pieces spill at 128)
constexpr int PROJ_COLS = WN * PROJ_NT * 8;  // packed columns a block
template <class TX>
__host__ __device__ constexpr int proj_bf16_smem() {
  return PROJ_STAGES *
         (TM * bfr::BK * (int)sizeof(TX) + PROJ_COLS * bfr::BK * 2);
}

template <class TX>
__global__ void __launch_bounds__(TC_THREADS, PROJ_BLOCKS)
lstm_proj_bf16(const TX* __restrict__ x, const bf16* __restrict__ w,
               const bf16* __restrict__ bias, float* __restrict__ xp, int M,
               int In, int N, int Kp) {
  extern __shared__ __align__(16) unsigned char smb[];
  constexpr bool XF = sizeof(TX) == 4;
  constexpr int XE = 16 / sizeof(TX);             // x elements a chunk
  constexpr int XC = bfr::BK / XE;                // chunks a row
  constexpr int XR = TC_THREADS / XC;             // x rows a pass
  constexpr int NA = TM / XR, NB = PROJ_COLS / 32;  // passes of A, of B
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tq = lane & 3;
  const int ncol = (N + PROJ_COLS - 1) / PROJ_COLS;
  const int col0 = (blockIdx.x % ncol) * PROJ_COLS;
  const int r0 = (blockIdx.x / ncol) * TM;
  // a thread's 16-byte copies: chunk xq of x rows xr + XR i, chunk bq of
  // w rows brow + 32 i (XR and 32 keep a row's swizzle)
  const int xr = tid / XC, xq = tid % XC, brow = tid >> 2, bq = tid & 3;
  const int x_dst = XF ? bfr::swz32(xr, xq) : bfr::swz16(xr, xq);
  const int b_dst = bfr::swz16(brow, bq);
  const TX* xrow[NA];
  bool xlive[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int row = r0 + xr + XR * i;
    xlive[i] = row < M;
    xrow[i] = x + (size_t)(xlive[i] ? row : 0) * In + XE * xq;
  }
  const bf16* wrow[NB];
  bool wlive[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int col = col0 + brow + 32 * i;
    wlive[i] = col < N;
    wrow[i] = w + (size_t)(wlive[i] ? col : 0) * Kp + 8 * bq;
  }
  auto load = [&](int kt, TX* as, bf16* bs) {
    const int k = kt * bfr::BK;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      cp_async16(bs + b_dst + 32 * i * bfr::BK, wrow[i] + k,
                 wlive[i] ? 16 : 0);
    const bool in_k = k + XE * xq < In;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const bool ok = xlive[i] && in_k;
      cp_async16(as + x_dst + XR * i * bfr::BK, ok ? xrow[i] + k : x,
                 ok ? 16 : 0);
    }
  };
  float acc[2][PROJ_NT][4];
  if constexpr (XF) {
    int x_ld[4];
    bfr::x_lanes(wm * 32, x_ld);
    auto frag = [&](int p, int, const float* as, uint32_t (&a)[3][2][4]) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          bfr::split3(*reinterpret_cast<const float2*>(
                          as + x_ld[2 * p + (i >> 1)] +
                          (16 * mi + 8 * (i & 1)) * bfr::BK),
                      a, mi, i);
    };
    bfr::ring<TM, PROJ_COLS, PROJ_STAGES, PROJ_NT, 3, float>(
        acc, smb, Kp / bfr::BK, wn * PROJ_NT * 8, load, frag);
  } else {
    int a_ld[2];
    bfr::a_lanes(wm * 32, a_ld);
    auto frag = [&](int p, int, const bf16* as, uint32_t (&a)[1][2][4]) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[0][mi], as + a_ld[p] + 16 * mi * bfr::BK);
    };
    bfr::ring<TM, PROJ_COLS, PROJ_STAGES, PROJ_NT, 1, bf16>(
        acc, smb, Kp / bfr::BK, wn * PROJ_NT * 8, load, frag);
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + wm * 32 + mi * 16 + hh * 8 + gid;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < PROJ_NT; ++j) {
        // N = 4H is even and col is: a float2 stays inside the row
        const int col = col0 + wn * PROJ_NT * 8 + 8 * j + 2 * tq;
        if (col < N)
          *reinterpret_cast<float2*>(xp + (size_t)row * N + col) =
              make_float2(acc[mi][j][hh * 2] + ldg_f(bias + col),
                          acc[mi][j][hh * 2 + 1] + ldg_f(bias + col + 1));
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
// reads it. (bf16 weights: lstm_recur_bf16.)
template <bool VEC>
__global__ void __launch_bounds__(P_THREADS, P_BLOCKS_SM)
lstm_recur_persistent(const float* __restrict__ xp,
                      const float* __restrict__ whp, float* __restrict__ hbuf,
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

  const int q4 = Hk / 4;  // 16-byte chunks a row
  const float* wsrc = whp + (size_t)ut * 4 * PU * Hk;
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
      // h_{t-1} of rows r0 .. r0 + PR, zero past Bf and past H
      if (VEC) {
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
          As[r * ld + k] = v;
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
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(__uint_as_float(a[i]), a_big[i], a_small[i]);
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            split_tf32(__uint_as_float(b[g][i]), b_big[g][i], b_small[g][i]);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          mma_tf32(acc[g], a_small, b_big[g]);
          mma_tf32(acc[g], a_big, b_small[g]);
          mma_tf32(acc[g], a_big, b_big[g]);
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

// ------------------------------ persistent recurrence, bf16 (small fold)

// Units a block (TILE: 16, or 8 with 4 warps; 4 TILE packed columns) and
// warps over K (WARPS: 8 or 4) are the plan's (ops/lstm.py
// `persistent_plan`, by dtype); the register cap (__launch_bounds__:
// 16 / WARPS blocks) gives each variant 128 registers a thread.
// Partial-sum row stride in floats: gate-major columns g TILE + unit, 5
// TILE apart, so the cell's reads (a warp: 32 / TILE rows of TILE units)
// fall in 32 distinct banks.
__host__ __device__ constexpr int rb_red_ld(int tile) {
  return 5 * tile;
}

// Dynamic shared memory of lstm_recur_bf16 (ops/lstm.py `persistent_smem`
// for bf16 computes the same): the bf16 Wh slice (4 TILE rows) and the
// staged shadow rows (PR), both Kh = H rounded up to 32 long in stage
// tiles of bfr::BK; the warps' partial sums; the block's c.
size_t recur_bf16_smem(int Kh, int chunks, int tile, int warps) {
  return (size_t)(4 * tile + PR) * Kh * sizeof(bf16) +
         ((size_t)warps * PR * rb_red_ld(tile) + (size_t)chunks * PR * tile) *
             sizeof(float);
}

// The bf16 small fold's time loop, one cooperative launch; the grid as
// lstm_recur_persistent's with TILE units a block (unit tile ut = b % nu,
// row chunks g0 = b / nu, g0 + ng, ...). whp: pack_recurrent's (4Hk, Hk)
// in bf16 (Hk = H rounded up to 8): the block's 4 TILE packed rows are
// copied once by 16-byte cp.async into bf16 shared memory, in K tiles of
// 32 (rows unpadded, bfr::swz16; rows past 4 Hk and K past Hk zero-filled
// by the copy), and read by ldmatrix as m16n8k16 B fragments. hs: the
// bf16 shadow of h, (2, Bf, Kh), zero past H, h0 rounded in its first
// half (ops/lstm.py `shadow`). A step, per chunk of PR rows: warp w stages
// the shadow rows of its own k16 steps (a contiguous WARPS-th of Kh / 16)
// by cp.async.cg (from L2: the other blocks wrote them), waits for them
// alone (__syncwarp, no block barrier), and sums its part of round(h) . Wh
// on bf16 mma.sync.m16n8k16 (exact products, fp32 accumulation); the
// warps' partial sums meet in shared memory, and the cell thread of (row,
// unit) adds them in warp order onto XP's gate input (the first chunk's
// read a frame ahead, at the start of the frame before: read just before
// the grid barrier, thread 0's fence there waited for them, 4% slower).
// h_t goes to y in fp32 and, rounded to nearest even, to the shadow's
// other half (the last frame's also to hbuf: h_T); c stays fp32 in shared
// memory. A warp restages its slice for the block's next chunk as soon as
// its product is read. Then one grid barrier a frame.
template <int TILE, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, 16 / WARPS)
lstm_recur_bf16(const float* __restrict__ xp, const bf16* __restrict__ whp,
                float* __restrict__ hbuf, bf16* __restrict__ hs,
                float* __restrict__ c, float* __restrict__ y, int Bf, int T,
                int H, int Hk, int Kh, int ng, int reverse) {
  constexpr int COLS = 4 * TILE, NT = COLS / 8, THREADS = 32 * WARPS;
  constexpr int RLD = rb_red_ld(TILE);
  constexpr int CELLS = (PR * TILE + THREADS - 1) / THREADS;  // a thread
  constexpr int BK = bfr::BK;
  extern __shared__ __align__(16) unsigned char smb[];
  bf16* Ws = reinterpret_cast<bf16*>(smb);      // Kh / BK tiles x COLS x BK
  bf16* As = Ws + (size_t)COLS * Kh;            // Kh / BK tiles x PR x BK
  float* red = reinterpret_cast<float*>(As + (size_t)PR * Kh);
  float* cs = red + WARPS * PR * RLD;           // chunks x PR x TILE
  const int nu = (H + TILE - 1) / TILE, nr = (Bf + PR - 1) / PR;
  const int ut = blockIdx.x % nu, g0 = blockIdx.x / nu;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const size_t half = (size_t)Bf * H, shalf = (size_t)Bf * Kh;
  const size_t H4 = 4 * (size_t)H;

  // the Wh slice, once: 16-byte chunk e % (Kh / 8) of packed row e / (Kh
  // / 8) of the block's
  const int kc = Kh / 8;
  const bf16* wsrc = whp + (size_t)ut * COLS * Hk;
  for (int e = tid; e < COLS * kc; e += THREADS) {
    const int r = e / kc, q = e % kc;
    const bool ok = ut * COLS + r < 4 * Hk && 8 * q < Hk;
    cp_async16(Ws + (q >> 2) * COLS * BK + bfr::swz16(r, q & 3),
               ok ? wsrc + (size_t)r * Hk + 8 * q : whp, ok ? 16 : 0);
  }
  cp_async_commit();
  // c of the block's cells: cell e of chunk j is row e / TILE, unit e % TILE
  for (int q = g0, j = 0; q < nr; q += ng, ++j)
    for (int e = tid; e < PR * TILE; e += THREADS) {
      const int row = q * PR + e / TILE, unit = ut * TILE + e % TILE;
      cs[j * PR * TILE + e] =
          row < Bf && unit < H ? c[(size_t)row * H + unit] : 0.f;
    }
  cp_async_wait<0>();
  __syncthreads();

  // the warp's k16 steps s0 .. s1 of Kh / 16; lane l stages row l / 2,
  // 16-byte half l % 2 of each
  const int steps = Kh / 16;
  const int s0 = warp * steps / WARPS, s1 = (warp + 1) * steps / WARPS;
  const int srow = lane >> 1, shalf16 = lane & 1;
  auto stage = [&](const bf16* hp, int r0) {
    const bool ok = r0 + srow < Bf;
    const bf16* src = hp + (size_t)(ok ? r0 + srow : 0) * Kh + 8 * shalf16;
    for (int st = s0; st < s1; ++st)
      cp_async16(As + (st >> 1) * PR * BK +
                     bfr::swz16(srow, 2 * (st & 1) + shalf16),
                 src + 16 * st, ok ? 16 : 0);
    cp_async_commit();
  };
  int a_ld[2], b_ld[2];
  bfr::a_lanes(0, a_ld);
  bfr::b_lanes(0, b_ld);
  // XP's gate inputs of the thread's cells of chunk q at frame t (xn: the
  // next frame's of the first chunk)
  float xg[CELLS][4], xn[CELLS][4];
  auto fetch_xg = [&](float (&dst)[CELLS][4], int q, int t) {
#pragma unroll
    for (int i = 0; i < CELLS; ++i) {
      const int e = tid + i * THREADS;
      const int row = q * PR + e / TILE, unit = ut * TILE + e % TILE;
      const bool live = e < PR * TILE && row < Bf && unit < H;
      const float* p = xp + ((size_t)(live ? row : 0) * T + t) * H4 + unit;
#pragma unroll
      for (int g = 0; g < 4; ++g) dst[i][g] = live ? __ldg(p + g * H) : 0.f;
    }
  };

  cg::grid_group grid = cg::this_grid();
  fetch_xg(xg, g0, reverse ? T - 1 : 0);
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const bf16* hp = hs + (s & 1) * shalf;
    bf16* hsn = hs + ((s + 1) & 1) * shalf;
    float* hn = hbuf + ((s + 1) & 1) * half;
    stage(hp, g0 * PR);
    if (s + 1 < T) fetch_xg(xn, g0, reverse ? T - 2 - s : s + 1);
    for (int q = g0, j = 0; q < nr; q += ng, ++j) {
      if (j > 0) fetch_xg(xg, q, t);
      float acc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
      cp_async_wait<0>();
      __syncwarp();  // the warp's rows have landed, for every lane
#pragma unroll 4  // the next steps' fragments load under the mmas (4% on
                   // LSTMNet's shape against no unrolling)
      for (int st = s0; st < s1; ++st) {
        // selects, not an index: a_ld and b_ld stay in registers
        const int ao = st & 1 ? a_ld[1] : a_ld[0];
        const int bo = st & 1 ? b_ld[1] : b_ld[0];
        const bf16* bs = Ws + (st >> 1) * COLS * BK;
        uint32_t a[4], b[NT][2];
        ldsm_x4(a, As + (st >> 1) * PR * BK + ao);
#pragma unroll
        for (int n = 0; n < NT; n += 2) ldsm_x4(b[n], bs + bo + n * 8 * BK);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_bf16(acc[n], a, b[n]);
      }
      __syncwarp();  // every lane has read its fragments of the rows
      if (q + ng < nr) stage(hp, (q + ng) * PR);
      // acc[n]: rows gid (+8), packed columns 8 n + 2 tq (+1) of the
      // block: gate n % 4 of units 8 (n / 4) + 2 tq (+1)
      float* rw = red + warp * PR * RLD;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(rw + (gid + 8 * hh) * RLD +
                                     (n & 3) * TILE + 8 * (n >> 2) + 2 * tq) =
              make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
      __syncthreads();  // the partial sums are in
#pragma unroll
      for (int i = 0; i < CELLS; ++i) {
        const int e = tid + i * THREADS;
        const int er = e / TILE, eu = e % TILE;
        const int row = q * PR + er, unit = ut * TILE + eu;
        if (e >= PR * TILE || row >= Bf || unit >= H) continue;
        float gs[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float sum = xg[i][g];
#pragma unroll
          for (int w = 0; w < WARPS; ++w)
            sum += red[(w * PR + er) * RLD + g * TILE + eu];
          gs[g] = sum;
        }
        float& cc = cs[j * PR * TILE + e];
        const float hv = lstm_cell(gs[0], gs[1], gs[2], gs[3], cc);
        if (s + 1 == T) hn[(size_t)row * H + unit] = hv;
        y[((size_t)row * T + t) * H + unit] = hv;
        hsn[(size_t)row * Kh + unit] = __float2bfloat16_rn(hv);
      }
      if (q + ng < nr) __syncthreads();  // red is read before it is rewritten
    }
    if (s + 1 < T) {
#pragma unroll
      for (int i = 0; i < CELLS; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[i][g] = xn[i][g];
      grid.sync();  // h_t of every block in before step s + 1
    }
  }
  for (int q = g0, j = 0; q < nr; q += ng, ++j)
    for (int e = tid; e < PR * TILE; e += THREADS) {
      const int row = q * PR + e / TILE, unit = ut * TILE + e % TILE;
      if (row < Bf && unit < H)
        c[(size_t)row * H + unit] = cs[j * PR * TILE + e];
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

template <bool VEC>
int run_tc(const float* x, const float* wp, const float* b, float* hbuf,
           float* c, float* y, int Bf, int T, int In, int H, int Hp, int Kp,
           int reverse, cudaStream_t st) {
  auto kernel = lstm_step_tc<VEC>;
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

template <class TX, int MT>
int run_bf16(const TX* x, const bf16* wp, const bf16* b, float* hbuf,
             bf16* hs, float* c, float* y, int Bf, int T, int In, int H,
             int Hp, int Kx, int Kh, bool programmatic, int reverse,
             cudaStream_t st) {
  auto kernel = lstm_step_bf16<TX, MT>;
  constexpr int smem = bf_smem<TX>();
  cudaError_t err = max_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hp / TU, (Bf + TM - 1) / TM);
  const size_t half = (size_t)Bf * H, shalf = (size_t)Bf * Kh;
  // programmatic: frames after the first may start as soon as every block
  // of the frame before has (frame 0 waits: its inputs were just written)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  for (int s = 0; s < T; ++s) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(TC_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = s > 0 && programmatic;
    err = cudaLaunchKernelEx(&cfg, kernel, x, wp, b,
                             (const bf16*)(hs + (s & 1) * shalf),
                             hs + ((s + 1) & 1) * shalf,
                             hbuf + ((s + 1) & 1) * half, c, y, Bf, T, In, H,
                             Kx, Kh, reverse ? T - 1 - s : s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <bool VEC>
int run_proj(const float* x, const float* wp, const float* b, float* xp,
             int M, int In, int N, int Kp, cudaStream_t st) {
  auto kernel = lstm_proj_tc<VEC>;
  cudaError_t err = max_smem(kernel, TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((N + TN - 1) / TN) * ((M + TM - 1) / TM);
  kernel<<<(unsigned)blocks, TC_THREADS, TC_SMEM, st>>>(x, wp, b, xp, M, In,
                                                        N, Kp);
  return (int)cudaGetLastError();
}

template <class TX>
int run_proj_bf16(const TX* x, const bf16* wp, const bf16* b, float* xp,
                  int M, int In, int N, int Kp, cudaStream_t st) {
  auto kernel = lstm_proj_bf16<TX>;
  constexpr int smem = proj_bf16_smem<TX>();
  cudaError_t err = max_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks =
      (long)((N + PROJ_COLS - 1) / PROJ_COLS) * ((M + TM - 1) / TM);
  kernel<<<(unsigned)blocks, TC_THREADS, smem, st>>>(x, wp, b, xp, M, In, N,
                                                     Kp);
  return (int)cudaGetLastError();
}

// Launch a persistent recurrence of `blocks` blocks, `threads` threads and
// `smem` bytes cooperatively: every block resident, or the grid barrier
// would never open, so a grid past the occupancy API's count is refused.
template <class K>
int launch_persistent(K kernel, unsigned blocks, int threads, size_t smem,
                      void** args, cudaStream_t st) {
  cudaError_t err = max_smem(kernel, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  if ((long)per_sm * sms < (long)blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                    dim3(threads), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool VEC>
int run_recur(const float* xp, const float* whp, float* hbuf, float* c,
              float* y, int Bf, int T, int H, int Hk, int ng, int reverse,
              cudaStream_t st) {
  const int nu = (H + PU - 1) / PU, nr = (Bf + PR - 1) / PR;
  void* args[] = {(void*)&xp, (void*)&whp, (void*)&hbuf, (void*)&c,
                  (void*)&y,  (void*)&Bf,  (void*)&T,    (void*)&H,
                  (void*)&Hk, (void*)&ng,  (void*)&reverse};
  return launch_persistent(lstm_recur_persistent<VEC>, (unsigned)nu * ng,
                           P_THREADS, persistent_smem(Hk, (nr + ng - 1) / ng),
                           args, st);
}

// f(lstm_recur_bf16<tile, warps>) for the designs ops/lstm.py
// recur_bf16_designs offers, (16, 8), (16, 4) and (8, 4);
// cudaErrorInvalidValue for any other pair.
template <class F>
int with_recur_bf16(int tile, int warps, F&& f) {
  if (tile == 16 && warps == 8) return f(lstm_recur_bf16<16, 8>);
  if (tile == 16 && warps == 4) return f(lstm_recur_bf16<16, 4>);
  if (tile == 8 && warps == 4) return f(lstm_recur_bf16<8, 4>);
  return (int)cudaErrorInvalidValue;
}

// x aligned to 4 of its elements: the 16-byte (fp32) or 8-byte (bf16)
// copies of VEC
template <class TX>
bool aligned4(const TX* x) {
  return reinterpret_cast<uintptr_t>(x) % (4 * sizeof(TX)) == 0;
}

int layer(const float* x, const float* wp, const float* b, float* hbuf,
          float* c, float* y, int Bf, int T, int In, int H, int Hp, int Kp,
          int reverse, void* stream) {
  if (Hp % TU != 0 || Hp < H || Kp % TK != 0 || Kp < In + H)
    return (int)cudaErrorInvalidValue;
  const bool vec = In % 4 == 0 && H % 4 == 0 && aligned4(x);
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? run_tc<true>(x, wp, b, hbuf, c, y, Bf, T, In, H, Hp, Kp,
                            reverse, st)
             : run_tc<false>(x, wp, b, hbuf, c, y, Bf, T, In, H, Hp, Kp,
                             reverse, st);
}

template <class TX>
int layer_bf16(const TX* x, const bf16* wp, const bf16* b, float* hbuf,
               bf16* hs, float* c, float* y, int Bf, int T, int In, int H,
               int Hp, int Kx, int Kh, int mt, int programmatic, int reverse,
               void* stream) {
  // 16-byte copies of x's rows only: In a whole number of them, x aligned
  constexpr int XE = 16 / sizeof(TX);
  if (Hp % TU != 0 || Hp < H || Kx % BK != 0 || Kx < In || Kh % BK != 0 ||
      Kh < H || In % XE != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      (mt != 1 && mt != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return mt == 1 ? run_bf16<TX, 1>(x, wp, b, hbuf, hs, c, y, Bf, T, In, H,
                                   Hp, Kx, Kh, programmatic, reverse, st)
                 : run_bf16<TX, 2>(x, wp, b, hbuf, hs, c, y, Bf, T, In, H,
                                   Hp, Kx, Kh, programmatic, reverse, st);
}

int project(const float* x, const float* wp, const float* b, float* xp,
            int M, int In, int N, int Kp, void* stream) {
  if (Kp % TK != 0 || Kp < In || N % 2 != 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const bool vec = In % 4 == 0 && aligned4(x);
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? run_proj<true>(x, wp, b, xp, M, In, N, Kp, st)
             : run_proj<false>(x, wp, b, xp, M, In, N, Kp, st);
}

template <class TX>
int project_bf16(const TX* x, const bf16* wp, const bf16* b, float* xp,
                 int M, int In, int N, int Kp, void* stream) {
  // 16-byte copies of x's rows only: In a multiple of 8, x aligned
  if (Kp % bfr::BK != 0 || Kp < In || N % 2 != 0 || In % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return run_proj_bf16(x, wp, b, xp, M, In, N, Kp, (cudaStream_t)stream);
}

int recur(const float* xp, const float* whp, float* hbuf, float* c, float* y,
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
  return H % 4 == 0 ? fit(lstm_recur_persistent<true>)
                    : fit(lstm_recur_persistent<false>);
}

// Hk = H rounded up to 8 (the pack's), Kh = H rounded up to 32 (the
// shadow's and the shared tiles')
bool recur_bf16_dims(int H, int Hk, int Kh) {
  return Hk % PU == 0 && Hk >= H && Hk < H + PU && Kh % bfr::BK == 0 &&
         Kh >= Hk;
}

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

// The same with bf16 weights, one lstm_step_bf16 a frame: wp
// pack_weights_bf16's (4Hp, Kx + Kh) and b bf16; x (Bf, T, In) fp32 or
// bf16 (x_bf16), In a multiple of 16 bytes' elements and x 16-byte aligned
// (the wrapper pads); Kx, Kh multiples of 32, not below In and H; hbuf, c
// and y fp32 as se_lstm_layer's; hs (2, Bf, Kh) bf16, zero past H, h0
// rounded to bf16 in its first half: the shadow of h the products take.
// mt (1 or 2): m16 tiles a warp; programmatic: frames after the first
// launched as programmatic dependents (ops/lstm.py bf16_step_design).
extern "C" int se_lstm_layer_bf16(const void* x, int x_bf16, const bf16* wp,
                                  const bf16* b, float* hbuf, bf16* hs,
                                  float* c, float* y, int Bf, int T, int In,
                                  int H, int Hp, int Kx, int Kh, int mt,
                                  int programmatic, int reverse,
                                  void* stream) {
  return x_bf16 ? layer_bf16(static_cast<const bf16*>(x), wp, b, hbuf, hs,
                             c, y, Bf, T, In, H, Hp, Kx, Kh, mt,
                             programmatic, reverse, stream)
                : layer_bf16(static_cast<const float*>(x), wp, b, hbuf, hs,
                             c, y, Bf, T, In, H, Hp, Kx, Kh, mt,
                             programmatic, reverse, stream);
}

// The small fold's projection: xp (M, N) = x (M, In) . Wx + b, N = 4H. wp:
// pack_input's (Np, Kp), Np = N and Kp = In rounded up to 64 and 32.
extern "C" int se_lstm_project(const float* x, const float* wp,
                               const float* b, float* xp, int M, int In,
                               int N, int Kp, void* stream) {
  return project(x, wp, b, xp, M, In, N, Kp, stream);
}

// The same on bf16 tensor cores (lstm_proj_bf16): wp, b bf16; x fp32 or
// bf16 (x_bf16), its rows In long, In a multiple of 8 and x 16-byte
// aligned (ops/lstm.py aligned_x; Kp the unpadded In's rounding, not
// below In); xp fp32.
extern "C" int se_lstm_project_bf16(const void* x, int x_bf16,
                                    const bf16* wp, const bf16* b, float* xp,
                                    int M, int In, int N, int Kp,
                                    void* stream) {
  return x_bf16 ? project_bf16(static_cast<const bf16*>(x), wp, b, xp, M, In,
                               N, Kp, stream)
                : project_bf16(static_cast<const float*>(x), wp, b, xp, M,
                               In, N, Kp, stream);
}

// lstm_proj_bf16's resources for an fp32 or a bf16 x (tc_common.cuh
// kernel_resources).
extern "C" int se_lstm_project_bf16_resources(int x_bf16, int* out) {
  return x_bf16 ? kernel_resources(lstm_proj_bf16<bf16>, TC_THREADS,
                                   proj_bf16_smem<bf16>(), out)
                : kernel_resources(lstm_proj_bf16<float>, TC_THREADS,
                                   proj_bf16_smem<float>(), out);
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

// The same with bf16 weights (lstm_recur_bf16): whp pack_recurrent's in
// bf16; hs the shadow of h, (2, Bf, Kh) bf16, Kh = H rounded up to 32,
// zero past H, h0 rounded to bf16 in its first half (xp, hbuf, c and y
// fp32); tile units a block and warps, 16 x 8, 16 x 4 or 8 x 4 (any
// other pair is refused), so the grid is
// ceil(H / tile) ng blocks, every one resident or the call fails.
extern "C" int se_lstm_recur_bf16(const float* xp, const bf16* whp,
                                  float* hbuf, bf16* hs, float* c, float* y,
                                  int Bf, int T, int H, int Hk, int Kh,
                                  int ng, int tile, int warps, int reverse,
                                  void* stream) {
  const int nr = (Bf + PR - 1) / PR;
  if (!recur_bf16_dims(H, Hk, Kh) || ng < 1 || ng > nr)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const unsigned blocks = (unsigned)((H + tile - 1) / tile) * ng;
  const size_t smem = recur_bf16_smem(Kh, (nr + ng - 1) / ng, tile, warps);
  void* args[] = {(void*)&xp, (void*)&whp, (void*)&hbuf, (void*)&hs,
                  (void*)&c,  (void*)&y,   (void*)&Bf,   (void*)&T,
                  (void*)&H,  (void*)&Hk,  (void*)&Kh,   (void*)&ng,
                  (void*)&reverse};
  return with_recur_bf16(tile, warps, [&](auto kernel) {
    return launch_persistent(kernel, blocks, 32 * warps, smem, args,
                             (cudaStream_t)stream);
  });
}

// What se_lstm_recur would ask for at H with `chunks` row chunks a block:
// the dynamic shared memory of a block (*smem) and the blocks an SM the
// occupancy API allows at that size (*per_sm). ops/lstm.py `recur_fit`
// holds its own plan (`persistent_smem`, PERSIST_BLOCKS_SM) against these.
extern "C" int se_lstm_recur_fit(int H, int Hk, int chunks, long* smem,
                                 int* per_sm) {
  return recur_fit(H, Hk, chunks, smem, per_sm);
}

// The same for se_lstm_recur_bf16's kernel of (tile, warps), Kh = H
// rounded up to 32.
extern "C" int se_lstm_recur_fit_bf16(int H, int Kh, int chunks, int tile,
                                      int warps, long* smem, int* per_sm) {
  if (Kh % bfr::BK != 0 || Kh < H || chunks < 1)
    return (int)cudaErrorInvalidValue;
  *smem = (long)recur_bf16_smem(Kh, chunks, tile, warps);
  return with_recur_bf16(tile, warps, [&](auto kernel) {
    cudaError_t err = max_smem(kernel, (size_t)*smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                          32 * warps, *smem);
    return (int)err;
  });
}

// lstm_recur_bf16<tile, warps>'s resources at Kh and `chunks` row chunks a
// block (tc_common.cuh kernel_resources).
extern "C" int se_lstm_recur_bf16_resources(int Kh, int chunks, int tile,
                                            int warps, int* out) {
  const int smem = (int)recur_bf16_smem(Kh, chunks, tile, warps);
  return with_recur_bf16(tile, warps, [&](auto kernel) {
    return kernel_resources(kernel, 32 * warps, smem, out);
  });
}
