// Scaled-dot-product attention, softmax(q k^T * scale) v, D = 16, fp32 and
// bf16 (see "bf16" below).
//
// Replaces: se_tpu/ops/pallas_attention.py, `_pallas_attention` and its
// body `_att_kernel` (entry `sdp_attention`).
//
// Bound on the H100: each (n, h) does 4*L*L*D flops on 4*L*D*4 bytes
// (q, k, v read, o written), L/4 flops a byte. On the T-attention
// (L = 401) that is ~100 flops a byte, above the fp32-accurate
// tensor-core ridge of ~50 (165 TFLOP/s of 3xTF32 over 3.35 TB/s): bound
// by operations. On the F-attention (L = 4) it is 1 flop a byte: bound by
// bytes. The TPU kernel held the whole (L, L) energy of one (n, all heads)
// in VMEM; here K/V of one head at L = 2048 (160 KB at the padded stride)
// would crowd a block's shared memory, so they stream.
//
// Two designs a dtype, chosen by shape in ops/attention.py `att_design`:
//
// att_flash_tc (long L): a flash-attention forward on the tensor cores in
// 3xTF32 mma.sync.m16n8k8 (tc_common.cuh's split: big = v rounded to TF32,
// small = v - big; small.big + big.small + big.big, fp32 accumulation).
// A warp owns 16 query rows; its Q fragment (two k8 steps of D = 16,
// split once) stays in registers. The block's warps share one (n, h), and
// K/V tiles of 64 keys stream through a two-stage cp.async ring at a row
// stride of 20 floats (the ldmatrix reads of K and the scalar reads of V
// hit 32 distinct banks). Per tile: S = Q K^T (8 n8 tiles x 2 k steps x
// 3 products), scaled by scale * log2(e), keys >= L masked to -inf, then
// an online softmax in registers (row max across the quad by
// __shfl_xor_sync, exp2f, the running O and l rescaled a tile). P . V
// needs no shuffle: the accumulator holds columns (2 tq, 2 tq + 1) of a
// row and the A operand wants (tq, tq + 4), and a sum over keys does not
// care about their order, so each k8 step reads its keys in the order
// tq <-> key 8 j + 2 tq, tq + 4 <-> key 8 j + 2 tq + 1: S's accumulators
// are P's A fragments as they stand (a0 = c0, a1 = c2, a2 = c1, a3 = c3),
// and V's B fragment rows are read in the same order. P is split like
// every other A operand. Each tile's P . V sums into a fresh fragment that
// joins O by fp32 adds (the mma's own accumulation drifts over long K).
// The block has 1, 2 or 4 warps, whichever keeps the grid at two waves of
// 132 SMs or more (ops/attention.py `flash_warps`): the real T-attention
// at B = 4 has only 16 (n, h) x 401 rows.
//
// att_small_l (short L, up to SMALL_L_MAX = 32): bound by bytes, so a
// block takes 128 / L consecutive (n, h) pairs, one thread a query row:
// their q, k and v are contiguous in memory and are staged into shared
// memory (row stride 20: the float4 row reads do not conflict) by
// coalesced 16-byte cp.async copies. Each thread does L dot products of
// 16, a softmax over L (exp2f) and L x 16 FMAs in fp32, writes its output
// row over its q row, and the block stores the output coalesced.
//
// bf16 (`se_att_flash_tc_bf16`, `se_att_small_l_bf16`): q, k, v and o in
// bf16, with the TPU kernel's rounding points (pallas_attention.py:43-49):
// the scores and the softmax in fp32, P = softmax normalised and then
// rounded to bf16, P V summed in fp32, o rounded once. P is rounded after
// the normalisation, which needs the row's max and sum before any P V.
//
// att_flash_bf16<W> (every L past SMALL_L_MAX: the T-attention's 401):
// two sweeps over K on bf16 mma.sync.m16n8k16 with fp32 accumulation
// (bf16 times bf16 is exact in fp32). A warp owns 16 query rows; its Q A
// fragment (one k16 step: D = 16) is loaded once into registers as bf16.
// The tiles of 64 keys pass through one bf16 cp.async ring (ATT_BF_STAGES
// slots of a K and a V tile, 4 KB; a key row is 32 bytes, its two 16-byte
// chunks swizzled by `kv_off` so that the 8 rows an ldmatrix matrix reads
// hit 8 distinct bank groups). Sweep 1, over K: S = Q K^T (one mma a n8
// tile, B by ldmatrix), scaled into log2 units, keys >= L at -inf, the
// online row max and sum (`softmax_tile`). Sweep 2, over K and V: S again,
// P = exp2(s - m) x (1 / l) in registers, rounded to bf16: two n8
// accumulator tiles of P make one k16 A fragment (keys 2 tq, 2 tq + 1 of
// tiles 2 j, 2 j + 1: the mma's A layout), which meets V's B fragments
// from ldmatrix.trans (keys down, d across). P is exp2(s - m) / l up to
// fp32 round-off (a multiply by 1 / l where the twin divides), so a P
// element now and then rounds to the other bf16 neighbour: the flip the
// bf16 rule allows (ops/_dtype.py `att_flip_slack`). Each tile's P V sums
// into a fresh fragment joined to O by fp32 adds. K is read twice and
// Q K^T computed twice, but a block keeps only its 16 KB ring (71
// registers a thread: seven blocks of four warps an SM), and the kernel is
// bound by latency, not by operations or bytes. The block has 1, 2 or 4
// warps, as the fp32 kernel's (ops/attention.py `flash_warps`): a cap of
// two ran 0.0345 against 0.0325 ms device on the complex T-attention at B
// = 4 and 1.24 against 1.16 at L = 640-2048 (bf16_ring_sweep.py
// attention, NVIDIA H100 80GB HBM3, 700 W; PERF.md). A one-sweep
// design that kept each warp's 16 rows of exp2(s - m_t) in shared memory
// (K and V each read once; 29.7 KB a warp at L = 401) held three blocks
// of two warps an SM and lost on Uformer's shapes: device 0.0398 against
// 0.0333 ms on the complex T-attention at B = 4, 0.318 against 0.251 on
// both at B = 32; it won only on the real branch's 16 x 1 heads at B = 4,
// 0.0080 against 0.0106 (bf16_ring_sweep.py attention, same card).
//
// att_small_l<.., bf16> takes the row's sum before its P V loop likewise,
// its bf16 rows widened to fp32 as they are staged (tc_common.cuh
// `copy4`: plain loads), bound by bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int D = 16;
constexpr int LDS = D + 4;  // shared row stride in floats
constexpr int BK = 64;      // keys a flash tile
constexpr int SMALL_L_MAX = 32;
constexpr int SMALL_THREADS = 128;

// Q's A fragments of the two k8 steps: register j of step s is row gid +
// 8 (j & 1) at d = 8 s + tq + 4 (j >> 1); split once (qb the big part, qs
// the small).
__device__ __forceinline__ void q_fragments(const float* __restrict__ q,
                                            size_t base, int r0, int L,
                                            int gid, int tq,
                                            uint32_t (&qb)[2][4],
                                            uint32_t (&qs)[2][4]) {
#pragma unroll
  for (int st = 0; st < 2; ++st)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + gid + 8 * (j & 1);
      const float a =
          r < L ? q[base + (size_t)r * D + 8 * st + tq + 4 * (j >> 1)] : 0.f;
      split_tf32(a, qb[st][j], qs[st][j]);
    }
}

// S = Q K^T of one staged K tile, scaled (log2 units), keys >= L at -inf:
// n8 tile g holds keys 8 g + 2 tq + (0, 1) of rows gid, gid + 8
// (s[g][hh * 2 + j]); K split, 3 products a pair.
__device__ __forceinline__ void score_tile(const float* kp, int lane, int kt,
                                           int L, float scale_log2,
                                           const uint32_t (&qb)[2][4],
                                           const uint32_t (&qs)[2][4],
                                           float (&s)[8][4]) {
#pragma unroll
  for (int g = 0; g < 8; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[g][i] = 0.f;
#pragma unroll
  for (int st = 0; st < 2; ++st)
#pragma unroll
    for (int g = 0; g < 8; g += 2) {
      uint32_t b[4];
      ldsm_x4(b, kp + g * 8 * LDS + st * 8 + lane_b_offset(lane, LDS));
      uint32_t bb[4], bsm[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_tf32(__uint_as_float(b[j]), bb[j], bsm[j]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_tf32(s[g + h], qs[st], bb + 2 * h);
        mma_tf32(s[g + h], qb[st], bsm + 2 * h);
        mma_tf32(s[g + h], qb[st], bb + 2 * h);
      }
    }
  const int key0 = kt * BK + 2 * (lane & 3);
#pragma unroll
  for (int g = 0; g < 8; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[g][i] =
          key0 + g * 8 + (i & 1) < L ? s[g][i] * scale_log2 : -INFINITY;
}

// The online softmax's step a tile: the tile's row max across the quad
// joins the running max m, corr rescales what was summed before, s becomes
// exp2(s - m) and this thread's part of the running sum l takes it.
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[2],
                                             float (&l)[2],
                                             float (&corr)[2]) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int g = 0; g < 8; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) tmax[i >> 1] = fmaxf(tmax[i >> 1], s[g][i]);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 1));
    tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 2));
    const float mnew = fmaxf(m[hh], tmax[hh]);  // finite: key 0 < L
    corr[hh] = exp2f(m[hh] - mnew);             // 0 on the first tile
    m[hh] = mnew;
  }
  float lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int g = 0; g < 8; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = exp2f(s[g][i] - m[i >> 1]);
      s[g][i] = p;
      lsum[i >> 1] += p;
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + lsum[hh];
}

// part = P V of one staged V tile, k8 step j over keys 8 j + (2 tq, 2 tq +
// 1) as (tq, tq + 4): S's accumulators are P's A fragments as they stand.
// P and V split, 3 products a pair.
__device__ __forceinline__ void pv_tile(const float (&s)[8][4],
                                        const float* vp, int gid, int tq,
                                        float (&part)[2][4]) {
#pragma unroll
  for (int dn = 0; dn < 2; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[dn][i] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
    const float* vr = vp + (8 * j + 2 * tq) * LDS + gid;
    uint32_t ab[4], asm_[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(pa[i], ab[i], asm_[i]);
#pragma unroll
    for (int dn = 0; dn < 2; ++dn) {
      uint32_t bb[2], bsm[2];
      split_tf32(vr[dn * 8], bb[0], bsm[0]);
      split_tf32(vr[LDS + dn * 8], bb[1], bsm[1]);
      mma_tf32(part[dn], asm_, bb);
      mma_tf32(part[dn], ab, bsm);
      mma_tf32(part[dn], ab, bb);
    }
  }
}

// One sweep, the online softmax rescaling O a tile (fp32; the bf16 kernel
// is att_flash_bf16).
template <int W>
__global__ void __launch_bounds__(32 * W)
att_flash_tc(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int L,
             float scale_log2) {
  __shared__ __align__(16) float ks[2][BK * LDS];
  __shared__ __align__(16) float vs[2][BK * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const size_t base = (size_t)blockIdx.x * L * D;
  const int r0 = (blockIdx.y * W + warp) * 16;
  const int nk = (L + BK - 1) / BK;

  // one tile: BK rows of K and of V, 4 chunks of 4 a row, zero past L
  auto load = [&](int kt, int slot) {
    for (int e = tid; e < BK * 4; e += 32 * W) {
      const int row = e >> 2, c = (e & 3) * 4, key = kt * BK + row;
      const bool ok = key < L;
      const size_t src = base + (size_t)(ok ? key : 0) * D + c;
      copy4(&ks[slot][row * LDS + c], k + src, ok);
      copy4(&vs[slot][row * LDS + c], v + src, ok);
    }
    cp_async_commit();
  };

  load(0, 0);  // tile 0, in flight as Q loads
  uint32_t qb[2][4], qs[2][4];
  q_fragments(q, base, r0, L, gid, tq, qb, qs);
  float acc[2][4];  // O: d tiles 0-7 and 8-15, rows gid and gid + 8
#pragma unroll
  for (int dn = 0; dn < 2; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dn][i] = 0.f;
  // running max (log2 units) and this thread's part of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // the K/V tiles in a two-stage ring
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<0>();  // tile kt has landed
    __syncthreads();     // ... for all, and tile kt - 1's slot is read
    if (kt + 1 < nk) load(kt + 1, (kt + 1) & 1);
    float s[8][4], part[2][4], corr[2];
    score_tile(ks[kt & 1], lane, kt, L, scale_log2, qb, qs, s);
    softmax_tile(s, m, l, corr);
    // a fresh fragment a tile, joined by fp32 adds (the mma's own
    // accumulation drifts over long K)
    pv_tile(s, vs[kt & 1], gid, tq, part);
#pragma unroll
    for (int dn = 0; dn < 2; ++dn)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[dn][i] = acc[dn][i] * corr[i >> 1] + part[dn][i];
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }

  // O / l, rows below L
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + gid + 8 * hh;
    if (r >= L) continue;
    float* orow = o + base + (size_t)r * D + 2 * tq;
#pragma unroll
    for (int dn = 0; dn < 2; ++dn)
      put2(orow + dn * 8, acc[dn][2 * hh] / l[hh],
           acc[dn][2 * hh + 1] / l[hh]);
  }
}

// ------------------------------------------------ bf16 (k16 fragments)

using bf16 = __nv_bfloat16;
constexpr int ATT_BF_STAGES = 4;  // ring slots
constexpr int TILE = BK * D;      // bf16 elements of a 64-key tile: 2 KB
constexpr int SLOT = 2 * TILE;    // a ring slot: a K and a V tile
constexpr int BF_SMEM = ATT_BF_STAGES * SLOT * 2;  // the ring, bytes

// Element offset of 16-byte chunk c (d 0-7, 8-15) of key row r of a bf16
// tile, rows 32 bytes unpadded: chunk c at c ^ ((r >> 2) & 1), so the 8
// consecutive rows an ldmatrix matrix reads (either chunk) fall in 8
// distinct 16-byte bank groups.
__device__ __forceinline__ int kv_off(int r, int c) {
  return r * D + ((c ^ ((r >> 2) & 1)) << 3);
}

// S = Q K^T of one staged bf16 K tile, scaled (log2 units), keys >= L at
// -inf, in the accumulator layout (score_tile's): n8 tile g holds keys 8 g
// + 2 tq + (0, 1) of rows gid, gid + 8.
__device__ __forceinline__ void score_tile_bf16(const bf16* kt_s, int lane,
                                                int kt, int L,
                                                float scale_log2,
                                                const uint32_t (&qa)[4],
                                                float (&s)[8][4]) {
  // ldmatrix: matrices keys +0 / +8 of the n8 pair, chunks d 0-7 / 8-15
  const int row = (lane & 7) + ((lane >> 4) << 3), c = (lane >> 3) & 1;
#pragma unroll
  for (int g = 0; g < 8; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[g][i] = 0.f;
#pragma unroll
  for (int g = 0; g < 8; g += 2) {
    uint32_t b[4];
    ldsm_x4(b, kt_s + kv_off(8 * g + row, c));
    mma_bf16(s[g], qa, b);
    mma_bf16(s[g + 1], qa, b + 2);
  }
  const int key0 = kt * BK + 2 * (lane & 3);
#pragma unroll
  for (int g = 0; g < 8; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[g][i] =
          key0 + g * 8 + (i & 1) < L ? s[g][i] * scale_log2 : -INFINITY;
}

// part = P V of one staged bf16 V tile, P the tile's normalised fp32
// probabilities in the accumulator layout, rounded to bf16 here: k16 step
// j takes n8 tiles 2 j and 2 j + 1 as its A fragment, V's B fragments by
// ldmatrix.trans (matrices keys +0 / +8, d 0-7 / 8-15).
__device__ __forceinline__ void pv_tile_bf16(const float (&p)[8][4],
                                             const bf16* vt_s, int lane,
                                             float (&part)[2][4]) {
  const int row = (lane & 7) + (((lane >> 3) & 1) << 3), c = lane >> 4;
#pragma unroll
  for (int dn = 0; dn < 2; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[dn][i] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t a[4], b[4];
#pragma unroll
    for (int h = 0; h < 2; ++h)    // n8 tile 2 j + h: keys +8 h
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)  // rows gid, gid + 8
        a[2 * h + hh] = pack_bf16x2(p[2 * j + h][2 * hh],
                                    p[2 * j + h][2 * hh + 1]);
    ldsm_x4_t(b, vt_s + kv_off(16 * j + row, c));
    mma_bf16(part[0], a, b);
    mma_bf16(part[1], a, b + 2);
  }
}

// Two sweeps (see the header): ring stage i is K tile i for i < nk, then
// K and V tile i - nk.
template <int W>
__global__ void __launch_bounds__(32 * W)
att_flash_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int L,
               float scale_log2) {
  extern __shared__ __align__(16) unsigned char smb[];
  bf16* ring = reinterpret_cast<bf16*>(smb);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const size_t base = (size_t)blockIdx.x * L * D;
  const int r0 = (blockIdx.y * W + warp) * 16;
  const int nk = (L + BK - 1) / BK;

  auto load = [&](int i, int slot) {
    const int kt = i < nk ? i : i - nk;
    bf16* dst = ring + slot * SLOT;
    for (int e = tid; e < BK * 2; e += 32 * W) {
      const int row = e >> 1, c = e & 1, key = kt * BK + row;
      const bool ok = key < L;  // zeros past L
      const size_t src = base + (size_t)(ok ? key : 0) * D + 8 * c;
      const int off = kv_off(row, c);
      cp_async16(dst + off, k + src, ok ? 16 : 0);
      if (i >= nk) cp_async16(dst + TILE + off, v + src, ok ? 16 : 0);
    }
  };

  const int stages = 2 * nk;
#pragma unroll
  for (int st = 0; st < ATT_BF_STAGES - 1; ++st) {
    if (st < stages) load(st, st);
    cp_async_commit();
  }
  // Q's A fragment: a0 / a1 rows gid / gid + 8 at d 2 tq, a2 / a3 at d 2
  // tq + 8, each two bf16 as they are
  uint32_t qa[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = r0 + gid + 8 * (j & 1);
    qa[j] = r < L ? __ldg(reinterpret_cast<const unsigned*>(
                        q + base + (size_t)r * D + 2 * tq + 8 * (j >> 1)))
                  : 0u;
  }
  float acc[2][4];  // O: d tiles 0-7 and 8-15, rows gid and gid + 8
#pragma unroll
  for (int dn = 0; dn < 2; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dn][i] = 0.f;
  // running max (log2 units) and this thread's part of the running sum;
  // after sweep 1, the row's max and 1 / its sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int i = 0; i < stages; ++i) {
    cp_async_wait<ATT_BF_STAGES - 2>();  // stage i has landed
    __syncthreads();                     // ... for all; stage i - 1 is read
    const int next = i + ATT_BF_STAGES - 1;  // into stage i - 1's slot
    if (next < stages) load(next, next % ATT_BF_STAGES);
    cp_async_commit();
    const bf16* slot = ring + (i % ATT_BF_STAGES) * SLOT;
    const int kt = i < nk ? i : i - nk;
    float s[8][4];
    score_tile_bf16(slot, lane, kt, L, scale_log2, qa, s);
    if (i < nk) {  // sweep 1: the row max and sum
      float corr[2];
      softmax_tile(s, m, l, corr);
      if (i == nk - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
          l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
          l[hh] = 1.f / l[hh];
        }
      }
      continue;
    }
    // sweep 2: s becomes P, normalised, fp32; then P V
#pragma unroll
    for (int g = 0; g < 8; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[g][e] = exp2f(s[g][e] - m[e >> 1]) * l[e >> 1];
    float part[2][4];
    pv_tile_bf16(s, slot + TILE, lane, part);
    // a fresh fragment a tile, joined by fp32 adds
#pragma unroll
    for (int dn = 0; dn < 2; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] += part[dn][e];
  }
  cp_async_wait<0>();

  // O (P was normalised), rows below L, rounded once
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + gid + 8 * hh;
    if (r >= L) continue;
    bf16* orow = o + base + (size_t)r * D + 2 * tq;
#pragma unroll
    for (int dn = 0; dn < 2; ++dn)
      put2(orow + dn * 8, acc[dn][2 * hh], acc[dn][2 * hh + 1]);
  }
}

// pairs (n, h) pair0 .. pair0 + P of (nh, L, D), P = blockDim.x / L, one
// thread a query row; LM >= L bounds the unrolled score loop. T: fp32 or
// bf16 storage.
template <int LM, class T>
__global__ void __launch_bounds__(SMALL_THREADS)
att_small_l(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int nh, int L,
            float scale_log2) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, pairs = blockDim.x / L;
  const long pair0 = (long)blockIdx.x * pairs;
  const int rows = (int)min((long)pairs, nh - pair0) * L;
  float* qs = sm;
  float* kvs = sm + pairs * L * LDS;  // k rows, then v rows
  const size_t g0 = (size_t)pair0 * L * D;
  for (int e = tid; e < rows * 4; e += blockDim.x) {
    const int r = e >> 2, c = (e & 3) * 4;
    copy4(qs + r * LDS + c, q + g0 + 4 * e, true);
    copy4(kvs + r * LDS + c, k + g0 + 4 * e, true);
    copy4(kvs + (pairs * L + r) * LDS + c, v + g0 + 4 * e, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  if (tid < rows) {
    float qr[D];
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(qs + tid * LDS + c);
      qr[c] = t.x, qr[c + 1] = t.y, qr[c + 2] = t.z, qr[c + 3] = t.w;
    }
    const float* kb = kvs + (tid / L) * L * LDS;
    const float* vb = kb + pairs * L * LDS;
    float s[LM];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < LM; ++j) {
      if (j < L) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += 4) {
          const float4 t = *reinterpret_cast<const float4*>(kb + j * LDS + c);
          dot = fmaf(qr[c], t.x, dot);
          dot = fmaf(qr[c + 1], t.y, dot);
          dot = fmaf(qr[c + 2], t.z, dot);
          dot = fmaf(qr[c + 3], t.w, dot);
        }
        s[j] = dot * scale_log2;
        mx = fmaxf(mx, s[j]);
      }
    }
    float l = 0.f, acc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.f;
    constexpr bool kBf16 = sizeof(T) == 2;
    if (kBf16) {  // P normalised, then rounded: the sum first
#pragma unroll
      for (int j = 0; j < LM; ++j)
        if (j < L) {
          s[j] = exp2f(s[j] - mx);
          l += s[j];
        }
    }
#pragma unroll
    for (int j = 0; j < LM; ++j) {
      if (j < L) {
        float p;
        if (kBf16) {
          p = __bfloat162float(__float2bfloat16_rn(s[j] / l));
        } else {
          p = exp2f(s[j] - mx);
          l += p;
        }
#pragma unroll
        for (int c = 0; c < D; c += 4) {
          const float4 t = *reinterpret_cast<const float4*>(vb + j * LDS + c);
          acc[c] = fmaf(p, t.x, acc[c]);
          acc[c + 1] = fmaf(p, t.y, acc[c + 1]);
          acc[c + 2] = fmaf(p, t.z, acc[c + 2]);
          acc[c + 3] = fmaf(p, t.w, acc[c + 3]);
        }
      }
    }
    // over this thread's own q row, which no other thread reads
    const float div = kBf16 ? 1.f : l;  // bf16: P was normalised
#pragma unroll
    for (int c = 0; c < D; c += 4)
      *reinterpret_cast<float4*>(qs + tid * LDS + c) =
          make_float4(acc[c] / div, acc[c + 1] / div, acc[c + 2] / div,
                      acc[c + 3] / div);
  }
  __syncthreads();
  for (int e = tid; e < rows * 4; e += blockDim.x)
    put4(o + g0 + 4 * e,
         *reinterpret_cast<const float4*>(qs + (e >> 2) * LDS + (e & 3) * 4));
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

int flash(const float* q, const float* k, const float* v, float* o, int nh,
          int L, float scale_log2, int warps, cudaStream_t st) {
  if (L < 1 || nh < 0 || misaligned(q) || misaligned(k) || misaligned(v) ||
      misaligned(o))
    return (int)cudaErrorInvalidValue;
  if (nh == 0) return 0;
  const dim3 grid(nh, (L + 16 * warps - 1) / (16 * warps));
  switch (warps) {
    case 1:
      att_flash_tc<1><<<grid, 32, 0, st>>>(q, k, v, o, L, scale_log2);
      break;
    case 2:
      att_flash_tc<2><<<grid, 64, 0, st>>>(q, k, v, o, L, scale_log2);
      break;
    case 4:
      att_flash_tc<4><<<grid, 128, 0, st>>>(q, k, v, o, L, scale_log2);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// att_flash_bf16<W> as a function pointer (W 1, 2 or 4).
using FlashBf16 = void (*)(const bf16*, const bf16*, const bf16*, bf16*, int,
                           float);
FlashBf16 flash_bf16_kernel(int warps) {
  switch (warps) {
    case 1: return att_flash_bf16<1>;
    case 2: return att_flash_bf16<2>;
    case 4: return att_flash_bf16<4>;
    default: return nullptr;
  }
}

int flash_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, int nh,
               int L, float scale_log2, int warps, cudaStream_t st) {
  const FlashBf16 kernel = flash_bf16_kernel(warps);
  if (L < 1 || nh < 0 || kernel == nullptr || misaligned(q) ||
      misaligned(k) || misaligned(v) || misaligned(o))
    return (int)cudaErrorInvalidValue;
  if (nh == 0) return 0;
  const dim3 grid(nh, (L + 16 * warps - 1) / (16 * warps));
  kernel<<<grid, 32 * warps, BF_SMEM, st>>>(q, k, v, o, L, scale_log2);
  return (int)cudaGetLastError();
}

template <class T>
int small_l(const T* q, const T* k, const T* v, T* o, int nh, int L,
            float scale_log2, cudaStream_t st) {
  if (L < 1 || L > SMALL_L_MAX || nh < 0 || misaligned(q) || misaligned(k) ||
      misaligned(v) || misaligned(o))
    return (int)cudaErrorInvalidValue;
  if (nh == 0) return 0;
  const int pairs = SMALL_THREADS / L, threads = pairs * L;
  const unsigned blocks = (unsigned)((nh + pairs - 1) / pairs);
  const size_t smem = 3 * (size_t)threads * LDS * sizeof(float);
  if (L <= 4)
    att_small_l<4, T><<<blocks, threads, smem, st>>>(q, k, v, o, nh, L,
                                                     scale_log2);
  else if (L <= 8)
    att_small_l<8, T><<<blocks, threads, smem, st>>>(q, k, v, o, nh, L,
                                                     scale_log2);
  else if (L <= 16)
    att_small_l<16, T><<<blocks, threads, smem, st>>>(q, k, v, o, nh, L,
                                                      scale_log2);
  else
    att_small_l<32, T><<<blocks, threads, smem, st>>>(q, k, v, o, nh, L,
                                                      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (nh, L, 16) contiguous fp32, 16-byte aligned. scale_log2 =
// scale * log2(e). warps: 1, 2 or 4 query-row tiles of 16 a block.
extern "C" int se_att_flash_tc(const float* q, const float* k, const float* v,
                               float* o, int nh, int L, float scale_log2,
                               int warps, void* stream) {
  return flash(q, k, v, o, nh, L, scale_log2, warps, (cudaStream_t)stream);
}

// The same arguments; 1 <= L <= SMALL_L_MAX.
extern "C" int se_att_small_l(const float* q, const float* k, const float* v,
                              float* o, int nh, int L, float scale_log2,
                              void* stream) {
  return small_l(q, k, v, o, nh, L, scale_log2, (cudaStream_t)stream);
}

// The bf16 flash kernel (att_flash_bf16): q, k, v, o (nh, L, 16)
// contiguous bf16, 16-byte aligned; warps: 1, 2 or 4 query-row tiles of
// 16 a block.
extern "C" int se_att_flash_tc_bf16(const bf16* q, const bf16* k,
                                    const bf16* v, bf16* o, int nh, int L,
                                    float scale_log2, int warps,
                                    void* stream) {
  return flash_bf16(q, k, v, o, nh, L, scale_log2, warps,
                    (cudaStream_t)stream);
}

// att_flash_bf16's resources for a block of `warps` warps (tc_common.cuh
// kernel_resources).
extern "C" int se_att_flash_tc_bf16_resources(int warps, int* out) {
  const FlashBf16 kernel = flash_bf16_kernel(warps);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return kernel_resources(kernel, 32 * warps, BF_SMEM, out);
}

// The short-L kernel in bf16: the same arguments as se_att_small_l, bf16.
extern "C" int se_att_small_l_bf16(const __nv_bfloat16* q,
                                   const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, __nv_bfloat16* o,
                                   int nh, int L, float scale_log2,
                                   void* stream) {
  return small_l(q, k, v, o, nh, L, scale_log2, (cudaStream_t)stream);
}
