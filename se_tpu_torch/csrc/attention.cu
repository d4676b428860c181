// Scaled-dot-product attention, softmax(q k^T * scale) v, D = 16, fp32 and
// bf16 (storage; the arithmetic is fp32, see "bf16" below).
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
// Two designs, chosen by shape in ops/attention.py `att_design`:
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
// rounded to bf16, P V summed in fp32, o rounded once. Both products have
// two bf16 operands, so each is exact in one TF32 mma (tc_common.cuh) with
// fp32 accumulation: no split. P is rounded after the normalisation, which
// needs the row's max and sum before any P V: att_flash_tc<.., bf16>
// streams the K tiles twice, once for the running max and sum (as above,
// without V), then for P = round(exp2(s - m) / l) and P V into plain sums.
// K and V are widened to fp32 as they are staged (tc_common.cuh `copy4`),
// so the tiles, ldmatrix reads and fragment orders are the fp32 kernel's;
// both instances share the device functions q_fragments, score_tile,
// softmax_tile and pv_tile, which split their operands in 3 passes for
// fp32 and take them as they stand in 1 for bf16. att_small_l<.., bf16>
// takes the row's sum before its P V loop likewise.

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
// 8 (j & 1) at d = 8 s + tq + 4 (j >> 1); split once in 3 passes (qb the
// big part, qs the small), as they stand in 1 (qb; exact: bf16 values).
template <int PASSES, class T>
__device__ __forceinline__ void q_fragments(const T* __restrict__ q,
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
          r < L ? to_f(q[base + (size_t)r * D + 8 * st + tq + 4 * (j >> 1)])
                : 0.f;
      if constexpr (PASSES == 3)
        split_tf32(a, qb[st][j], qs[st][j]);
      else
        qb[st][j] = __float_as_uint(a);
    }
}

// S = Q K^T of one staged K tile, scaled (log2 units), keys >= L at -inf:
// n8 tile g holds keys 8 g + 2 tq + (0, 1) of rows gid, gid + 8
// (s[g][hh * 2 + j]); K split in 3 passes, as it stands in 1.
template <int PASSES>
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
      if constexpr (PASSES == 3) {
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
      } else {
        mma_tf32(s[g], qb[st], b);
        mma_tf32(s[g + 1], qb[st], b + 2);
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
// P and V split in 3 passes, as they stand in 1.
template <int PASSES>
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
    if constexpr (PASSES == 3) {
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
    } else {
      const uint32_t ab[4] = {__float_as_uint(pa[0]), __float_as_uint(pa[1]),
                              __float_as_uint(pa[2]), __float_as_uint(pa[3])};
#pragma unroll
      for (int dn = 0; dn < 2; ++dn) {
        const uint32_t bv[2] = {__float_as_uint(vr[dn * 8]),
                                __float_as_uint(vr[LDS + dn * 8])};
        mma_tf32(part[dn], ab, bv);
      }
    }
  }
}

// fp32 (T = float): one sweep, the online softmax rescaling O a tile.
// bf16: sweep 1 the row max and sum, sweep 2 P = round(exp2(s - m) / l)
// and O += P V (see the header).
template <int W, class T>
__global__ void __launch_bounds__(32 * W)
att_flash_tc(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int L,
             float scale_log2) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int PASSES = passes_for<T>();
  __shared__ __align__(16) float ks[2][BK * LDS];
  __shared__ __align__(16) float vs[2][BK * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const size_t base = (size_t)blockIdx.x * L * D;
  const int r0 = (blockIdx.y * W + warp) * 16;
  const int nk = (L + BK - 1) / BK;

  // one tile: BK rows of K (and of V), 4 chunks of 4 a row, zero past L
  auto load = [&](int kt, int slot, bool with_v) {
    for (int e = tid; e < BK * 4; e += 32 * W) {
      const int row = e >> 2, c = (e & 3) * 4, key = kt * BK + row;
      const bool ok = key < L;
      const size_t src = base + (size_t)(ok ? key : 0) * D + c;
      copy4(&ks[slot][row * LDS + c], k + src, ok);
      if (with_v) copy4(&vs[slot][row * LDS + c], v + src, ok);
    }
    cp_async_commit();
  };
  // the K tiles in a two-stage ring, tile 0 already in flight; body(kt, K
  // tile, V tile)
  auto sweep = [&](bool with_v, auto&& body) {
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<0>();  // tile kt has landed
      __syncthreads();     // ... for all, and tile kt - 1's slot is read
      if (kt + 1 < nk) load(kt + 1, (kt + 1) & 1, with_v);
      body(kt, ks[kt & 1], vs[kt & 1]);
    }
  };

  load(0, 0, !kBf16);  // the first sweep's tile 0, in flight as Q loads
  uint32_t qb[2][4], qs[2][4];
  q_fragments<PASSES>(q, base, r0, L, gid, tq, qb, qs);
  float acc[2][4];  // O: d tiles 0-7 and 8-15, rows gid and gid + 8
#pragma unroll
  for (int dn = 0; dn < 2; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dn][i] = 0.f;
  // running max (log2 units) and this thread's part of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  auto quad_sum = [&] {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
  };

  if constexpr (kBf16) {  // sweep 1: m and l
    sweep(false, [&](int kt, const float* kp, const float*) {
      float s[8][4], corr[2];
      score_tile<PASSES>(kp, lane, kt, L, scale_log2, qb, qs, s);
      softmax_tile(s, m, l, corr);
    });
    quad_sum();
    __syncthreads();  // every warp is done with sweep 1's tiles
    load(0, 0, true);
  }
  sweep(true, [&](int kt, const float* kp, const float* vp) {
    float s[8][4], part[2][4];
    float corr[2] = {1.f, 1.f};  // bf16: O is not rescaled
    score_tile<PASSES>(kp, lane, kt, L, scale_log2, qb, qs, s);
    if constexpr (kBf16) {
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[g][i] = __bfloat162float(__float2bfloat16_rn(
              exp2f(s[g][i] - m[i >> 1]) / l[i >> 1]));
    } else {
      softmax_tile(s, m, l, corr);
    }
    // a fresh fragment a tile, joined by fp32 adds (the mma's own
    // accumulation drifts over long K)
    pv_tile<PASSES>(s, vp, gid, tq, part);
#pragma unroll
    for (int dn = 0; dn < 2; ++dn)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[dn][i] = acc[dn][i] * corr[i >> 1] + part[dn][i];
  });
  if constexpr (!kBf16) quad_sum();

  // O / l (bf16: P was normalised), rows below L
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + gid + 8 * hh;
    if (r >= L) continue;
    const float div = kBf16 ? 1.f : l[hh];
    T* orow = o + base + (size_t)r * D + 2 * tq;
#pragma unroll
    for (int dn = 0; dn < 2; ++dn)
      put2(orow + dn * 8, acc[dn][2 * hh] / div, acc[dn][2 * hh + 1] / div);
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

template <class T>
int flash(const T* q, const T* k, const T* v, T* o, int nh, int L,
          float scale_log2, int warps, cudaStream_t st) {
  if (L < 1 || nh < 0 || misaligned(q) || misaligned(k) || misaligned(v) ||
      misaligned(o))
    return (int)cudaErrorInvalidValue;
  if (nh == 0) return 0;
  const dim3 grid(nh, (L + 16 * warps - 1) / (16 * warps));
  switch (warps) {
    case 1:
      att_flash_tc<1, T><<<grid, 32, 0, st>>>(q, k, v, o, L, scale_log2);
      break;
    case 2:
      att_flash_tc<2, T><<<grid, 64, 0, st>>>(q, k, v, o, L, scale_log2);
      break;
    case 4:
      att_flash_tc<4, T><<<grid, 128, 0, st>>>(q, k, v, o, L, scale_log2);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
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

// The bf16 variants: q, k, v, o (nh, L, 16) contiguous bf16, 16-byte
// aligned; otherwise as se_att_flash_tc and se_att_small_l.
extern "C" int se_att_flash_tc_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    int nh, int L, float scale_log2,
                                    int warps, void* stream) {
  return flash(q, k, v, o, nh, L, scale_log2, warps, (cudaStream_t)stream);
}

extern "C" int se_att_small_l_bf16(const __nv_bfloat16* q,
                                   const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, __nv_bfloat16* o,
                                   int nh, int L, float scale_log2,
                                   void* stream) {
  return small_l(q, k, v, o, nh, L, scale_log2, (cudaStream_t)stream);
}
