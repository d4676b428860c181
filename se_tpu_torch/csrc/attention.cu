// Scaled-dot-product attention, softmax(q k^T * scale) v, fp32, D = 16.
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

  // one tile: BK rows of K and of V, 4 chunks of 16 bytes a row, zero past L
  auto load = [&](int kt, int slot) {
    for (int e = tid; e < BK * 4; e += 32 * W) {
      const int row = e >> 2, c = (e & 3) * 4, key = kt * BK + row;
      const bool ok = key < L;
      const size_t src = base + (size_t)(ok ? key : 0) * D + c;
      cp_async16(&ks[slot][row * LDS + c], k + src, ok ? 16 : 0);
      cp_async16(&vs[slot][row * LDS + c], v + src, ok ? 16 : 0);
    }
  };
  load(0, 0);
  cp_async_commit();

  // Q's A fragments of the two k8 steps, split once: register j of step s
  // is row gid + 8 (j & 1) at d = 8 s + tq + 4 (j >> 1)
  uint32_t qb[2][4], qsm[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + gid + 8 * (j & 1);
      const float a =
          r < L ? q[base + (size_t)r * D + 8 * s + tq + 4 * (j >> 1)] : 0.f;
      split_tf32(a, qb[s][j], qsm[s][j]);
    }

  float acc[2][4];  // O: d tiles 0-7 and 8-15, rows gid and gid + 8
#pragma unroll
  for (int dn = 0; dn < 2; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dn][i] = 0.f;
  // running max (log2 units) and this thread's part of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<0>();  // tile kt has landed
    __syncthreads();     // ... for all, and tile kt - 1's slot is read
    if (kt + 1 < nk) load(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    const float* kp = ks[kt & 1];
    const float* vp = vs[kt & 1];

    // S = Q K^T: n8 tile g holds keys 8 g + 2 tq + (0, 1) of rows gid,
    // gid + 8 (s[g][hh * 2 + j])
    float s[8][4];
#pragma unroll
    for (int g = 0; g < 8; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[g][i] = 0.f;
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int g = 0; g < 8; g += 2) {
        uint32_t b[4], bb[4], bsm[4];
        ldsm_x4(b, kp + g * 8 * LDS + st * 8 + lane_b_offset(lane, LDS));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_tf32(__uint_as_float(b[j]), bb[j], bsm[j]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_tf32(s[g + h], qsm[st], bb + 2 * h);
          mma_tf32(s[g + h], qb[st], bsm + 2 * h);
          mma_tf32(s[g + h], qb[st], bb + 2 * h);
        }
      }

    // scale, mask, the tile's row max, across the quad
    const int key0 = kt * BK + 2 * tq;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int g = 0; g < 8; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x =
            key0 + g * 8 + (i & 1) < L ? s[g][i] * scale_log2 : -INFINITY;
        s[g][i] = x;
        tmax[i >> 1] = fmaxf(tmax[i >> 1], x);
      }
    float corr[2];
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

    // O += P V, k8 step j over keys 8 j + (2 tq, 2 tq + 1) as (tq, tq + 4)
    float part[2][4];
#pragma unroll
    for (int dn = 0; dn < 2; ++dn)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[dn][i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
      uint32_t ab[4], asm_[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(pa[i], ab[i], asm_[i]);
      const float* vr = vp + (8 * j + 2 * tq) * LDS + gid;
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
#pragma unroll
    for (int dn = 0; dn < 2; ++dn)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[dn][i] = acc[dn][i] * corr[i >> 1] + part[dn][i];
  }

  // the row sums across the quad, then O / l, rows below L
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int r = r0 + gid + 8 * hh;
    if (r >= L) continue;
    float* orow = o + base + (size_t)r * D + 2 * tq;
#pragma unroll
    for (int dn = 0; dn < 2; ++dn)
      *reinterpret_cast<float2*>(orow + dn * 8) =
          make_float2(acc[dn][2 * hh] / l[hh], acc[dn][2 * hh + 1] / l[hh]);
  }
}

// pairs (n, h) pair0 .. pair0 + P of (nh, L, D), P = blockDim.x / L, one
// thread a query row; LM >= L bounds the unrolled score loop.
template <int LM>
__global__ void __launch_bounds__(SMALL_THREADS)
att_small_l(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, int nh, int L,
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
    cp_async16(qs + r * LDS + c, q + g0 + 4 * e, 16);
    cp_async16(kvs + r * LDS + c, k + g0 + 4 * e, 16);
    cp_async16(kvs + (pairs * L + r) * LDS + c, v + g0 + 4 * e, 16);
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
#pragma unroll
    for (int j = 0; j < LM; ++j) {
      if (j < L) {
        const float p = exp2f(s[j] - mx);
        l += p;
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
#pragma unroll
    for (int c = 0; c < D; c += 4)
      *reinterpret_cast<float4*>(qs + tid * LDS + c) = make_float4(
          acc[c] / l, acc[c + 1] / l, acc[c + 2] / l, acc[c + 3] / l);
  }
  __syncthreads();
  for (int e = tid; e < rows * 4; e += blockDim.x)
    *reinterpret_cast<float4*>(o + g0 + 4 * e) =
        *reinterpret_cast<const float4*>(qs + (e >> 2) * LDS + (e & 3) * 4);
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace

// q, k, v, o: (nh, L, 16) contiguous fp32, 16-byte aligned. scale_log2 =
// scale * log2(e). warps: 1, 2 or 4 query-row tiles of 16 a block.
extern "C" int se_att_flash_tc(const float* q, const float* k, const float* v,
                               float* o, int nh, int L, float scale_log2,
                               int warps, void* stream) {
  if (L < 1 || nh < 0 || misaligned(q) || misaligned(k) || misaligned(v) ||
      misaligned(o))
    return (int)cudaErrorInvalidValue;
  if (nh == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
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

// The same arguments; 1 <= L <= SMALL_L_MAX.
extern "C" int se_att_small_l(const float* q, const float* k, const float* v,
                              float* o, int nh, int L, float scale_log2,
                              void* stream) {
  if (L < 1 || L > SMALL_L_MAX || nh < 0 || misaligned(q) || misaligned(k) ||
      misaligned(v) || misaligned(o))
    return (int)cudaErrorInvalidValue;
  if (nh == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int pairs = SMALL_THREADS / L, threads = pairs * L;
  const unsigned blocks = (unsigned)((nh + pairs - 1) / pairs);
  const size_t smem = 3 * (size_t)threads * LDS * sizeof(float);
  if (L <= 4)
    att_small_l<4><<<blocks, threads, smem, st>>>(q, k, v, o, nh, L,
                                                  scale_log2);
  else if (L <= 8)
    att_small_l<8><<<blocks, threads, smem, st>>>(q, k, v, o, nh, L,
                                                  scale_log2);
  else if (L <= 16)
    att_small_l<16><<<blocks, threads, smem, st>>>(q, k, v, o, nh, L,
                                                   scale_log2);
  else
    att_small_l<32><<<blocks, threads, smem, st>>>(q, k, v, o, nh, L,
                                                   scale_log2);
  return (int)cudaGetLastError();
}
