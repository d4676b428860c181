// The tensor-core building blocks shared by csrc/lstm.cu, csrc/decoder.cu,
// csrc/encoder.cu, csrc/dsconv.cu and csrc/attention.cu: cp.async copies
// into shared memory (zero-filled past a short source), the 3xTF32 operand
// split, ldmatrix of fp32 fragments, the mma.sync.m16n8k8 TF32 product
// with fp32 accumulation, one K step of 8 of a warp's tile product in 3, 2
// or 1 TF32 passes (`mma_step`), the main loop that runs it over a
// cp.async ring (`tc_ring`), the bf16 storage helpers, and the bf16
// fragments of the bf16 LSTM step
// (bf16 cp.async and ldmatrix, mma.sync.m16n8k16 bf16, the three-piece
// bf16 split of an fp32 operand; `ldsm_x4_t`, the transposed bf16
// ldmatrix of the bf16 attention's V), and the bf16 main loop built from
// them (`bfr::ring`: the bf16 encoder and decoder levels, DSConv pair
// stage and LSTM projection). sm_80 and up.
//
// The bf16 variants of the single DSConv block, attention's short-L
// kernel and the encoder's level 0 keep every tile in shared memory as
// fp32: a bf16 operand is widened as it is loaded
// (`copy4`, `copy1`: a plain load, converted, stored; no cp.async) and
// written back rounded to nearest even (`put`).
// A bf16 value is exact in TF32 (8 significant bits of TF32's 11), so a
// product of two bf16 operands is exact in one TF32 pass (PASSES = 1),
// and a product of an fp32 operand A with a bf16 operand B needs only
// A's split (PASSES = 2: small.B + big.B); both with fp32 accumulation,
// and both equal to the 3xTF32 result, whose third product is then zero.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// fp32 or bf16 storage: read as fp32, write rounded to nearest even.
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p) {
  const unsigned short raw =
      __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float((unsigned)raw << 16);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// two neighbours (p 2-element aligned)
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// four neighbours (p 4-element aligned)
__device__ __forceinline__ void put4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Four consecutive elements of src into the fp32 shared tile at dst (16
// bytes aligned), zeros where !ok (src must still be a valid address):
// fp32 by a 16-byte cp.async, bf16 by an 8-byte load widened in registers.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  cp_async16(dst, src, ok ? 16 : 0);
}
__device__ __forceinline__ void copy4(float* dst, const __nv_bfloat16* src,
                                      bool ok) {
  uint2 raw = make_uint2(0u, 0u);
  if (ok) raw = __ldg(reinterpret_cast<const uint2*>(src));
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
      __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}
// Four zeros (dst 16 bytes aligned).
__device__ __forceinline__ void zero4(float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
}
// One element likewise.
__device__ __forceinline__ void copy1(float* dst, const float* src, bool ok) {
  cp_async4(dst, src, ok ? 4 : 0);
}
__device__ __forceinline__ void copy1(float* dst, const __nv_bfloat16* src,
                                      bool ok) {
  *dst = ok ? ldg_f(src) : 0.f;
}

// TF32 passes of a product whose operands are fp32 (3), an fp32 A and a
// bf16-valued B (2), or both bf16-valued (1).
template <class T>
__host__ __device__ constexpr int passes_for() {
  return sizeof(T) == 2 ? 1 : 3;
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

// A lane's ldmatrix row address in a tile of row stride ld, in floats from
// the tile's origin: A's four 8 x 4 matrices are rows +0 / +8, k +0 / +4 of
// an m16 tile (a0..a3); B's are k +0 / +4 of n8 tile g, then of tile g + 1
// (b0, b1 of two n8 tiles).
__device__ __forceinline__ int lane_a_offset(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 4;
}

__device__ __forceinline__ int lane_b_offset(int lane, int ld) {
  return ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 4;
}

// ---- bf16 fragments (the bf16 LSTM step, lstm.cu `lstm_step_bf16`)

// 16 bytes of bf16 into shared memory (dst, src 16-byte aligned), zeros
// past `bytes` (0 or 16; src must still be a valid address).
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8); register i of lane l holds elements 2 (l % 4)
// and 2 (l % 4) + 1 of row l / 4 of matrix i, the lower in the low half:
// the m16n8k16 bf16 fragment layout. Its byte offsets are the fp32 tiles'
// (8 bf16 = 4 floats): lane_a_offset / lane_b_offset in 4-byte words
// address a bf16 tile too.
__device__ __forceinline__ void ldsm_x4(uint32_t* r,
                                        const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// The same four matrices transposed: register i of lane l holds elements
// (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) of matrix i, the lower in
// the low half. From a row-major (K, N) tile (8 K rows of 8 N values a
// matrix) it is the m16n8k16 B fragment of k rows 2 (l % 4) + 0 / 1 at
// column l / 4 (bf16 attention's V: keys down, d across).
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r,
                                          const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// d += a . b on a 16 x 8 x 16 tile of bf16 operands, fp32 accumulate. The
// accumulator layout is m16n8k8's: d0, d1 row lane / 4, columns 2 (lane %
// 4) + 0 / 1; d2, d3 the same, 8 rows down.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two fp32 values as one bf16x2 register (each to nearest even; the first
// in the low half, the lower K index of a fragment), and back.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// v = hi + mid + lo in three bf16 pieces, each the bf16 nearest what the
// pieces before leave: hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
// mid). The differences are exact in fp32 and the last one has at most 8
// significant bits, so the sum is v bit for bit wherever the pieces stay
// normal (|v| >= 1e-33; below, off by less than 1e-40), and each piece's
// product with a bf16 value is exact in fp32. Two values at a time.
__device__ __forceinline__ void split_bf16x3(float2 v, uint32_t& hi,
                                             uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16x2(v.x, v.y);
  float2 p = unpack_bf16x2(hi);
  v = make_float2(v.x - p.x, v.y - p.y);
  mid = pack_bf16x2(v.x, v.y);
  p = unpack_bf16x2(mid);
  lo = pack_bf16x2(v.x - p.x, v.y - p.y);
}

// The A fragments as they are: the default of mma_step's and tc_ring's
// `prep`.
struct NoPrep {
  __device__ __forceinline__ void operator()(int, uint32_t (&)[2][4]) const {
  }
};

// One K step of 8: sum[mi][g] += A . B^T for the warp's two m16 tiles of A
// (as: the lane's address, lane_a_offset applied, at the step's k; row
// stride lda) and its NT n8 tiles of B (bs likewise, lane_b_offset; ldb),
// in PASSES TF32 products a pair: 3 (small.big + big.small + big.big), 2
// for a bf16-valued B (small.B + big.B) or 1 for bf16-valued A and B
// (A.B). prep(k, a) may rewrite the A fragments (fp32 bits) before the
// split; k is the step's K index, and register j of a[mi] holds row (lane
// / 4) + 8 (j & 1) of m tile mi at k + lane % 4 + 4 (j >> 1).
template <int NT, int PASSES = 3, class Prep>
__device__ __forceinline__ void mma_step(float (&sum)[2][NT][4],
                                         const float* as, int lda,
                                         const float* bs, int ldb, int k,
                                         Prep& prep) {
  static_assert(PASSES >= 1 && PASSES <= 3, "1, 2 or 3 TF32 passes");
  uint32_t a[2][4], b[NT][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) ldsm_x4(a[mi], as + mi * 16 * lda);
  prep(k, a);
#pragma unroll
  for (int g = 0; g < NT; g += 2) ldsm_x4(b[g], bs + g * 8 * ldb);
  if constexpr (PASSES == 1) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int g = 0; g < NT; ++g) mma_tf32(sum[mi][g], a[mi], b[g]);
  } else {
    uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_tf32(__uint_as_float(a[mi][j]), a_big[mi][j], a_small[mi][j]);
    if constexpr (PASSES == 2) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int g = 0; g < NT; ++g) {
          mma_tf32(sum[mi][g], a_small[mi], b[g]);
          mma_tf32(sum[mi][g], a_big[mi], b[g]);
        }
    } else {
      uint32_t b_big[NT][2], b_small[NT][2];
#pragma unroll
      for (int g = 0; g < NT; ++g)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          split_tf32(__uint_as_float(b[g][j]), b_big[g][j], b_small[g][j]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int g = 0; g < NT; ++g) {
          mma_tf32(sum[mi][g], a_small[mi], b_big[g]);
          mma_tf32(sum[mi][g], a_big[mi], b_small[g]);
          mma_tf32(sum[mi][g], a_big[mi], b_big[g]);
        }
    }
  }
}

// The 3xTF32 main loop: acc[m16 tile][n8 tile][fragment] = A . B^T over nk
// K stages of TK, for the warp's 32 A rows from a_row0 and its NT n8 tiles
// of B rows from b_row0. The stages pass through a STAGES-deep cp.async
// ring in shared memory, As (STAGES, TM, LDS) and Bs (STAGES, BROWS, LDS);
// load(kt, slot) issues stage kt's copies (every thread of the block) into
// ring slot `slot`; prep as mma_step's. FRESH: each stage sums into a fresh
// fragment that joins acc by fp32 adds (the mma's own accumulation rounds
// toward zero, which drifts over a long K); otherwise the mma accumulates
// into acc. Returns with every copy landed; a caller that reuses the ring
// must __syncthreads() first. PASSES as mma_step's.
template <int TM, int BROWS, int TK, int LDS, int STAGES, int NT, bool FRESH,
          int PASSES = 3, class Load, class Prep = NoPrep>
__device__ __forceinline__ void tc_ring(float (&acc)[2][NT][4],
                                        const float* As, const float* Bs,
                                        int nk, int a_row0, int b_row0,
                                        Load&& load, Prep prep = Prep()) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int g = 0; g < NT; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][g][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();              // ... for all, and stage kt - 1 is read
    const int next = kt + STAGES - 1;  // into the slot stage kt - 1 held
    if (next < nk) load(next, next % STAGES);
    cp_async_commit();
    const float* as = As + (kt % STAGES) * TM * LDS + a_row0 * LDS +
                      lane_a_offset(lane, LDS);
    const float* bs = Bs + (kt % STAGES) * BROWS * LDS + b_row0 * LDS +
                      lane_b_offset(lane, LDS);
    float part[2][NT][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int g = 0; g < NT; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[mi][g][j] = 0.f;
    float (&sum)[2][NT][4] = FRESH ? part : acc;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 8)
      mma_step<NT, PASSES>(sum, as + kk, LDS, bs + kk, LDS, kt * TK + kk,
                           prep);
    if (FRESH) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int g = 0; g < NT; ++g)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][g][j] += part[mi][g][j];
    }
  }
  cp_async_wait<0>();
}


// ---- the bf16 ring (encoder.cu `encoder_level_tc_bf16`, decoder.cu
// `decoder_level_tc_bf16`, dsconv.cu `dsconv_pre_bf16` /
// `dsconv_post_bf16`, lstm.cu `lstm_proj_bf16`; its swizzle and lane
// offsets also lstm.cu `lstm_recur_bf16`'s resident tiles)

namespace bfr {

constexpr int BK = 32;  // K a stage: two k16 steps; a row is 64 bytes of
                        // bf16 (4 16-byte chunks) or 128 of fp32 (8)

// Element offset of 16-byte chunk c of row r in a stage tile of BK-element
// rows, unpadded and swizzled (as lstm.cu's bf16 step): bf16, chunk c at c
// ^ ((r >> 1) & 3), so the 8 rows an ldmatrix matrix reads fall in 8
// distinct bank groups (wgmma's 64-byte K-major swizzle); fp32, chunk c at
// c ^ 2 (r & 3), so a half-warp's float2 fragment reads (4 rows x 2
// chunks) do. A row r + 32 i (bf16) or r + 16 i (fp32) keeps r's swizzle.
__device__ __forceinline__ int swz16(int r, int c) {
  return r * BK + ((c ^ ((r >> 1) & 3)) << 3);
}
__device__ __forceinline__ int swz32(int r, int c) {
  return r * BK + ((c ^ ((r & 3) << 1)) << 2);
}

// The lane's ldmatrix offsets in a swizzled bf16 tile for k16 step p of a
// stage: A's m16 x k16 tile at row a_row0 (a multiple of 16; matrices
// rows +0 / +8, k +0 / +8) or B's two n8 x k16 tiles at row b_row0 (a
// multiple of 8; k +0 / +8 of each). Every row a lane names has the
// swizzle (lane >> 1) & 3.
__device__ __forceinline__ void a_lanes(int a_row0, int (&ld)[2]) {
  const int lane = threadIdx.x & 31, sw = (lane >> 1) & 3;
  const int r = a_row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int p = 0; p < 2; ++p)
    ld[p] = r * BK + (((2 * p + (lane >> 4)) ^ sw) << 3);
}
__device__ __forceinline__ void b_lanes(int b_row0, int (&ld)[2]) {
  const int lane = threadIdx.x & 31, sw = (lane >> 1) & 3;
  const int r = b_row0 + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
  for (int p = 0; p < 2; ++p)
    ld[p] = r * BK + (((2 * p + ((lane >> 3) & 1)) ^ sw) << 3);
}

// A's m16n8k16 fragments read from a swizzled fp32 tile: register i of m
// tile mi in k16 step p is the float2 at row a_row0 + 16 mi + 8 (i & 1) +
// lane / 4, K 16 p + 8 (i >> 1) + 2 (lane % 4), at ld[2 p + (i >> 1)] +
// (16 mi + 8 (i & 1)) BK (a_row0 a multiple of 4).
__device__ __forceinline__ void x_lanes(int a_row0, int (&ld)[4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    ld[q] = (a_row0 + gid) * BK +
            (((2 * q + (tq >> 1)) ^ ((gid & 3) << 1)) << 2) + 2 * (tq & 1);
}

// An fp32 A fragment pair v (register i's two K values) as three bf16
// pieces, hi + mid + lo = v (split_bf16x3), into a[2] (hi), a[1] (mid) and
// a[0] (lo): `ring` sums a[0] first.
__device__ __forceinline__ void split3(float2 v, uint32_t (&a)[3][2][4],
                                       int mi, int i) {
  split_bf16x3(v, a[2][mi][i], a[1][mi][i], a[0][mi][i]);
}

// The bf16 main loop: acc[m16 tile][n8 tile][fragment] = A . B^T over nk
// K stages of BK, for the warp's 32 A rows and its NT (even) n8 tiles of B
// rows from b_row0, on bf16 mma.sync.m16n8k16 with fp32 accumulation. The
// stages pass through a STAGES-deep cp.async ring at `smem`: a slot is A
// (TM rows of BK elements of TA, swizzled: swz16 for bf16, swz32 for fp32)
// then B (BROWS rows of BK bf16, swz16). load(kt, as, bs) issues stage
// kt's copies (every thread of the block) into a slot's A and B;
// frag(p, k, as, a) forms the warp's A fragments of k16 step p of a stage
// (K index k) in PIECES bf16 pieces, a[piece][m16 tile][register], whose
// products are summed piece by piece, a[0] first. Each stage sums into a
// fresh fragment that joins acc by fp32 adds (the mma's own accumulation
// rounds toward zero, which drifts over a long K: decoder.cu). Returns
// with every copy landed; a caller that reuses the ring must
// __syncthreads() first.
template <int TM, int BROWS, int STAGES, int NT, int PIECES, class TA,
          class Load, class Frag>
__device__ __forceinline__ void ring(float (&acc)[2][NT][4],
                                     unsigned char* smem, int nk,
                                     int b_row0, Load&& load, Frag&& frag) {
  static_assert(NT % 2 == 0, "ldmatrix.x4 reads two n8 tiles of B");
  constexpr int A_SLOT = TM * BK * (int)sizeof(TA);
  constexpr int SLOT = A_SLOT + BROWS * BK * 2;
  auto a_slot = [&](int s) { return reinterpret_cast<TA*>(smem + s * SLOT); };
  auto b_slot = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * SLOT + A_SLOT);
  };
  int b_ld[2];
  b_lanes(b_row0, b_ld);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int g = 0; g < NT; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][g][j] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, a_slot(s), b_slot(s));
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();              // ... for all, and stage kt - 1 is read
    const int next = kt + STAGES - 1;  // into the slot stage kt - 1 held
    if (next < nk) load(next, a_slot(next % STAGES), b_slot(next % STAGES));
    cp_async_commit();
    const TA* as = a_slot(kt % STAGES);
    const __nv_bfloat16* bs = b_slot(kt % STAGES);
    float part[2][NT][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int g = 0; g < NT; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[mi][g][j] = 0.f;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t a[PIECES][2][4], b[NT][2];
      frag(p, kt * BK + 16 * p, as, a);
#pragma unroll
      for (int g = 0; g < NT; g += 2)
        ldsm_x4(b[g], bs + b_ld[p] + g * 8 * BK);
      // piece-major: the mmas in a row write different fragments
#pragma unroll
      for (int pc = 0; pc < PIECES; ++pc)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int g = 0; g < NT; ++g) mma_bf16(part[mi][g], a[pc][mi], b[g]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int g = 0; g < NT; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][g][j] += part[mi][g][j];
  }
  cp_async_wait<0>();
}

}  // namespace bfr

// A kernel's resources as the runtime reports them, for a launch of
// `threads` threads and `smem` dynamic shared bytes: out[0] registers a
// thread, out[1] local (spill) bytes a thread, out[2] smem, out[3]
// resident blocks an SM.
template <class Kernel>
int kernel_resources(Kernel kernel, int threads, int smem, int* out) {
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = smem;
  out[3] = blocks;
  return 0;
}

}  // namespace
