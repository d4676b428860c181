// Scaled-dot-product attention, softmax(q k^T * scale) v, fp32, D = 16.
//
// Replaces: se_tpu/ops/pallas_attention.py, `_pallas_attention` and its
// body `_att_kernel` (entry `sdp_attention`).
//
// Bound on the H100: each (n, h) does 4*L*L*D flops on 4*L*D*4 bytes
// (q, k, v read, o written), L/4 flops a byte. On the T-attention
// (L = 401) that is ~100 flops a byte, above the fp32 ridge of ~20 (67
// TFLOP/s over 3.35 TB/s): bound by operations. On the F-attention
// (L = 4) it is 1 flop a byte: bound by bytes. The TPU kernel held the
// whole (L, L) energy of one (n, all heads) in VMEM; here K/V of one head
// at L = 2048 (256 KB) do not fit a block's shared memory.
//
// Design: one block per (n*h, tile of query rows), one thread per query
// row with q and the 16 output accumulators in registers. K and V stream
// through shared memory in tiles of 64 rows; each tile updates a running
// max and sum (online softmax, rescaled per tile), so the (L, L) energy
// never exists anywhere and any L >= 1 works. All threads of a block read
// the same K/V row at once (a shared-memory broadcast). fp32 throughout.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 16;
constexpr int BK = 64;

__global__ void att_fwd_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, int L, float scale) {
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  const size_t base = (size_t)blockIdx.x * L * D;
  const int row = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = row < L;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? q[base + (size_t)row * D + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    const int nk = min(BK, L - k0);
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < nk * D; i += blockDim.x) {
      ks[i / D][i % D] = k[base + (size_t)k0 * D + i];
      vs[i / D][i % D] = v[base + (size_t)k0 * D + i];
    }
    __syncthreads();
    if (!active) continue;

    float s[BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      if (j < nk) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
        s[j] = dot * scale;
        tmax = fmaxf(tmax, s[j]);
      }
    }
    const float mnew = fmaxf(m, tmax);
    const float corr = expf(m - mnew);  // 0 on the first tile
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      if (j < nk) {
        const float p = expf(s[j] - mnew);
        l += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
      }
    }
    m = mnew;
  }
  if (active) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) o[base + (size_t)row * D + d] = acc[d] * inv;
  }
}

}  // namespace

// q, k, v, o: (nh, L, 16) contiguous fp32.
extern "C" int se_attention_fwd(const float* q, const float* k,
                                const float* v, float* o, int nh, int L,
                                float scale, void* stream) {
  const int threads = L >= 128 ? 128 : (L >= 64 ? 64 : 32);
  const dim3 grid(nh, (L + threads - 1) / threads);
  att_fwd_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(q, k, v, o, L,
                                                            scale);
  return (int)cudaGetLastError();
}
