// One gated dilated DSConv block of the Uformer conformer, fp32.
//
// Replaces: se_tpu/ops/pallas_dsconv.py, `_pallas_dsconv` and its body
// `_kernel` / `_block_math` (entry `dsconv_block`).
//
// Bound on the H100: by operations. At the main path's shapes (x (B, T,
// 4, 256) complex with Cm = 64, (B, T, 4, 128) real with Cm = 32) a row
// of x costs 4*Cin*Cm flops in the two 1x1 convs plus 2*Cm*Cm for each
// tap of the two dilated 3x3 convs that lands inside (T, F): at F = 4
// only 10 of 12 F-taps do, and at T = 401 with d = 128 only 947 of 1203
// T-taps. That is 175-186 kflop a row complex and 44-46 kflop real over
// the eight dilation pairs (82-87% of the 213 and 53 kflop with every tap
// counted), on 2*Cin*4 bytes (x read, out written): 86-91 and 43-45
// flops a byte, above the fp32 ridge of ~20 (67 TFLOP/s over 3.35 TB/s).
//
// The TPU kernel held y = (T, F, Cm) of one batch item in VMEM. On the
// card that is 401*4*64*4 B = 410 KB, more than a block's shared memory,
// and each output row reads y at t +- d with d up to 128. So the block
// is split at y, into two launches behind one entry:
//   (a) dsconv_pre: 16 rows a block. LN1 per component segment -> 1x1
//       conv -> PReLU, into the scratch tensor y (B, T, F, Cm).
//   (b) dsconv_post: 16 rows a block. Gathers the 9 taps of y for each
//       dilated conv (zero padding (d, d) on T, (1, 1) on F) into shared
//       memory, then a * sigmoid(g) -> LN2 per component -> z * sigmoid(z)
//       -> 1x1 conv -> + x.
// In both, a thread computes one (row, out channel) sum at a time: the
// row's input sits in shared memory (a broadcast), the weight column is
// read from L1/L2 by consecutive threads (coalesced).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int R = 16;         // rows of (b, t, f) per block
constexpr int THREADS = 128;
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// LN over each of `ncomp` equal segments of rows z (nrows, width) held in
// shared memory, with shared gamma/beta pre-tiled to the full width.
__device__ void ln_rows(float* z, int nrows, int width, int ncomp,
                        const float* __restrict__ g,
                        const float* __restrict__ b, float* mu,
                        float* rs) {
  const int c = width / ncomp;
  if (threadIdx.x < nrows * ncomp) {
    const float* seg = z + (threadIdx.x / ncomp) * width +
                       (threadIdx.x % ncomp) * c;
    float sum = 0.f;
    for (int i = 0; i < c; ++i) sum += seg[i];
    const float mean = sum / c;
    float sq = 0.f;
    for (int i = 0; i < c; ++i) {
      const float d = seg[i] - mean;
      sq += d * d;
    }
    mu[threadIdx.x] = mean;
    rs[threadIdx.x] = rsqrtf(sq / c + LN_EPS);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * width; i += blockDim.x) {
    const int r = i / width, ch = i % width, s = r * ncomp + ch / c;
    z[i] = (z[i] - mu[s]) * rs[s] * g[ch] + b[ch];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
dsconv_pre(const float* __restrict__ x, const float* __restrict__ g1,
           const float* __restrict__ b1, const float* __restrict__ w1,
           const float* __restrict__ bb1, const float* __restrict__ alpha,
           float* __restrict__ y, int rows, int cin, int tot, int ncomp) {
  extern __shared__ float xs[];  // R * cin
  __shared__ float mu[2 * R], rs[2 * R];
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, rows - row0);
  for (int i = threadIdx.x; i < nrows * cin; i += blockDim.x)
    xs[i] = x[(size_t)row0 * cin + i];
  __syncthreads();
  ln_rows(xs, nrows, cin, ncomp, g1, b1, mu, rs);
  const float a = *alpha;
  for (int i = threadIdx.x; i < nrows * tot; i += blockDim.x) {
    const int r = i / tot, o = i % tot;
    const float* xr = xs + r * cin;
    float acc = 0.f;
    for (int ch = 0; ch < cin; ++ch) acc = fmaf(xr[ch], w1[ch * tot + o], acc);
    acc += bb1[o];
    y[(size_t)row0 * tot + i] = acc >= 0.f ? acc : a * acc;
  }
}

// P[r][tap * tot + ch] = y at (t + (tap/3 - 1) * d, f + tap%3 - 1), or 0.
__device__ void gather_taps(const float* __restrict__ y, float* P, int row0,
                            int nrows, int T, int F, int tot, int d) {
  const int width = 9 * tot;
  for (int i = threadIdx.x; i < nrows * width; i += blockDim.x) {
    const int r = i / width, rem = i % width, tap = rem / tot,
              ch = rem % tot;
    const int row = row0 + r;
    const int f = row % F, bt = row / F, t = bt % T, b = bt / T;
    const int tt = t + (tap / 3 - 1) * d, ff = f + tap % 3 - 1;
    P[i] = (tt >= 0 && tt < T && ff >= 0 && ff < F)
               ? y[(((size_t)b * T + tt) * F + ff) * tot + ch]
               : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
dsconv_post(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ wd1, const float* __restrict__ bd1,
            const float* __restrict__ wd2, const float* __restrict__ bd2,
            const float* __restrict__ g2, const float* __restrict__ b2,
            const float* __restrict__ ws, const float* __restrict__ bs,
            float* __restrict__ out, int rows, int T, int F, int cin,
            int tot, int ncomp, int d1, int d2) {
  extern __shared__ float smem[];
  float* P = smem;               // R * 9 * tot
  float* A = smem + R * 9 * tot;  // R * tot
  __shared__ float mu[2 * R], rs[2 * R];
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, rows - row0);
  const int width = 9 * tot;

  gather_taps(y, P, row0, nrows, T, F, tot, d1);
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * tot; i += blockDim.x) {
    const int r = i / tot, o = i % tot;
    const float* pr = P + r * width;
    float acc = 0.f;
    for (int kk = 0; kk < width; ++kk) acc = fmaf(pr[kk], wd1[kk * tot + o], acc);
    A[i] = acc + bd1[o];
  }
  __syncthreads();
  gather_taps(y, P, row0, nrows, T, F, tot, d2);
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * tot; i += blockDim.x) {
    const int r = i / tot, o = i % tot;
    const float* pr = P + r * width;
    float acc = 0.f;
    for (int kk = 0; kk < width; ++kk) acc = fmaf(pr[kk], wd2[kk * tot + o], acc);
    A[i] *= sigmoidf(acc + bd2[o]);
  }
  __syncthreads();
  ln_rows(A, nrows, tot, ncomp, g2, b2, mu, rs);
  for (int i = threadIdx.x; i < nrows * tot; i += blockDim.x)
    A[i] = A[i] * sigmoidf(A[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * cin; i += blockDim.x) {
    const int r = i / cin, ch = i % cin;
    const float* ar = A + r * tot;
    float acc = 0.f;
    for (int o = 0; o < tot; ++o) acc = fmaf(ar[o], ws[o * cin + ch], acc);
    const size_t gi = (size_t)row0 * cin + i;
    out[gi] = x[gi] + (acc + bs[ch]);
  }
}

}  // namespace

// x, out: (B, T, F, cin); y: scratch (B, T, F, tot). Weights as documented
// in se_tpu_torch/ops/dsconv.py. ncomp is 1 or 2, tot <= 64.
extern "C" int se_dsconv_fwd(const float* x, const float* g1, const float* b1,
                             const float* w1, const float* bb1,
                             const float* alpha, const float* wd1,
                             const float* bd1, const float* wd2,
                             const float* bd2, const float* g2,
                             const float* b2, const float* ws,
                             const float* bs, float* y, float* out, int B,
                             int T, int F, int cin, int tot, int ncomp,
                             int d1, int d2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * T * F;
  const int blocks = (rows + R - 1) / R;
  dsconv_pre<<<blocks, THREADS, R * cin * sizeof(float), st>>>(
      x, g1, b1, w1, bb1, alpha, y, rows, cin, tot, ncomp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dsconv_post<<<blocks, THREADS, R * 10 * tot * sizeof(float), st>>>(
      x, y, wd1, bd1, wd2, bd2, g2, b2, ws, bs, out, rows, T, F, cin, tot,
      ncomp, d1, d2);
  return (int)cudaGetLastError();
}
