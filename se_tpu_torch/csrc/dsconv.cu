// The gated dilated DSConv blocks of the Uformer conformer, fp32.
//
// Replaces: se_tpu/ops/pallas_dsconv.py
//   - `_pallas_dsconv` and its body `_kernel` / `_block_math` (entry
//     `dsconv_block`): one block, C entry `se_dsconv_fwd`;
//   - `_pallas_pair` and its body `_pair_kernel` / `_pair_math` (entry
//     `dsconv_pair_block`): one conformer stage, the complex block, the
//     real block and the cross-branch fusion, C entry `se_dsconv_pair_fwd`.
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
//
// The stage runs the pre kernel once for each branch and then one
// dsconv_pair_post, which runs the post stage of both branches for the
// same 16 rows into shared memory (40 KB at the conformer's widths, the
// outputs kept in the dead part of the tap buffer) and applies the fusion
// before it writes: no channel concat, no output round trip per branch
// and no elementwise passes for the fusion. Its bound is the sum of the
// two blocks' (the fusion is ~10 flops a channel).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int R = 16;         // rows of (b, t, f) per block
constexpr int THREADS = 128;
constexpr float LN_EPS = 1e-5f;
constexpr float FUSION_EPS = 1.1920929e-07f;  // float32 eps

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

// The post-stage weights of one branch (se_tpu's `_dsconv_params` from
// wd1 on).
struct PostParams {
  const float *wd1, *bd1, *wd2, *bd2, *g2, *b2, *ws, *bs;
};

// The post stage of one block for rows [row0, row0 + nrows): the two
// dilated convs on y, a * sigmoid(g), LN2, z * sigmoid(z), the 1x1 conv and
// the residual. Hands each output (row r, channel ch, value) to `emit`.
// P (R * 9 * tot) and A (R * tot) are shared-memory scratch.
template <class Emit>
__device__ void post_rows(const float* __restrict__ x,
                          const float* __restrict__ y, const PostParams& p,
                          int row0, int nrows, int T, int F, int cin,
                          int tot, int ncomp, int d1, int d2, float* P,
                          float* A, float* mu, float* rs, Emit emit) {
  const float *__restrict__ wd1 = p.wd1, *__restrict__ bd1 = p.bd1,
              *__restrict__ wd2 = p.wd2, *__restrict__ bd2 = p.bd2,
              *__restrict__ ws = p.ws, *__restrict__ bs = p.bs;
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
  ln_rows(A, nrows, tot, ncomp, p.g2, p.b2, mu, rs);
  for (int i = threadIdx.x; i < nrows * tot; i += blockDim.x)
    A[i] = A[i] * sigmoidf(A[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * cin; i += blockDim.x) {
    const int r = i / cin, ch = i % cin;
    const float* ar = A + r * tot;
    float acc = 0.f;
    for (int o = 0; o < tot; ++o) acc = fmaf(ar[o], ws[o * cin + ch], acc);
    emit(r, ch, x[(size_t)(row0 + r) * cin + ch] + (acc + bs[ch]));
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
  __shared__ float mu[2 * R], rs[2 * R];
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, rows - row0);
  const PostParams p{wd1, bd1, wd2, bd2, g2, b2, ws, bs};
  post_rows(x, y, p, row0, nrows, T, F, cin, tot, ncomp, d1, d2, smem,
            smem + R * 9 * tot, mu, rs,
            [&](int r, int ch, float v) {
              out[(size_t)(row0 + r) * cin + ch] = v;
            });
}

// Shared-memory layout of dsconv_pair_post, in floats: the gather buffer
// P, then A. The complex branch's outputs Oc (R x cc) are written into P
// past the part the real branch gathers into (P's complex taps are dead
// by then), and the real branch's outputs Om (R x cm) over the real
// branch's own taps, dead by then too, where they fit; so the stage needs
// no more shared memory than the complex block alone (40 KB at the
// conformer's widths: 5 blocks an SM, not 3 with separate buffers).
struct PairLayout {
  int oc, om, a, total;
  __host__ __device__ PairLayout(int cm, int totc, int totm) {
    const int cc = 2 * cm, totmax = totc > totm ? totc : totm;
    oc = R * 9 * totm;
    om = cm <= 9 * totm ? 0 : oc + R * cc;
    int p = R * 9 * totmax;
    p = p > oc + R * cc ? p : oc + R * cc;
    p = p > om + R * cm ? p : om + R * cm;
    a = p;
    total = p + R * totmax;
  }
};

// One conformer stage: the post stage of the complex block (ncomp 2, on
// xc = [re | im], cc = 2 cm channels) and of the real block (ncomp 1, on
// xm, cm channels) for the same R rows, each into shared memory, then
// Uformer's fusion, written once:
//   |z| = sqrt(max(re^2 + im^2, EPS)), s = sigmoid(m),
//   oc = [re + s | im + s], om = m + sigmoid(|z|).
__global__ void __launch_bounds__(THREADS)
dsconv_pair_post(const float* __restrict__ xc, const float* __restrict__ yc,
                 PostParams pc, const float* __restrict__ xm,
                 const float* __restrict__ ym, PostParams pm,
                 float* __restrict__ oc, float* __restrict__ om, int rows,
                 int T, int F, int cm, int totc, int totm, int d1, int d2) {
  extern __shared__ float smem[];
  __shared__ float mu[2 * R], rs[2 * R];
  const int cc = 2 * cm;
  const PairLayout lay(cm, totc, totm);
  float* P = smem;
  float* A = smem + lay.a;
  float* Oc = smem + lay.oc;
  float* Om = smem + lay.om;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, rows - row0);
  // the emit of a branch runs after its last read of P (post_rows)
  post_rows(xc, yc, pc, row0, nrows, T, F, cc, totc, 2, d1, d2, P, A, mu,
            rs, [&](int r, int ch, float v) { Oc[r * cc + ch] = v; });
  __syncthreads();
  post_rows(xm, ym, pm, row0, nrows, T, F, cm, totm, 1, d1, d2, P, A, mu,
            rs, [&](int r, int ch, float v) { Om[r * cm + ch] = v; });
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * cm; i += blockDim.x) {
    const int r = i / cm, ch = i % cm;
    const float re = Oc[r * cc + ch], im = Oc[r * cc + cm + ch];
    const float m = Om[i];
    const float s = sigmoidf(m);
    const float mag = sqrtf(fmaxf(re * re + im * im, FUSION_EPS));
    const size_t orow = (size_t)(row0 + r);
    oc[orow * cc + ch] = re + s;
    oc[orow * cc + cm + ch] = im + s;
    om[orow * cm + ch] = m + sigmoidf(mag);
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

// One conformer stage (se_tpu's `dsconv_pair_block`): xc (B, T, F, 2cm)
// and xm (B, T, F, cm) -> oc, om of the same shapes. yc (B, T, F, totc)
// and ym (B, T, F, totm) are scratch for the pre stages.
extern "C" int se_dsconv_pair_fwd(
    const float* xc, const float* gc1, const float* bc1, const float* wc1,
    const float* bbc1, const float* ac, const float* wdc1, const float* bdc1,
    const float* wdc2, const float* bdc2, const float* gc2, const float* bc2,
    const float* wsc, const float* bsc, const float* xm, const float* gm1,
    const float* bm1, const float* wm1, const float* bbm1, const float* am,
    const float* wdm1, const float* bdm1, const float* wdm2,
    const float* bdm2, const float* gm2, const float* bm2, const float* wsm,
    const float* bsm, float* yc, float* ym, float* oc, float* om, int B,
    int T, int F, int cm, int totc, int totm, int d1, int d2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * T * F, cc = 2 * cm;
  const int blocks = (rows + R - 1) / R;
  dsconv_pre<<<blocks, THREADS, R * cc * sizeof(float), st>>>(
      xc, gc1, bc1, wc1, bbc1, ac, yc, rows, cc, totc, 2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dsconv_pre<<<blocks, THREADS, R * cm * sizeof(float), st>>>(
      xm, gm1, bm1, wm1, bbm1, am, ym, rows, cm, totm, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const PostParams pc{wdc1, bdc1, wdc2, bdc2, gc2, bc2, wsc, bsc};
  const PostParams pm{wdm1, bdm1, wdm2, bdm2, gm2, bm2, wsm, bsm};
  const size_t smem = PairLayout(cm, totc, totm).total * sizeof(float);
  err = cudaFuncSetAttribute(dsconv_pair_post,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dsconv_pair_post<<<blocks, THREADS, smem, st>>>(
      xc, yc, pc, xm, ym, pm, oc, om, rows, T, F, cm, totc, totm, d1, d2);
  return (int)cudaGetLastError();
}
