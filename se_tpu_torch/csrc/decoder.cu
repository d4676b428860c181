// One Uformer decoder level, both branches, fp32: stride-(1, 2) (2, 5)
// transposed conv of the [skip, x] concat in phase-split form -> (BN
// affine -> PReLU when has_bn) for the complex (interleaved [re | im]) and
// the real branch, then `fusion`.
//
// Replaces: se_tpu/ops/pallas_decoder.py, `_pallas_level` and its body
// `_kernel` / `_level_math` / `_tconv_phase_split` (entry `decoder_level`).
//
// Bound on the H100: by operations at the deep levels, by bytes at the
// last ones. An input position (b, t, q) yields two output columns at
// 2*10*5*Cc*Cout flops (Cc = the per-component concat width) against
// (3*Cc + 2*3*Cout)*4 bytes read once or written: level 0 (Cc = 256,
// Cout = 128) ~530 flops a byte, level 5 (Cc = 16, Cout = 1) ~7. The fp32
// ridge is ~20 (67 TFLOP/s over 3.35 TB/s).
//
// Design: one thread per (b, t, q, c) produces the even output column 2q
// (taps wf0/2/4 over x[q-1..q+1]) and the odd column 2q+1 (taps wf1/3
// over x[q..q+1]) of the complex channels c and c + Cout and of the real
// channel c: no zeros are inserted and no tap multiplies a zero. BN,
// PReLU and `fusion` couple exactly those values and stay in registers.
// T is causal (rows t-1 and t), so the output is already trimmed to the
// input's T. c is the fastest index: a warp reads the same input
// (broadcast) and consecutive weight columns (coalesced); weights come
// through L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float FUSION_EPS = 1.1920929e-07f;  // np.finfo(np.float32).eps

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float prelu(float x, float a) {
  return x >= 0.f ? x : a * x;
}

// Accumulate one input position's contribution through tap `tap` of a
// phase weight (n_taps, 2cc, 2cout) / (n_taps, cc, cout).
__device__ __forceinline__ void tap_accum(
    const float* __restrict__ xcr, const float* __restrict__ xmr,
    const float* __restrict__ wc, const float* __restrict__ wm, int tap,
    int cc, int cout, int c, float& re, float& im, float& m) {
  const int c2in = 2 * cc, c2out = 2 * cout;
  const float* wcr = wc + (size_t)tap * c2in * c2out;
  for (int ci = 0; ci < c2in; ++ci) {
    const float xv = xcr[ci];
    re = fmaf(xv, wcr[ci * c2out + c], re);
    im = fmaf(xv, wcr[ci * c2out + cout + c], im);
  }
  const float* wmr = wm + (size_t)tap * cc * cout;
  for (int ci = 0; ci < cc; ++ci) m = fmaf(xmr[ci], wmr[ci * cout + c], m);
}

__global__ void decoder_level_kernel(
    const float* __restrict__ xc, const float* __restrict__ xm,
    const float* __restrict__ wce, const float* __restrict__ wco,
    const float* __restrict__ bc, const float* __restrict__ sc,
    const float* __restrict__ tc, const float* __restrict__ ac,
    const float* __restrict__ wme, const float* __restrict__ wmo,
    const float* __restrict__ bm, const float* __restrict__ sm,
    const float* __restrict__ tm, const float* __restrict__ am,
    float* __restrict__ yc, float* __restrict__ ym, int B, int T, int F,
    int cc, int cout, int has_bn) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)B * T * F * cout;
  if (idx >= total) return;
  const int c = idx % cout;
  const size_t p = idx / cout;  // (b, t, q) input position
  const int q = p % F;
  const size_t bt = p / F;
  const int t = bt % T;
  const size_t b = bt / T;

  // [even, odd] accumulators of re, im, m
  float re[2] = {0.f, 0.f}, im[2] = {0.f, 0.f}, m[2] = {0.f, 0.f};
  for (int it = 0; it < 2; ++it) {
    const int tt = t + it - 1;
    if (tt < 0) continue;
    for (int jf = 0; jf < 3; ++jf) {  // even phase: x[q + jf - 1]
      const int ff = q + jf - 1;
      if (ff < 0 || ff >= F) continue;
      const size_t pos = (b * T + tt) * F + ff;
      tap_accum(xc + pos * 2 * cc, xm + pos * cc, wce, wme, it * 3 + jf, cc,
                cout, c, re[0], im[0], m[0]);
    }
    for (int jf = 0; jf < 2; ++jf) {  // odd phase: x[q + jf]
      const int ff = q + jf;
      if (ff >= F) continue;
      const size_t pos = (b * T + tt) * F + ff;
      tap_accum(xc + pos * 2 * cc, xm + pos * cc, wco, wmo, it * 2 + jf, cc,
                cout, c, re[1], im[1], m[1]);
    }
  }
  const float a_c = *ac, a_m = *am;
  for (int ph = 0; ph < 2; ++ph) {
    float r = re[ph] + bc[c], i = im[ph] + bc[cout + c], g = m[ph] + bm[c];
    if (has_bn) {
      r = prelu(r * sc[c] + tc[c], a_c);
      i = prelu(i * sc[cout + c] + tc[cout + c], a_c);
      g = prelu(g * sm[c] + tm[c], a_m);
    }
    const float cmag = sqrtf(fmaxf(r * r + i * i, FUSION_EPS));
    const float s = sigmoidf(g);
    const size_t o = p * 2 + ph;  // output position (b, t, 2q + ph)
    yc[o * 2 * cout + c] = r + s;
    yc[o * 2 * cout + cout + c] = i + s;
    ym[o * cout + c] = g + sigmoidf(cmag);
  }
}

}  // namespace

// xc (B, T, F, 2cc), xm (B, T, F, cc) -> yc (B, T, 2F, 2cout),
// ym (B, T, 2F, cout). Weights as documented in se_tpu_torch/ops/decoder.py.
extern "C" int se_decoder_level(const float* xc, const float* xm,
                                const float* wce, const float* wco,
                                const float* bc, const float* sc,
                                const float* tc, const float* ac,
                                const float* wme, const float* wmo,
                                const float* bm, const float* sm,
                                const float* tm, const float* am, float* yc,
                                float* ym, int B, int T, int F, int cc,
                                int cout, int has_bn, void* stream) {
  const size_t total = (size_t)B * T * F * cout;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  decoder_level_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      xc, xm, wce, wco, bc, sc, tc, ac, wme, wmo, bm, sm, tm, am, yc, ym, B,
      T, F, cc, cout, has_bn);
  return (int)cudaGetLastError();
}
