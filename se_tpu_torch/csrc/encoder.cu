// One Uformer encoder level, both branches, fp32: stride-(1, 2) (2, 5)
// conv (T pad (1, 0) causal, F pad (2, 2)) -> BN affine -> PReLU for the
// complex (interleaved [re | im]) and the real branch, then `fusion`.
//
// Replaces: se_tpu/ops/pallas_encoder.py, `_pallas_level` and its body
// `_kernel` / `_level_math` (entry `encoder_level`).
//
// Bound on the H100: by operations at the deep levels, by bytes at the
// shallow ones. An output position (b, t, f_out) costs 2*10*5*Cin*Cout
// flops against (2*3*Cin + 3*Cout)*4 bytes of activations read once or
// written: level 0 (Cin = 1, Cout = 8) ~7 flops a byte, level 5 (Cin =
// Cout = 128) ~360. The fp32 ridge is ~20 (67 TFLOP/s over 3.35 TB/s).
//
// The TPU kernel read the stride-2 F taps through a parity view, because
// the TPU has no cheap strided loads, and was gated by a VMEM estimate.
// The card needs neither: it indexes padded column 2f + jf - 2 directly.
// Design: one thread per (b, t, f_out, c) computes the complex outputs c
// and c + Cout and the real output c, so BN, PReLU and `fusion`, which
// couple exactly those three values, stay in registers. c is the fastest
// index: the threads of a warp read the same input (a broadcast) and
// consecutive weight columns (coalesced). The weights (2.6 MB at level 5)
// are read through L2.

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

__global__ void encoder_level_kernel(
    const float* __restrict__ xc, const float* __restrict__ xm,
    const float* __restrict__ wc, const float* __restrict__ bc,
    const float* __restrict__ sc, const float* __restrict__ tc,
    const float* __restrict__ ac, const float* __restrict__ wm,
    const float* __restrict__ bm, const float* __restrict__ sm,
    const float* __restrict__ tm, const float* __restrict__ am,
    float* __restrict__ yc, float* __restrict__ ym, int B, int T, int F,
    int cin, int cout) {
  const int fo_n = F / 2;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)B * T * fo_n * cout;
  if (idx >= total) return;
  const int c = idx % cout;
  const size_t p = idx / cout;  // (b, t, fo) position
  const int fo = p % fo_n;
  const size_t bt = p / fo_n;
  const int t = bt % T;
  const size_t b = bt / T;
  const int c2in = 2 * cin, c2out = 2 * cout;

  float re = 0.f, im = 0.f, m = 0.f;
  for (int it = 0; it < 2; ++it) {
    const int tt = t + it - 1;
    if (tt < 0) continue;
    for (int jf = 0; jf < 5; ++jf) {
      const int ff = 2 * fo + jf - 2;
      if (ff < 0 || ff >= F) continue;
      const size_t pos = (b * T + tt) * F + ff;
      const float* xcr = xc + pos * c2in;
      const float* wcr = wc + (size_t)(it * 5 + jf) * c2in * c2out;
      for (int ci = 0; ci < c2in; ++ci) {
        const float xv = xcr[ci];
        re = fmaf(xv, wcr[ci * c2out + c], re);
        im = fmaf(xv, wcr[ci * c2out + cout + c], im);
      }
      const float* xmr = xm + pos * cin;
      const float* wmr = wm + (size_t)(it * 5 + jf) * cin * cout;
      for (int ci = 0; ci < cin; ++ci) m = fmaf(xmr[ci], wmr[ci * cout + c], m);
    }
  }
  re = prelu((re + bc[c]) * sc[c] + tc[c], *ac);
  im = prelu((im + bc[cout + c]) * sc[cout + c] + tc[cout + c], *ac);
  m = prelu((m + bm[c]) * sm[c] + tm[c], *am);
  const float cmag = sqrtf(fmaxf(re * re + im * im, FUSION_EPS));
  const float s = sigmoidf(m);
  yc[p * c2out + c] = re + s;
  yc[p * c2out + cout + c] = im + s;
  ym[p * cout + c] = m + sigmoidf(cmag);
}

}  // namespace

// xc (B, T, F, 2cin), xm (B, T, F, cin) -> yc (B, T, F/2, 2cout),
// ym (B, T, F/2, cout). Weights as documented in se_tpu_torch/ops/encoder.py.
extern "C" int se_encoder_level(const float* xc, const float* xm,
                                const float* wc, const float* bc,
                                const float* sc, const float* tc,
                                const float* ac, const float* wm,
                                const float* bm, const float* sm,
                                const float* tm, const float* am, float* yc,
                                float* ym, int B, int T, int F, int cin,
                                int cout, void* stream) {
  const size_t total = (size_t)B * T * (F / 2) * cout;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  encoder_level_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      xc, xm, wc, bc, sc, tc, ac, wm, bm, sm, tm, am, yc, ym, B, T, F, cin,
      cout);
  return (int)cudaGetLastError();
}
