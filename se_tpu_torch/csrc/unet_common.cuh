// The U-net levels' shared epilogue (csrc/encoder.cu, csrc/decoder.cu):
// bias -> (BN affine -> PReLU) for the complex sums r, i and the real sum g
// of one (output position, channel), then Uformer's `fusion`:
//   yc = [r + s | i + s], ym = g + sigmoid(sqrt(max(r^2 + i^2, eps))),
//   s = sigmoid(g).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tc_common.cuh"

namespace {

constexpr float FUSION_EPS = 1.1920929e-07f;  // np.finfo(np.float32).eps

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float prelu(float x, float a) {
  return x >= 0.f ? x : a * x;
}

// The per-channel vectors of a level: complex bias, BN scale, BN shift
// (2 Cout each: re then im) and PReLU alpha (1), the same for the real
// branch (Cout).
struct Tail {
  const float *bc, *sc, *tc, *ac, *bm, *sm, *tm, *am;
};

// Output position o, channel c: the epilogue on the sums r, i (complex)
// and g (real), in fp32, written to yc (., 2 cout) and ym (., cout) of
// fp32 or bf16 storage T (rounded once, to nearest even).
template <class T>
__device__ __forceinline__ void level_out(const Tail& P, float r, float i,
                                          float g, size_t o, int c,
                                          int cout, bool has_bn,
                                          T* __restrict__ yc,
                                          T* __restrict__ ym) {
  r += P.bc[c];
  i += P.bc[cout + c];
  g += P.bm[c];
  if (has_bn) {
    const float a_c = *P.ac, a_m = *P.am;
    r = prelu(r * P.sc[c] + P.tc[c], a_c);
    i = prelu(i * P.sc[cout + c] + P.tc[cout + c], a_c);
    g = prelu(g * P.sm[c] + P.tm[c], a_m);
  }
  const float cmag = sqrtf(fmaxf(r * r + i * i, FUSION_EPS));
  const float s = sigmoidf(g);
  put(yc + o * 2 * cout + c, r + s);
  put(yc + o * 2 * cout + cout + c, i + s);
  put(ym + o * cout + c, g + sigmoidf(cmag));
}

}  // namespace
