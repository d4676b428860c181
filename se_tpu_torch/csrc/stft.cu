// Fused STFT: framing, window and a real FFT a frame in one kernel, fp32;
// on a bf16 waveform the TPU kernel's basis product.
//
// Replaces: se_tpu/ops/pallas_stft.py, `stft_pallas` and its body
// `_kernel` (a matmul-DFT there).
//
//   out[b, t, :] = [Re | Im] of DFT_n(w * xp[b, t * hop : t * hop + K]),
//
// the frame of K = frame_len samples zero-padded to n = n_fft, F = n/2 + 1
// bins, over the padded waveform xp, the waveform x (B, L) as
// ops/stft.py `pad_signal` pads it: `pad` samples reflected at each end
// (center; pad = 0 otherwise), then zeros. Neither xp nor the frames
// tensor is ever written: each frame is read straight from x, its padding
// applied at the load (`padded`).
//
// Bound on the H100: by bytes. A real FFT is ~2.5 n log2 n flops a frame
// on 4 (hop + 2F) bytes it must move (its new samples and its output row):
// ~4.5 flops a byte at 512/128, far under the fp32 ridge of ~20.
//
// Design. One warp a frame, up to four frames a block (enough blocks for
// 132 SMs at B = 4: 501 at 512/128, 251 at 512/256). An even n is taken as
// the N = n/2-point complex sequence z[m] = x[2m] + i x[2m+1] (the frame's
// own float layout), so the load is the windowed frame as it lies: 16-byte
// loads where hop, K, n, L and pad are multiples of 4 and the frame lies
// inside x, 4-byte loads through the padding map otherwise (the first and
// last frames of a center STFT);
// an odd n as the N = n-point complex sequence x[m] + 0i. Then a Stockham
// autosort FFT of N points in the warp's two shared buffers (ping-pong, 2 x
// N float2: 4 KB at n = 512), one radix stage at a time from the plan
// ops/stft_fused.py `radix_plan` gives (512 -> 4 4 4 4, 320 -> 4 4 2 5,
// 384 -> 4 4 4 3; a device array of radices): butterfly j of a stage with
// radix R after Ns points reads j + r N/R, multiplies by the twiddle
// exp(-2 pi i r (j mod Ns) / (Ns R)) and writes (j / Ns) Ns R + (j mod Ns)
// + r Ns. Radices 2, 4 and 5 run unrolled butterflies; any other (3, and
// whatever prime is left of N) runs `stage_any`, R products an output with
// the stage twiddle and the R-point DFT folded into one root of order Ns R.
// Then, for an even n, the real-split post-pass: X[k] = E[k] + W^k O[k]
// with E, O the even and odd halves recovered from Z[k] and conj(Z[N - k])
// and W = exp(-2 pi i / n), for k = 0 .. N; for an odd n, X[k] = Z[k] for
// k = 0 .. (n - 1) / 2. Written [re | im] coalesced. Twiddles come from a
// table built in float64 on the host and cast to fp32 (ops/stft_fused.py
// `twiddle_table`: each stage's (Ns, R - 1) block, or its Ns R roots for
// `stage_any`, then W^k); the kernel computes no sine or cosine. The
// radix-5 butterfly's constants are cos and sin of 2 pi / 5 and 4 pi / 5,
// rounded from decimals. Past n = 1536 four frames' buffers outgrow the
// default 48 KB: the entry opts into more shared memory and runs fewer
// frames a block where even that is short (one at n = 16384).

// bf16 (`stft_basis_bf16`, C entry `se_stft_basis_bf16`). On a bf16
// waveform `stft_pallas` rounds its window x DFT basis to bf16
// (pallas_stft.py:102), multiplies the bf16 slots by it with fp32
// accumulation (:61-62) and writes fp32 (:115). An FFT has no basis to
// round, so this variant computes that product itself:
//
//   out[b, t, c] = sum_l xp[b, t * hop + l] * basis[l, c],  l < K,
//
// basis (K, 2F) the window x [cos | -sin] basis rounded to bf16
// (ops/stft_fused.py `_bf16_basis`), the product of two bf16 values exact
// in fp32, the sums fp32 (in the tensor cores' order, not the twin's). A
// GEMM of M = B T frames, N = 2F, K
// = frame_len, on the tensor cores in bf16 (`mma.sync.m16n8k16`, fp32
// accumulate: the MXU's arithmetic in `stft_pallas`): a block of 4 warps
// owns a 64 x 64 output tile, K in stages of 32; the A stage copied from
// the waveform with cp.async, 16 bytes a copy, where a frame's samples lie
// inside it, through the padding map (`padded_index`) elsewhere, the B
// stage copied with cp.async from the basis given transposed and padded to
// a multiple of 32 in K (ops/stft_fused.py `_bf16_basis`), both read into
// the fragments with ldmatrix. Bound on the H100 by bytes at every preset
// (the fp32 spectrum: 4 B a column against 2 K flops, under the bf16
// ridge of ~295 flops a byte).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int FPB = 4;  // frames a block at most, one warp each

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// -i a
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

// In-place forward DFT of R points (sign -).
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]);

template <>
__device__ __forceinline__ void dft<2>(float2 (&v)[2]) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void dft<4>(float2 (&v)[4]) {
  const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const float2 t2 = cadd(v[1], v[3]), t3 = mul_mi(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[2] = csub(t0, t2);
  v[1] = cadd(t1, t3);
  v[3] = csub(t1, t3);
}

template <>
__device__ __forceinline__ void dft<5>(float2 (&v)[5]) {
  constexpr float C1 = 0.30901699437494745f;   // cos(2 pi / 5)
  constexpr float C2 = -0.8090169943749475f;   // cos(4 pi / 5)
  constexpr float S1 = 0.9510565162951535f;    // sin(2 pi / 5)
  constexpr float S2 = 0.5877852522924731f;    // sin(4 pi / 5)
  const float2 a0 = v[0];
  const float2 b1 = cadd(v[1], v[4]), b2 = cadd(v[2], v[3]);
  const float2 d1 = csub(v[1], v[4]), d2 = csub(v[2], v[3]);
  const float2 e1 = make_float2(a0.x + C1 * b1.x + C2 * b2.x,
                                a0.y + C1 * b1.y + C2 * b2.y);
  const float2 e2 = make_float2(a0.x + C2 * b1.x + C1 * b2.x,
                                a0.y + C2 * b1.y + C1 * b2.y);
  const float2 f1 = mul_mi(make_float2(S1 * d1.x + S2 * d2.x,
                                       S1 * d1.y + S2 * d2.y));
  const float2 f2 = mul_mi(make_float2(S2 * d1.x - S1 * d2.x,
                                       S2 * d1.y - S1 * d2.y));
  v[0] = cadd(a0, cadd(b1, b2));
  v[1] = cadd(e1, f1);
  v[4] = csub(e1, f1);
  v[2] = cadd(e2, f2);
  v[3] = csub(e2, f2);
}

// One Stockham stage of radix R over N points after Ns points: in -> out,
// the warp's lanes taking the N / R butterflies in turn. tw: this stage's
// (Ns, R - 1) twiddles.
template <int R>
__device__ __forceinline__ void stage(const float2* __restrict__ in,
                                      float2* __restrict__ out,
                                      const float2* __restrict__ tw, int N,
                                      int ns, int lane) {
  const int nb = N / R;
  for (int j = lane; j < nb; j += 32) {
    const int k = j % ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = in[j + r * nb];
    const float2* w = tw + k * (R - 1);
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(w + r - 1));
    dft<R>(v);
    const int d = (j / ns) * ns * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) out[d + r * ns] = v[r];
  }
}

// A Stockham stage of any radix R: output r of butterfly j is sum_q
// in[j + q N/R] w^(q (k + r Ns)), k = j mod Ns, w = exp(-2 pi i / (Ns R)):
// the twiddle w^(q k) times the R-point DFT's w^(q r Ns). tw: this
// stage's Ns R roots w^m. The lanes take the N (butterfly, output) pairs.
__device__ __forceinline__ void stage_any(const float2* __restrict__ in,
                                          float2* __restrict__ out,
                                          const float2* __restrict__ tw,
                                          int N, int ns, int R, int lane) {
  const int nb = N / R, L = ns * R;
  for (int e = lane; e < N; e += 32) {
    const int j = e % nb, r = e / nb, k = j % ns, step = k + r * ns;
    float2 acc = make_float2(0.f, 0.f);
    for (int q = 0, m = 0; q < R; ++q) {
      acc = cadd(acc, cmul(in[j + q * nb], __ldg(tw + m)));
      m += step;  // step < L: one subtraction keeps m mod L
      if (m >= L) m -= L;
    }
    out[(j / ns) * L + k + r * ns] = acc;
  }
}

// Sample j of the padded waveform from x's row of L samples: x[j - pad],
// reflected at the ends within `pad` samples of them (as torch's reflect
// padding), zero past that.
__device__ __forceinline__ long padded_index(long j, int pad, int L) {
  long i = j - pad;
  if (i < 0) i = -i;  // pad > 0: within the reflected head
  if (i >= L) {
    if (i >= (long)L + pad) return -1;
    i = 2L * (L - 1) - i;
  }
  return i;
}

__device__ __forceinline__ float padded(const float* __restrict__ row,
                                        long j, int pad, int L) {
  const long i = padded_index(j, pad, L);
  return i < 0 ? 0.f : __ldg(row + i);
}

template <bool V4>
__global__ void __launch_bounds__(FPB * 32)
stft_fft(const float* __restrict__ x, const float* __restrict__ win,
         const float2* __restrict__ tw, const int* __restrict__ radices,
         float* __restrict__ out, int B, int L, int pad, int T, int K, int n,
         int hop, int nst) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool split = n % 2 == 0;  // the real-split form: N = n / 2
  const int N = split ? n / 2 : n, bins = n / 2 + 1;
  float2* a = reinterpret_cast<float2*>(smem4) + (size_t)warp * 2 * N;
  float2* b2 = a + N;
  const long g = (long)blockIdx.x * (blockDim.x >> 5) + warp;  // its frame
  if (g >= (long)B * T) return;  // whole warps only: no block barrier below
  const long b = g / T, t = g % T;
  const float* row_x = x + b * L;
  const long s0 = t * hop - pad;  // the frame's first sample in x

  // the windowed frame, zeros past K: z[m] = w x[2m] + i w x[2m+1] (even
  // n), w x[m] + 0i (odd n)
  float* af = reinterpret_cast<float*>(a);
  if (V4 && s0 >= 0 && s0 + K <= L) {  // inside x: no padding to apply
    const float4* src = reinterpret_cast<const float4*>(row_x + s0);
    for (int c = lane; c < n / 4; c += 32) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * c < K) {
        const float4 xv = __ldg(src + c);
        const float4 w = __ldg(reinterpret_cast<const float4*>(win) + c);
        v = make_float4(xv.x * w.x, xv.y * w.y, xv.z * w.z, xv.w * w.w);
      }
      reinterpret_cast<float4*>(af)[c] = v;
    }
  } else if (split) {
    for (int l = lane; l < n; l += 32)
      af[l] = l < K ? padded(row_x, t * hop + l, pad, L) * __ldg(win + l)
                    : 0.f;
  } else {
    for (int l = lane; l < n; l += 32)
      a[l] = make_float2(
          l < K ? padded(row_x, t * hop + l, pad, L) * __ldg(win + l) : 0.f,
          0.f);
  }
  __syncwarp();

  float2* in = a;
  float2* to = b2;
  int ns = 1, off = 0;
  for (int s = 0; s < nst; ++s) {
    const int R = __ldg(radices + s);
    if (R == 4) {
      stage<4>(in, to, tw + off, N, ns, lane);
      off += ns * 3;
    } else if (R == 2) {
      stage<2>(in, to, tw + off, N, ns, lane);
      off += ns;
    } else if (R == 5) {
      stage<5>(in, to, tw + off, N, ns, lane);
      off += ns * 4;
    } else {
      stage_any(in, to, tw + off, N, ns, R, lane);
      off += ns * R;
    }
    __syncwarp();
    ns *= R;
    float2* tmp = in;
    in = to;
    to = tmp;
  }

  float* row = out + g * 2 * bins;
  if (!split) {  // X[k] = Z[k]
    for (int k = lane; k < bins; k += 32) {
      row[k] = in[k].x;
      row[bins + k] = in[k].y;
    }
    return;
  }
  // X[k] = E + W^k O, E = (Z[k] + conj Z[N-k]) / 2, O = -i (Z[k] - conj
  // Z[N-k]) / 2, indices mod N; row = [Re X[0..N] | Im X[0..N]]
  const float2* wk = tw + off;
  for (int k = lane; k <= N; k += 32) {
    const float2 z = in[k == N ? 0 : k];
    const float2 zc = in[k == 0 ? 0 : N - k];
    const float2 e = make_float2(0.5f * (z.x + zc.x), 0.5f * (z.y - zc.y));
    const float2 o = make_float2(0.5f * (z.y + zc.y), -0.5f * (z.x - zc.x));
    const float2 xk = cadd(e, cmul(__ldg(wk + k), o));
    row[k] = xk.x;
    row[N + 1 + k] = xk.y;
  }
}

constexpr int BM = 64, BN = 64, BK = 32, BT = 128;  // the bf16 product
constexpr int LDK = BK + 8;  // a tile row in bf16: 80 bytes, no conflicts

// out (B T, N2) fp32 = the frames of x (B, L) bf16 times the basis,
// given transposed, basis_t (N2, Kp) bf16 (Kp a multiple of BK, zero past
// K): a 64 x 64 tile a block, 2 x 2 warps of 32 x 32 (two m16 tiles by
// four n8), K in stages of BK, each stage two m16n8k16 steps. Each tile
// row's waveform offset and first sample are found once. V8: 8 samples (16
// bytes) a copy where they lie inside x (hop, L and pad multiples of 8, x
// 16-byte aligned), the padding map sample by sample elsewhere.
template <bool V8>
__global__ void __launch_bounds__(BT)
stft_basis_bf16(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ basis_t,
                float* __restrict__ out, int B, int L, int pad, int T,
                int K, int Kp, int hop, int N2) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][LDK];  // frames, k inner
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][LDK];  // basis_t rows
  __shared__ long row_x[BM], row_s[BM];  // b L and t hop; row_x -1: past M
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % 2, wn = warp / 2;
  const long M = (long)B * T, m0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  if (tid < BM) {
    const long g = m0 + tid;
    row_x[tid] = g < M ? g / T * L : -1;
    row_s[tid] = g < M ? g % T * hop : 0;
  }
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.f;
  // ldmatrix lane addresses: A rows lane % 16 at k (lane / 16) 8; B rows
  // (lane / 16) 8 + lane % 8 at k ((lane / 8) % 2) 8
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  const int b_row = (lane / 16) * 8 + lane % 8, b_k = ((lane / 8) % 2) * 8;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  __syncthreads();
  for (int k0 = 0; k0 < Kp; k0 += BK) {
    // B: BN basis rows of BK, 16 bytes a copy, zeros past N2
    for (int e = tid; e < BN * (BK / 8); e += BT) {
      const int nn = e / (BK / 8), c8 = e % (BK / 8);
      const bool ok = n0 + nn < N2;
      cp_async16(&Bs[nn][8 * c8],
                 basis_t + (size_t)(ok ? n0 + nn : 0) * Kp + k0 + 8 * c8,
                 ok ? 16 : 0);
    }
    cp_async_commit();
    // A: BM frames x BK samples, 8 a thread: one 16-byte copy inside x,
    // else each through the padding map (zeros past K)
    for (int e = tid; e < BM * (BK / 8); e += BT) {
      const int mm = e / (BK / 8), kk = 8 * (e % (BK / 8)), k = k0 + kk;
      const long j0 = row_s[mm] + k - pad;  // the first sample's index in x
      if (V8 && row_x[mm] >= 0 && k + 8 <= K && j0 >= 0 && j0 + 8 <= L) {
        cp_async16(&As[mm][kk], x + row_x[mm] + j0, 16);
        continue;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        __nv_bfloat16 v = zero;
        if (row_x[mm] >= 0 && k + q < K) {
          const long i = padded_index(row_s[mm] + k + q, pad, L);
          if (i >= 0) v = x[row_x[mm] + i];
        }
        As[mm][kk + q] = v;
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], &As[wm * 32 + mi * 16 + a_row][ks + a_k]);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r[4];
        ldsm_x4(r, &Bs[wn * 32 + j * 8 + b_row][ks + b_k]);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mi][j], a[mi], b[j]);
    }
    __syncthreads();
  }
  // acc[mi][j][hh * 2 + q]: row wm 32 + mi 16 + hh 8 + lane / 4, column
  // wn 32 + 8 j + 2 (lane % 4) + q; N2 even, so a column pair is whole
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long g = m0 + wm * 32 + mi * 16 + hh * 8 + lane / 4;
      if (g >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn * 32 + 8 * j + 2 * (lane % 4);
        if (c < N2)
          *reinterpret_cast<float2*>(out + g * N2 + c) =
              make_float2(acc[mi][j][hh * 2], acc[mi][j][hh * 2 + 1]);
      }
    }
}

}  // namespace

// x (B, L) the waveform; pad: the samples reflected at each end (center),
// 0 for zeros only, pad < L; frame t starts at sample t * hop of the
// padded waveform; win (K,) the window; tw the table of ops/stft_fused.py
// `twiddle_table` (float2); radices (nst,) int32 on the device, the plan
// of `radix_plan`: the radices of the N-point FFT (N = n / 2 for an even
// n, n for an odd one), their product N; out (B, T, 2 (n / 2 + 1)).
extern "C" int se_stft_fwd(const float* x, const float* win, const float* tw,
                           const int* radices, float* out, int B, int L,
                           int pad, int T, int K, int n, int hop, int nst,
                           void* stream) {
  if (n < 1 || K > n || K < 1 || nst < 0 || pad < 0 || (pad > 0 && pad >= L))
    return (int)cudaErrorInvalidValue;
  const long frames = (long)B * T;
  if (frames == 0) return 0;
  const int N = n % 2 == 0 ? n / 2 : n;
  const size_t per_frame = (size_t)2 * N * sizeof(float2);
  int fpb = FPB;
  cudaStream_t st = (cudaStream_t)stream;
  const bool v4 = hop % 4 == 0 && K % 4 == 0 && L % 4 == 0 &&
                  pad % 4 == 0 && n % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(win) % 16 == 0;
  auto kernel = v4 ? stft_fft<true> : stft_fft<false>;
  if (FPB * per_frame > 48 * 1024) {  // past the default: opt in
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    fpb = (int)((size_t)optin / per_frame);
    if (fpb < 1) return (int)cudaErrorInvalidValue;
    if (fpb > FPB) fpb = FPB;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(fpb * per_frame));
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((frames + fpb - 1) / fpb);
  kernel<<<blocks, fpb * 32, fpb * per_frame, st>>>(
      x, win, reinterpret_cast<const float2*>(tw), radices, out, B, L, pad,
      T, K, n, hop, nst);
  return (int)cudaGetLastError();
}

// The bf16 variant: x (B, L) bf16, padding and frames as se_stft_fwd's
// (pad < L), basis_t (N2, Kp) bf16 the window x DFT basis transposed, zero
// past K (ops/stft_fused.py `_bf16_basis`; Kp a multiple of 32, 16-byte
// aligned), out (B, T, N2) fp32, N2 = 2 (n / 2 + 1).
extern "C" int se_stft_basis_bf16(const __nv_bfloat16* x,
                                  const __nv_bfloat16* basis_t, float* out,
                                  int B, int L, int pad, int T, int K,
                                  int Kp, int hop, int N2, void* stream) {
  if (K < 1 || Kp < K || Kp % BK != 0 || N2 < 2 || N2 % 2 != 0 ||
      hop < 1 || pad < 0 || (pad > 0 && pad >= L) ||
      reinterpret_cast<uintptr_t>(basis_t) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long frames = (long)B * T;
  if (frames == 0) return 0;
  const dim3 grid((unsigned)((frames + BM - 1) / BM),
                  (unsigned)((N2 + BN - 1) / BN));
  const bool v8 = hop % 8 == 0 && L % 8 == 0 && pad % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kernel = v8 ? stft_basis_bf16<true> : stft_basis_bf16<false>;
  kernel<<<grid, BT, 0, (cudaStream_t)stream>>>(x, basis_t, out, B, L, pad,
                                                T, K, Kp, hop, N2);
  return (int)cudaGetLastError();
}
