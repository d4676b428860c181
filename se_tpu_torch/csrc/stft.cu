// Fused STFT: framing, window and DFT in one kernel, fp32.
//
// Replaces: se_tpu/ops/pallas_stft.py, `stft_pallas` and its body `_kernel`.
//
//   out[b, t, n] = sum_l xp[b, t * hop + l] * basis[l, n]
//
// over the padded waveform xp (B, Lp) and the windowed real-DFT basis
// (K = frame_len, N = 2F): cos columns [0, F), -sin columns [F, 2F). The
// (B, T, K) frames matrix is a view with row stride `hop` over xp and is
// never written anywhere: a block stages the waveform span of its TT frames
// once in shared memory, (TT - 1) * hop + K floats (34 KB for 512/128),
// which is what the TPU kernel's "tile + k - 1 hop slots" in VMEM does.
//
// Bound on the H100: by bytes. The function needs only an FFT a frame,
// ~2.5 n_fft log2(n_fft) flops, on 4 (hop + N) bytes it must move (its new
// waveform samples and its output row): ~4.5 flops a byte at 512/128, under
// the fp32 ridge of ~20. This kernel does the matmul-DFT's 2 K N flops a
// frame instead, ~45x the FFT's at 512, so it sits far above that bound.
//
// Design. A block owns TT = 64 frames x TN = 128 output columns of one
// utterance, 256 threads as 8 warps x 32 lanes. Warp w owns frames w + 8 i
// (i < 8), lane l owns columns l + 32 j (j < 4): 32 sums a thread. Lanes
// vary the column, never the frame, so a frame read is one shared-memory
// broadcast to the whole warp. That matters because every hop in use (128,
// 160, 256) is a multiple of 32 floats: frames t and t + 1 start on the
// same bank, and lanes that varied t would serialize 32 ways. With hop and
// K multiples of 4 a thread reads 4 consecutive samples of a frame as one
// float4. Basis columns are streamed in K chunks of KC rows through shared
// memory (conflict-free: lanes read consecutive columns). Every product is
// an fp32 FMA; the sum over l runs in order.

#include <cuda_runtime.h>

namespace {

constexpr int TT = 64;         // frames a block
constexpr int TN = 128;        // output columns a block
constexpr int KC = 32;         // basis rows staged a step
constexpr int NW = 8;          // warps a block
constexpr int RM = TT / NW;    // frames a thread
constexpr int CN = TN / 32;    // columns a lane

// Floats of the staged strip: the tile's frames plus the rounding of the
// last frame up to a whole K chunk (zeros, met only by zero basis rows).
__host__ __device__ inline int strip_len(int hop, int K) {
  return (TT - 1) * hop + ((K + KC - 1) / KC) * KC;
}

template <bool V4>
__global__ void __launch_bounds__(NW * 32)
stft_kernel(const float* __restrict__ xp, const float* __restrict__ basis,
            float* __restrict__ out, int Lp, int T, int K, int N, int hop) {
  extern __shared__ float4 smem4[];
  float* strip = reinterpret_cast<float*>(smem4);
  const int slen = strip_len(hop, K);
  float* bs = strip + ((slen + 3) & ~3);  // KC x TN basis chunk
  const int b = blockIdx.z, t0 = blockIdx.y * TT, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int rows = min(TT, T - t0);

  // the waveform span of this block's frames, zeros past it
  const int span = (rows - 1) * hop + K;
  const float* src = xp + (size_t)b * Lp + (size_t)t0 * hop;
  for (int e = tid; e < slen; e += NW * 32) strip[e] = e < span ? src[e] : 0.f;

  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // the strip is complete; the last chunk is consumed
    for (int e = tid; e < KC * TN; e += NW * 32) {
      const int kk = k0 + e / TN, n = n0 + e % TN;
      bs[e] = (kk < K && n < N) ? basis[(size_t)kk * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float a[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float* p = strip + (w + NW * i) * hop + k0 + kk;
        if (V4) {
          const float4 v = *reinterpret_cast<const float4*>(p);
          a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) a[i][q] = p[q];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[CN];
#pragma unroll
        for (int j = 0; j < CN; ++j) bv[j] = bs[(kk + q) * TN + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i][q], bv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = w + NW * i;
    if (r >= rows) continue;
    float* dst = out + ((size_t)b * T + t0 + r) * N + n0;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int c = lane + 32 * j;
      if (n0 + c < N) dst[c] = acc[i][j];
    }
  }
}

template <bool V4>
int launch(const float* xp, const float* basis, float* out, int B, int Lp,
           int T, int K, int N, int hop, cudaStream_t st) {
  const int slen = strip_len(hop, K);
  const size_t smem = (((size_t)slen + 3) / 4 * 4 + (size_t)KC * TN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stft_kernel<V4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TN - 1) / TN, (T + TT - 1) / TT, B);
  stft_kernel<V4><<<grid, NW * 32, smem, st>>>(xp, basis, out, Lp, T, K, N, hop);
  return (int)cudaGetLastError();
}

}  // namespace

// xp (B, Lp) the padded waveform, Lp >= (T - 1) * hop + K; basis (K, N);
// out (B, T, N).
extern "C" int se_stft_fwd(const float* xp, const float* basis, float* out,
                           int B, int Lp, int T, int K, int N, int hop,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (hop % 4 == 0 && K % 4 == 0)
    return launch<true>(xp, basis, out, B, Lp, T, K, N, hop, st);
  return launch<false>(xp, basis, out, B, Lp, T, K, N, hop, st);
}
