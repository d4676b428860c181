// Native WAV decode, RMS gain and polyphase resampling for the data
// loader's host path: a copy of se_tpu/runtime/wavio.cc.
//
// The reference's data pipeline decodes wavs in Python per utterance
// (Uformer/data.py:123-150). This C library does the RIFF parse, PCM->float
// conversion, RMS gain and resampling in C++; se_tpu_torch/runtime/native.py
// builds it with g++ at first use and binds it with ctypes, and
// se_tpu_torch/data/wav.py uses it when built (pure Python otherwise).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <cmath>

extern "C" {

// Parse a RIFF/WAVE buffer; convert to float32 in [-1, 1).
// Returns number of samples written to `out` (mono: first channel), or -1.
// `out_capacity` is in samples; `sr_out` receives the sample rate.
int64_t wav_decode(const uint8_t* data, int64_t size, float* out,
                   int64_t out_capacity, int32_t* sr_out) {
  if (size < 12 || memcmp(data, "RIFF", 4) != 0 ||
      memcmp(data + 8, "WAVE", 4) != 0) {
    return -1;
  }
  int64_t pos = 12;
  uint16_t audio_format = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* raw = nullptr;
  int64_t raw_size = 0;
  while (pos + 8 <= size) {
    const uint8_t* id = data + pos;
    uint32_t chunk = 0;
    memcpy(&chunk, data + pos + 4, 4);
    const uint8_t* body = data + pos + 8;
    if (pos + 8 + chunk > size) break;
    if (memcmp(id, "fmt ", 4) == 0 && chunk >= 16) {
      memcpy(&audio_format, body, 2);
      memcpy(&channels, body + 2, 2);
      memcpy(&sr, body + 4, 4);
      memcpy(&bits, body + 14, 2);
      if (audio_format == 0xFFFE) audio_format = (bits == 32 ? 1 : 1);
    } else if (memcmp(id, "data", 4) == 0) {
      raw = body;
      raw_size = chunk;
    }
    pos += 8 + chunk + (chunk & 1);
  }
  if (raw == nullptr || channels == 0) return -1;
  *sr_out = static_cast<int32_t>(sr);

  int64_t n_total;
  if (audio_format == 1 && bits == 16) {
    n_total = raw_size / 2;
  } else if (audio_format == 1 && bits == 24) {
    n_total = raw_size / 3;
  } else if (audio_format == 1 && bits == 32) {
    n_total = raw_size / 4;
  } else if (audio_format == 3 && bits == 32) {
    n_total = raw_size / 4;
  } else {
    return -1;
  }
  int64_t n_frames = n_total / channels;
  if (n_frames > out_capacity) n_frames = out_capacity;

  if (audio_format == 1 && bits == 16) {
    const int16_t* p = reinterpret_cast<const int16_t*>(raw);
    for (int64_t i = 0; i < n_frames; ++i)
      out[i] = static_cast<float>(p[i * channels]) / 32768.0f;
  } else if (audio_format == 1 && bits == 24) {
    for (int64_t i = 0; i < n_frames; ++i) {
      const uint8_t* b = raw + 3 * i * channels;
      int32_t v = b[0] | (b[1] << 8) | (b[2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      out[i] = static_cast<float>(v) / 8388608.0f;
    }
  } else if (audio_format == 1 && bits == 32) {
    const int32_t* p = reinterpret_cast<const int32_t*>(raw);
    for (int64_t i = 0; i < n_frames; ++i)
      out[i] = static_cast<float>(p[i * channels]) / 2147483648.0f;
  } else {  // float32
    const float* p = reinterpret_cast<const float*>(raw);
    for (int64_t i = 0; i < n_frames; ++i) out[i] = p[i * channels];
  }
  return n_frames;
}

// RMS gain c = sqrt(n / sum(x^2)) (ref Uformer/data.py:136).
float rms_gain(const float* x, int64_t n) {
  double e = 0.0;
  for (int64_t i = 0; i < n; ++i) e += static_cast<double>(x[i]) * x[i];
  if (e < 1e-12) e = 1e-12;
  return static_cast<float>(sqrt(static_cast<double>(n) / e));
}

// Scale in place.
void scale(float* x, int64_t n, float c) {
  for (int64_t i = 0; i < n; ++i) x[i] *= c;
}

// Copy a crop of `len` samples starting at `start` into dst (zero-padded).
void crop_pad(const float* x, int64_t n, int64_t start, float* dst,
              int64_t len) {
  for (int64_t i = 0; i < len; ++i) {
    int64_t j = start + i;
    dst[i] = (j < n) ? x[j] : 0.0f;
  }
}

// ------------------------------------------------------------- resampling
// Polyphase resampler matching scipy.signal.resample_poly(x, up, down)
// (the python fallback in data/wav.py): windowed-sinc FIR designed
// like firwin(2*10*max(up,down)+1, 1/max(up,down), ('kaiser', 5.0)),
// DC-normalized, scaled by `up`, applied centered with zero edge padding.
// The reference resamples per utterance in its decode loops
// (LSTM/lstm_decode_vb.py:34) — this keeps that hot path native.

static double bessel_i0(double x) {
  double s = 1.0, t = 1.0;
  const double q = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    t *= q / (static_cast<double>(k) * k);
    s += t;
    if (t < 1e-18 * s) break;
  }
  return s;
}

int64_t resample_poly(const float* x, int64_t n, int32_t up, int32_t down,
                      float* out, int64_t out_cap) {
  if (up <= 0 || down <= 0 || n <= 0) return -1;
  if (up == down) {
    int64_t m = n < out_cap ? n : out_cap;
    memcpy(out, x, m * sizeof(float));
    return m;
  }
  const int64_t max_ud = up > down ? up : down;
  const int64_t half = 10 * max_ud;
  const int64_t ntaps = 2 * half + 1;
  double* h = static_cast<double*>(malloc(ntaps * sizeof(double)));
  if (h == nullptr) return -1;
  const double fc = 1.0 / static_cast<double>(max_ud);
  const double beta = 5.0;
  const double denom = bessel_i0(beta);
  double dc = 0.0;
  for (int64_t k = 0; k < ntaps; ++k) {
    const double m = static_cast<double>(k - half);
    const double sinc = (k == half) ? fc : sin(M_PI * fc * m) / (M_PI * m);
    const double r = static_cast<double>(k) / (ntaps - 1) * 2.0 - 1.0;
    const double w = bessel_i0(beta * sqrt(1.0 - r * r > 0 ? 1.0 - r * r : 0.0)) / denom;
    h[k] = sinc * w;
    dc += h[k];
  }
  const double g = static_cast<double>(up) / dc;
  for (int64_t k = 0; k < ntaps; ++k) h[k] *= g;

  int64_t n_out = (n * up + down - 1) / down;
  if (n_out > out_cap) n_out = out_cap;
  for (int64_t j = 0; j < n_out; ++j) {
    const int64_t t = j * down + half;  // center-aligned in upsampled time
    // contributions x[i] with tap k = t - i*up in [0, ntaps)
    int64_t i_lo = (t - (ntaps - 1) + up - 1) / up;
    if (t - (ntaps - 1) <= 0) i_lo = 0;
    if (i_lo < 0) i_lo = 0;
    int64_t i_hi = t / up;
    if (i_hi > n - 1) i_hi = n - 1;
    double acc = 0.0;
    for (int64_t i = i_lo; i <= i_hi; ++i) {
      acc += h[t - i * up] * static_cast<double>(x[i]);
    }
    out[j] = static_cast<float>(acc);
  }
  free(h);
  return n_out;
}

}  // extern "C"
