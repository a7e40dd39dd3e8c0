// triad_data — native host-side data ops for the triad input pipeline.
//
// The reference delegates its native-performance data work to external
// libraries (libavcodec via torchcodec/torchaudio, cuDNN via torch —
// SURVEY §2 "external dependency surface"). This library is the
// framework-owned equivalent for the decode-adjacent hot loops that sit
// between media bytes and fixed-shape device batches:
//
//   * kaiser-windowed-sinc polyphase resampling to 16 kHz (the quality
//     class of torchaudio's Resample, reference dataset.py:83-85)
//   * per-row zero-mean/unit-var waveform normalization (the HF
//     processor step, reference model.py:56-62) fused with padding to
//     the static length
//   * uint8 -> float32 bilinear resize fused with ImageNet
//     normalization (reference dataset.py:96-133)
//
// Exposed as a plain C ABI consumed via ctypes
// (triad/data/native.py); OpenMP-free, thread-safe, no global state
// — the Python thread pool provides the parallelism.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Resampling: kaiser-windowed sinc, polyphase evaluation.
// ---------------------------------------------------------------------------

static double bessel_i0(double x) {
  // Series expansion; converges quickly for the beta range used here.
  double sum = 1.0, term = 1.0;
  const double half_x = x / 2.0;
  for (int k = 1; k < 64; ++k) {
    term *= (half_x / k) * (half_x / k);
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

// out must hold resample_output_length(n_in, sr_in, sr_out) floats.
int64_t resample_output_length(int64_t n_in, int32_t sr_in, int32_t sr_out) {
  return (n_in * static_cast<int64_t>(sr_out) + sr_in - 1) / sr_in;
}

// Polyphase kaiser-sinc resampler (zero-phase, lowpass at the tighter
// Nyquist). width = taps per side at the *lower* rate.
void resample_kaiser(const float* in, int64_t n_in, int32_t sr_in,
                     float* out, int64_t n_out, int32_t sr_out,
                     int32_t width, double beta) {
  if (sr_in == sr_out) {
    std::memcpy(out, in, sizeof(float) * std::min(n_in, n_out));
    for (int64_t i = n_in; i < n_out; ++i) out[i] = 0.f;
    return;
  }
  const double ratio = static_cast<double>(sr_out) / sr_in;
  const double cutoff = (ratio < 1.0 ? ratio : 1.0) * 0.97;  // anti-alias
  const double i0_beta = bessel_i0(beta);
  // taps per side in input samples
  const double taps = width / (ratio < 1.0 ? ratio : 1.0);

  for (int64_t j = 0; j < n_out; ++j) {
    const double t_in = j / ratio;  // position in input samples
    const int64_t lo = static_cast<int64_t>(std::ceil(t_in - taps));
    const int64_t hi = static_cast<int64_t>(std::floor(t_in + taps));
    double acc = 0.0, wsum = 0.0;
    for (int64_t i = lo; i <= hi; ++i) {
      const double dt = (i - t_in);
      const double x = dt * cutoff;
      double sinc = (std::abs(x) < 1e-12)
                        ? 1.0
                        : std::sin(M_PI * x) / (M_PI * x);
      const double frac = dt / taps;
      if (frac <= -1.0 || frac >= 1.0) continue;
      const double win =
          bessel_i0(beta * std::sqrt(1.0 - frac * frac)) / i0_beta;
      // Gain factors cancel in the acc/wsum normalization below.
      const double w = sinc * win;
      wsum += w;
      if (i >= 0 && i < n_in) acc += w * in[i];
    }
    out[j] = (wsum > 0.0) ? static_cast<float>(acc / wsum) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Waveform normalize + pad (HF processor quirk, model.py:56-62):
// stats over the full padded row, eps 1e-7.
// ---------------------------------------------------------------------------

void normalize_pad_waveform(const float* in, int64_t n_in, float* out,
                            int64_t n_out) {
  const int64_t n_copy = std::min(n_in, n_out);
  double sum = 0.0;
  for (int64_t i = 0; i < n_copy; ++i) sum += in[i];
  // padded zeros contribute 0 to the sum but count in the denominator
  const double mean = sum / static_cast<double>(n_out);
  double var = 0.0;
  for (int64_t i = 0; i < n_copy; ++i) {
    const double d = in[i] - mean;
    var += d * d;
  }
  var += (n_out - n_copy) * mean * mean;  // zeros' deviation
  var /= static_cast<double>(n_out);
  const double inv = 1.0 / std::sqrt(var + 1e-7);
  for (int64_t i = 0; i < n_copy; ++i)
    out[i] = static_cast<float>((in[i] - mean) * inv);
  const float pad_val = static_cast<float>((0.0 - mean) * inv);
  for (int64_t i = n_copy; i < n_out; ++i) out[i] = pad_val;
}

// ---------------------------------------------------------------------------
// Image: uint8 HWC -> float32 HWC bilinear resize + ImageNet normalize
// (half-pixel centers, matching cv2/torch interpolate align_corners=False).
// ---------------------------------------------------------------------------

void resize_normalize_u8(const uint8_t* in, int32_t h, int32_t w,
                         float* out, int32_t size, int32_t normalize) {
  static const float kMean[3] = {0.485f, 0.456f, 0.406f};
  static const float kStd[3] = {0.229f, 0.224f, 0.225f};
  for (int32_t oy = 0; oy < size; ++oy) {
    const float fy = (oy + 0.5f) * h / size - 0.5f;
    int32_t y0 = static_cast<int32_t>(std::floor(fy));
    float wy = fy - y0;
    if (y0 < 0) { y0 = 0; wy = 0.f; }
    int32_t y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    for (int32_t ox = 0; ox < size; ++ox) {
      const float fx = (ox + 0.5f) * w / size - 0.5f;
      int32_t x0 = static_cast<int32_t>(std::floor(fx));
      float wx = fx - x0;
      if (x0 < 0) { x0 = 0; wx = 0.f; }
      int32_t x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      for (int32_t c = 0; c < 3; ++c) {
        const float tl = in[(y0 * w + x0) * 3 + c];
        const float tr = in[(y0 * w + x1) * 3 + c];
        const float bl = in[(y1 * w + x0) * 3 + c];
        const float br = in[(y1 * w + x1) * 3 + c];
        float v = (tl * (1 - wx) + tr * wx) * (1 - wy) +
                  (bl * (1 - wx) + br * wx) * wy;
        v *= (1.0f / 255.0f);
        if (normalize) v = (v - kMean[c]) / kStd[c];
        out[(oy * size + ox) * 3 + c] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// WAV demux + decode (the framework-owned audio ingest path; the
// reference leans on torchaudio/libavcodec for this, dataset.py:83-85).
// RIFF/WAVE with PCM 16/24/32-bit and IEEE float32, including
// WAVE_FORMAT_EXTENSIBLE. Returns mono float32 in [-1, 1] (channel 0,
// matching the reference's channel selection, dataset.py:86).
// ---------------------------------------------------------------------------

namespace {

struct WavFmt {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float, 0xFFFE = extensible
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
};

inline uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}
inline uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

// Finds fmt + data chunks. Returns 0 on success.
int parse_wav(const uint8_t* data, int64_t n, WavFmt* fmt,
              const uint8_t** pcm, int64_t* pcm_bytes) {
  if (n < 12 || std::memcmp(data, "RIFF", 4) != 0 ||
      std::memcmp(data + 8, "WAVE", 4) != 0)
    return -1;
  int64_t off = 12;
  bool have_fmt = false;
  *pcm = nullptr;
  while (off + 8 <= n) {
    const uint8_t* hdr = data + off;
    const uint32_t size = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (off + 8 + size > n && std::memcmp(hdr, "data", 4) != 0) return -2;
    if (std::memcmp(hdr, "fmt ", 4) == 0) {
      if (size < 16) return -3;
      fmt->format = rd_u16(body);
      fmt->channels = rd_u16(body + 2);
      fmt->sample_rate = rd_u32(body + 4);
      fmt->bits = rd_u16(body + 14);
      if (fmt->format == 0xFFFE && size >= 40) {
        // extensible: the real format lives in the GUID's first bytes
        fmt->format = rd_u16(body + 24);
      }
      have_fmt = true;
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      *pcm = body;
      // tolerate truncated final chunk (stream rips)
      *pcm_bytes = std::min<int64_t>(size, n - (off + 8));
    }
    off += 8 + size + (size & 1);  // chunks are word-aligned
  }
  if (!have_fmt || *pcm == nullptr) return -4;
  if (fmt->channels == 0 || fmt->sample_rate == 0) return -5;
  const bool pcm_ok =
      fmt->format == 1 && (fmt->bits == 16 || fmt->bits == 24 || fmt->bits == 32);
  const bool f32_ok = fmt->format == 3 && fmt->bits == 32;
  return (pcm_ok || f32_ok) ? 0 : -6;
}

}  // namespace

// Returns 0 and fills (sample_rate, channels, n_frames) on success;
// negative error code otherwise.
int32_t wav_info(const uint8_t* data, int64_t n_bytes, int32_t* sample_rate,
                 int32_t* channels, int64_t* n_frames) {
  WavFmt fmt;
  const uint8_t* pcm;
  int64_t pcm_bytes;
  const int rc = parse_wav(data, n_bytes, &fmt, &pcm, &pcm_bytes);
  if (rc != 0) return rc;
  const int64_t frame_bytes =
      static_cast<int64_t>(fmt.channels) * (fmt.bits / 8);
  *sample_rate = static_cast<int32_t>(fmt.sample_rate);
  *channels = fmt.channels;
  *n_frames = pcm_bytes / frame_bytes;
  return 0;
}

// Decodes up to max_frames of one channel as float32 in [-1, 1].
// Returns frames written, or a negative error code.
int64_t wav_decode_channel(const uint8_t* data, int64_t n_bytes, float* out,
                           int64_t max_frames, int32_t channel) {
  WavFmt fmt;
  const uint8_t* pcm;
  int64_t pcm_bytes;
  const int rc = parse_wav(data, n_bytes, &fmt, &pcm, &pcm_bytes);
  if (rc != 0) return rc;
  if (channel < 0 || channel >= fmt.channels) return -7;
  const int bytes_per = fmt.bits / 8;
  const int64_t frame_bytes = static_cast<int64_t>(fmt.channels) * bytes_per;
  const int64_t frames = std::min(pcm_bytes / frame_bytes, max_frames);
  const uint8_t* p = pcm + channel * bytes_per;
  if (fmt.format == 3) {  // float32
    for (int64_t i = 0; i < frames; ++i, p += frame_bytes) {
      float v;
      std::memcpy(&v, p, 4);
      out[i] = v;
    }
  } else if (fmt.bits == 16) {
    for (int64_t i = 0; i < frames; ++i, p += frame_bytes) {
      const int16_t v = static_cast<int16_t>(rd_u16(p));
      out[i] = static_cast<float>(v) * (1.0f / 32768.0f);
    }
  } else if (fmt.bits == 24) {
    for (int64_t i = 0; i < frames; ++i, p += frame_bytes) {
      int32_t v = (static_cast<int32_t>(p[0]) << 8) |
                  (static_cast<int32_t>(p[1]) << 16) |
                  (static_cast<int32_t>(p[2]) << 24);
      v >>= 8;  // sign-extend from 24 bits
      out[i] = static_cast<float>(v) * (1.0f / 8388608.0f);
    }
  } else {  // PCM 32
    for (int64_t i = 0; i < frames; ++i, p += frame_bytes) {
      const int32_t v = static_cast<int32_t>(rd_u32(p));
      out[i] = static_cast<float>(v) * (1.0f / 2147483648.0f);
    }
  }
  return frames;
}

}  // extern "C"
