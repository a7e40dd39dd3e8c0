// avdecode.cc — compressed-codec decode for the triad input
// pipeline, linking the system libavcodec directly.
//
// The reference consumes libavcodec through torchcodec (video frames,
// reference dataset.py:91-95) and torchaudio (audio, dataset.py:80-89).
// Neither wrapper exists in this environment; this is the
// framework-owned equivalent: the native MP4 demuxer (mp4.cc) provides
// per-sample byte ranges + decoder-config blobs, and these entry points
// feed them to libavcodec — AAC audio -> mono float32, H.264/MPEG-4
// video -> one RGB frame. One FFI call per file (packet tables are
// passed as arrays), no intermediate container parsing by ffmpeg.
//
// Plain C ABI via ctypes (triad/data/native.py); the library is
// built WITHOUT these entry points when libavcodec headers are absent
// (Makefile probes; python falls back to cv2/ffmpeg-binary paths).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavutil/opt.h>
}

namespace {

// -- esds descriptor walk ---------------------------------------------------
// The demuxer stores the raw esds payload (ES_Descriptor chain). The
// AAC decoder wants the DecoderSpecificInfo (tag 0x05) bytes =
// AudioSpecificConfig.

int64_t read_desc_len(const uint8_t*& p, const uint8_t* end) {
  int64_t len = 0;
  for (int i = 0; i < 4 && p < end; ++i) {
    uint8_t b = *p++;
    len = (len << 7) | (b & 0x7F);
    if (!(b & 0x80)) break;
  }
  return len;
}

// Finds tag 0x05 inside an esds payload (skips the 4-byte
// version/flags if present — the demuxer strips box headers but esds
// is a FullBox, so the payload may start with them).
bool find_audio_specific_config(const uint8_t* data, int64_t n,
                                const uint8_t** asc, int64_t* asc_len) {
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  if (n > 4 && p[0] == 0) p += 4;  // FullBox version/flags
  while (p < end) {
    uint8_t tag = *p++;
    int64_t len = read_desc_len(p, end);
    if (p + len > end) len = end - p;
    const uint8_t* body_end = p + len;
    if (tag == 0x03) {  // ES_Descriptor: ES_ID(2) + flags(1) [+ deps]
      if (body_end - p < 3) return false;
      uint8_t flags = p[2];
      p += 3;
      if (flags & 0x80) p += 2;              // dependsOn_ES_ID
      if (flags & 0x40 && p < body_end) p += 1 + *p;  // URL
      if (flags & 0x20) p += 2;              // OCR_ES_ID
      continue;  // descend into children
    }
    if (tag == 0x04) {  // DecoderConfigDescriptor: 13 fixed bytes
      p += 13;
      continue;  // descend (DecSpecificInfo follows)
    }
    if (tag == 0x05) {
      *asc = p;
      *asc_len = len;
      return true;
    }
    p = body_end;  // skip unknown descriptor
  }
  return false;
}

struct Decoder {
  AVCodecContext* ctx = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;

  ~Decoder() {
    if (ctx) avcodec_free_context(&ctx);
    if (pkt) av_packet_free(&pkt);
    if (frame) av_frame_free(&frame);
  }

  bool open(AVCodecID id, const uint8_t* extradata, int64_t n) {
    const AVCodec* codec = avcodec_find_decoder(id);
    if (!codec) return false;
    ctx = avcodec_alloc_context3(codec);
    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    if (!ctx || !pkt || !frame) return false;
    if (extradata && n > 0) {
      ctx->extradata = static_cast<uint8_t*>(
          av_mallocz(n + AV_INPUT_BUFFER_PADDING_SIZE));
      std::memcpy(ctx->extradata, extradata, n);
      ctx->extradata_size = static_cast<int>(n);
    }
    return avcodec_open2(ctx, codec, nullptr) >= 0;
  }

  int send(const uint8_t* data, int64_t size) {
    // libavcodec requires padded, av_malloc'd packet buffers.
    uint8_t* buf = static_cast<uint8_t*>(
        av_malloc(size + AV_INPUT_BUFFER_PADDING_SIZE));
    if (!buf) return AVERROR(ENOMEM);
    std::memcpy(buf, data, size);
    std::memset(buf + size, 0, AV_INPUT_BUFFER_PADDING_SIZE);
    av_packet_unref(pkt);
    if (av_packet_from_data(pkt, buf, static_cast<int>(size)) < 0) {
      av_free(buf);
      return AVERROR(ENOMEM);
    }
    return avcodec_send_packet(ctx, pkt);
  }
};

// Appends one decoded audio frame's channel (or downmix source
// channel 0 when `channel` exceeds the count) to `out`.
int64_t emit_audio(const AVFrame* f, int32_t channel, float* out,
                   int64_t written, int64_t max_frames) {
  int ch = channel < f->ch_layout.nb_channels ? channel : 0;
  int n = f->nb_samples;
  if (written + n > max_frames) n = static_cast<int>(max_frames - written);
  if (n <= 0) return written;
  if (f->format == AV_SAMPLE_FMT_FLTP) {
    std::memcpy(out + written, f->extended_data[ch], n * sizeof(float));
  } else if (f->format == AV_SAMPLE_FMT_FLT) {
    const float* src = reinterpret_cast<const float*>(f->extended_data[0]);
    for (int i = 0; i < n; ++i)
      out[written + i] = src[i * f->ch_layout.nb_channels + ch];
  } else if (f->format == AV_SAMPLE_FMT_S16P) {
    const int16_t* src = reinterpret_cast<const int16_t*>(f->extended_data[ch]);
    for (int i = 0; i < n; ++i)
      out[written + i] = src[i] * (1.0f / 32768.0f);
  } else if (f->format == AV_SAMPLE_FMT_S16) {
    const int16_t* src = reinterpret_cast<const int16_t*>(f->extended_data[0]);
    for (int i = 0; i < n; ++i)
      out[written + i] = src[i * f->ch_layout.nb_channels + ch] *
                         (1.0f / 32768.0f);
  } else {
    return -5;  // unexpected sample format
  }
  return written + n;
}

// Limited-range BT.601 YUV420P -> packed RGB (what cv2 produces for
// typical H.264 content; tests compare against cv2 with tolerance).
void yuv420p_to_rgb(const AVFrame* f, uint8_t* rgb) {
  const int w = f->width, h = f->height;
  const bool full = f->color_range == AVCOL_RANGE_JPEG;
  for (int y = 0; y < h; ++y) {
    const uint8_t* yp = f->data[0] + y * f->linesize[0];
    const uint8_t* up = f->data[1] + (y / 2) * f->linesize[1];
    const uint8_t* vp = f->data[2] + (y / 2) * f->linesize[2];
    uint8_t* dst = rgb + static_cast<int64_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      float Y = yp[x], U = up[x / 2] - 128.0f, V = vp[x / 2] - 128.0f;
      float r, g, b;
      if (full) {
        r = Y + 1.402f * V;
        g = Y - 0.344136f * U - 0.714136f * V;
        b = Y + 1.772f * U;
      } else {
        const float y_ = 1.164383f * (Y - 16.0f);
        r = y_ + 1.596027f * V;
        g = y_ - 0.391762f * U - 0.812968f * V;
        b = y_ + 2.017232f * U;
      }
      auto clamp = [](float v) {
        return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v + 0.5f));
      };
      dst[3 * x + 0] = clamp(r);
      dst[3 * x + 1] = clamp(g);
      dst[3 * x + 2] = clamp(b);
    }
  }
}

}  // namespace

extern "C" {

int32_t avdec_available(void) { return 1; }

// Decodes an AAC (mp4a) track: `data` is the whole file buffer,
// offsets/sizes the demuxer's per-sample table, `esds` the stored
// decoder-config payload. Writes mono float32 of `channel` to `out`.
// Returns frames written (<0 on error); *sample_rate_out gets the
// decoder's true output rate.
int64_t avdec_decode_aac(const uint8_t* data, const int64_t* offsets,
                         const int64_t* sizes, int64_t n_packets,
                         const uint8_t* esds, int64_t esds_len,
                         int32_t channel, float* out, int64_t max_frames,
                         int32_t* sample_rate_out) {
  const uint8_t* asc = nullptr;
  int64_t asc_len = 0;
  if (esds && esds_len > 0)
    find_audio_specific_config(esds, esds_len, &asc, &asc_len);
  Decoder d;
  if (!d.open(AV_CODEC_ID_AAC, asc, asc_len)) return -1;
  int64_t written = 0;
  for (int64_t i = 0; i < n_packets && written < max_frames; ++i) {
    if (d.send(data + offsets[i], sizes[i]) < 0) continue;  // skip bad AU
    while (written < max_frames &&
           avcodec_receive_frame(d.ctx, d.frame) >= 0) {
      written = emit_audio(d.frame, channel, out, written, max_frames);
      if (written < 0) return written;
      if (sample_rate_out) *sample_rate_out = d.frame->sample_rate;
    }
  }
  // Drain.
  avcodec_send_packet(d.ctx, nullptr);
  while (written >= 0 && written < max_frames &&
         avcodec_receive_frame(d.ctx, d.frame) >= 0) {
    written = emit_audio(d.frame, channel, out, written, max_frames);
    if (sample_rate_out) *sample_rate_out = d.frame->sample_rate;
  }
  return written;
}

// Encodes mono float PCM to AAC-LC access units (used by the
// attention-video muxer for the reference's acodec=aac track,
// viz.py:128-137, and as the self-contained test vector source).
// Output: concatenated AUs in `out` (cap `out_max` bytes), per-AU
// sizes in `au_sizes` (cap `max_aus`), the AudioSpecificConfig in
// `asc_out` (cap `asc_max`; length written to *asc_len). Returns the
// AU count, <0 on error.
int64_t avdec_encode_aac(const float* pcm, int64_t n, int32_t sample_rate,
                         uint8_t* out, int64_t out_max, int64_t* au_sizes,
                         int64_t max_aus, uint8_t* asc_out, int64_t asc_max,
                         int64_t* asc_len) {
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_AAC);
  if (!codec) return -1;
  AVCodecContext* ctx = avcodec_alloc_context3(codec);
  AVFrame* frame = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  if (!ctx || !frame || !pkt) return -2;
  ctx->sample_rate = sample_rate;
  ctx->sample_fmt = AV_SAMPLE_FMT_FLTP;
  av_channel_layout_default(&ctx->ch_layout, 1);
  ctx->bit_rate = 96000;
  ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;  // extradata = ASC
  int64_t n_aus = 0, out_pos = 0;
  int rc = avcodec_open2(ctx, codec, nullptr);
  if (rc < 0) goto fail;
  if (asc_out && ctx->extradata_size > 0) {
    int64_t m = ctx->extradata_size < asc_max ? ctx->extradata_size : asc_max;
    std::memcpy(asc_out, ctx->extradata, m);
    *asc_len = ctx->extradata_size;
  } else if (asc_len) {
    *asc_len = 0;
  }
  {
    const int fs = ctx->frame_size > 0 ? ctx->frame_size : 1024;
    // The loop runs one extra iteration past the input so the flush
    // (send_frame(NULL)) ALWAYS happens — the old `pos <= n` bound
    // skipped it whenever n was not a multiple of frame_size, leaving
    // the encoder's last ~2 queued AUs unemitted (truncated tails).
    for (int64_t pos = 0;; pos += fs) {
      int this_n = static_cast<int>(n - pos < fs ? n - pos : fs);
      if (this_n < 0) this_n = 0;
      int send_rc;
      if (this_n > 0) {
        frame->nb_samples = this_n;
        frame->format = AV_SAMPLE_FMT_FLTP;
        av_channel_layout_default(&frame->ch_layout, 1);
        frame->sample_rate = sample_rate;
        if (av_frame_get_buffer(frame, 0) < 0) goto fail;
        std::memcpy(frame->data[0], pcm + pos, this_n * sizeof(float));
        frame->pts = pos;
        send_rc = avcodec_send_frame(ctx, frame);
        av_frame_unref(frame);
      } else {
        send_rc = avcodec_send_frame(ctx, nullptr);  // flush
      }
      if (send_rc < 0) goto fail;
      while (avcodec_receive_packet(ctx, pkt) >= 0) {
        if (n_aus >= max_aus || out_pos + pkt->size > out_max) {
          av_packet_unref(pkt);
          goto fail;
        }
        std::memcpy(out + out_pos, pkt->data, pkt->size);
        au_sizes[n_aus++] = pkt->size;
        out_pos += pkt->size;
        av_packet_unref(pkt);
      }
      if (this_n == 0) break;
    }
  }
  avcodec_free_context(&ctx);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  return n_aus;
fail:
  avcodec_free_context(&ctx);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  return -3;
}

// Encodes packed RGB frames to H.264 (libx264 through libavcodec) as
// length-prefixed (AVCC) access units ready for an 'avc1' MP4 track —
// the codec of real AudioSet media (the reference decodes it through
// torchcodec, dataset.py:91-95; this is the authoring direction, used
// for attention videos and self-contained avc1 test vectors).
// B-frames are disabled so decode order == presentation order (no ctts
// box needed). Output mirrors avdec_encode_aac: concatenated AUs in
// `out`, per-AU sizes in `au_sizes`, per-AU keyframe flags in
// `key_flags` (for the muxer's stss box), and the avcC payload
// (GLOBAL_HEADER extradata) in `avcc_out`. Returns the AU count, <0 on
// error.
int64_t avdec_encode_h264(const uint8_t* rgb, int64_t n_frames,
                          int32_t width, int32_t height, int32_t fps,
                          int32_t gop, uint8_t* out, int64_t out_max,
                          int64_t* au_sizes, uint8_t* key_flags,
                          int64_t max_aus, uint8_t* avcc_out,
                          int64_t avcc_max, int64_t* avcc_len) {
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_H264);
  if (!codec) return -1;
  AVCodecContext* ctx = avcodec_alloc_context3(codec);
  AVFrame* frame = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  if (!ctx || !frame || !pkt) return -2;
  ctx->width = width;
  ctx->height = height;
  ctx->pix_fmt = AV_PIX_FMT_YUV420P;
  ctx->time_base = AVRational{1, fps > 0 ? fps : 25};
  ctx->gop_size = gop > 0 ? gop : 12;
  ctx->max_b_frames = 0;  // decode order == presentation order
  // With GLOBAL_HEADER the libx264 wrapper sets b_annexb=0: packets
  // come length-prefixed and extradata IS the avcC payload.
  ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  av_opt_set(ctx->priv_data, "preset", "veryfast", 0);
  av_opt_set(ctx->priv_data, "crf", "18", 0);
  int64_t n_aus = 0, out_pos = 0;
  int rc = avcodec_open2(ctx, codec, nullptr);
  if (rc < 0) goto vfail;
  if (avcc_out && ctx->extradata_size > 0) {
    int64_t m = ctx->extradata_size < avcc_max ? ctx->extradata_size : avcc_max;
    std::memcpy(avcc_out, ctx->extradata, m);
    *avcc_len = ctx->extradata_size;
  } else if (avcc_len) {
    *avcc_len = 0;
  }
  for (int64_t i = 0;; ++i) {
    int send_rc;
    if (i < n_frames) {
      frame->width = width;
      frame->height = height;
      frame->format = AV_PIX_FMT_YUV420P;
      if (av_frame_get_buffer(frame, 0) < 0) goto vfail;
      if (av_frame_make_writable(frame) < 0) goto vfail;
      // RGB -> limited-range BT.601 YUV420P (inverse of
      // yuv420p_to_rgb above; chroma = average of each 2x2 block).
      const uint8_t* src = rgb + i * static_cast<int64_t>(width) * height * 3;
      for (int y = 0; y < height; ++y) {
        uint8_t* yp = frame->data[0] + y * frame->linesize[0];
        for (int x = 0; x < width; ++x) {
          const uint8_t* px = src + (static_cast<int64_t>(y) * width + x) * 3;
          float v = 0.256788f * px[0] + 0.504129f * px[1] +
                    0.097906f * px[2] + 16.0f;
          yp[x] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v + 0.5f));
        }
      }
      for (int y = 0; y < height / 2; ++y) {
        uint8_t* up = frame->data[1] + y * frame->linesize[1];
        uint8_t* vp = frame->data[2] + y * frame->linesize[2];
        for (int x = 0; x < width / 2; ++x) {
          float r = 0, g = 0, b = 0;
          for (int dy = 0; dy < 2; ++dy)
            for (int dx = 0; dx < 2; ++dx) {
              const uint8_t* px =
                  src + ((static_cast<int64_t>(2 * y + dy)) * width +
                         (2 * x + dx)) * 3;
              r += px[0];
              g += px[1];
              b += px[2];
            }
          r *= 0.25f;
          g *= 0.25f;
          b *= 0.25f;
          float u = -0.148223f * r - 0.290993f * g + 0.439216f * b + 128.0f;
          float vv = 0.439216f * r - 0.367788f * g - 0.071427f * b + 128.0f;
          up[x] = static_cast<uint8_t>(u < 0 ? 0 : (u > 255 ? 255 : u + 0.5f));
          vp[x] = static_cast<uint8_t>(vv < 0 ? 0 : (vv > 255 ? 255 : vv + 0.5f));
        }
      }
      frame->pts = i;
      send_rc = avcodec_send_frame(ctx, frame);
      av_frame_unref(frame);
    } else {
      send_rc = avcodec_send_frame(ctx, nullptr);  // flush
    }
    if (send_rc < 0) goto vfail;
    while (avcodec_receive_packet(ctx, pkt) >= 0) {
      if (n_aus >= max_aus || out_pos + pkt->size > out_max) {
        av_packet_unref(pkt);
        goto vfail;
      }
      std::memcpy(out + out_pos, pkt->data, pkt->size);
      au_sizes[n_aus] = pkt->size;
      if (key_flags) key_flags[n_aus] = (pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0;
      ++n_aus;
      out_pos += pkt->size;
      av_packet_unref(pkt);
    }
    if (i >= n_frames) break;
  }
  avcodec_free_context(&ctx);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  return n_aus;
vfail:
  avcodec_free_context(&ctx);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  return -3;
}

// Decodes ONE video frame of an H.264/MPEG-4 track: packets
// [start_idx, target_idx] (start at the preceding keyframe from the
// demuxer's sync table) are fed in order; the (target_idx -
// start_idx)-th output frame is converted to RGB. `dconf` is avcC for
// avc1 (AVCC length-prefixed NALs) or the esds payload for mp4v.
// rgb_out must hold width*height*3 bytes (dims known from the demuxer's
// track info). Returns 0, or <0 on error.
int32_t avdec_decode_video_frame(const uint8_t* data, const int64_t* offsets,
                                 const int64_t* sizes, int64_t n_packets,
                                 const uint8_t* dconf, int64_t dconf_len,
                                 uint32_t codec_fourcc, uint8_t* rgb_out,
                                 int32_t width, int32_t height) {
  AVCodecID id;
  const uint8_t* extra = dconf;
  int64_t extra_len = dconf_len;
  if (codec_fourcc == 0x61766331u /*avc1*/ ||
      codec_fourcc == 0x61766333u /*avc3*/) {
    id = AV_CODEC_ID_H264;
  } else if (codec_fourcc == 0x6D703476u /*mp4v*/) {
    id = AV_CODEC_ID_MPEG4;
    // mp4v stores the VideoObjectLayer inside esds tag 0x05.
    const uint8_t* asc;
    int64_t asc_len;
    if (dconf && dconf_len > 0 &&
        find_audio_specific_config(dconf, dconf_len, &asc, &asc_len)) {
      extra = asc;
      extra_len = asc_len;
    }
  } else {
    return -1;  // unsupported codec
  }
  Decoder d;
  if (!d.open(id, extra, extra_len)) return -2;
  int64_t produced = 0;
  const int64_t want = n_packets - 1;  // frames before the target
  for (int64_t i = 0; i < n_packets; ++i) {
    if (d.send(data + offsets[i], sizes[i]) < 0) return -3;
    while (avcodec_receive_frame(d.ctx, d.frame) >= 0) {
      if (produced++ == want) goto got;
    }
  }
  avcodec_send_packet(d.ctx, nullptr);
  while (avcodec_receive_frame(d.ctx, d.frame) >= 0) {
    if (produced++ == want) goto got;
  }
  return -4;  // target frame never produced

got:
  if (d.frame->width != width || d.frame->height != height) return -5;
  if (d.frame->format != AV_PIX_FMT_YUV420P &&
      d.frame->format != AV_PIX_FMT_YUVJ420P)
    return -6;
  yuv420p_to_rgb(d.frame, rgb_out);
  return 0;
}

}  // extern "C"
