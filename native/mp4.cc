// mp4.cc — native ISO-BMFF (MP4/MOV) demuxer for the triad input
// pipeline.
//
// The reference delegates MP4 demux/decode to libavcodec via torchcodec
// (video frames, reference dataset.py:91-95) and torchaudio (audio
// track, reference dataset.py:80-89). This is the framework-owned
// demux layer: it parses the box structure (moov/trak/mdia/minf/stbl),
// exposes per-track metadata + per-sample byte ranges + sync-sample
// (keyframe) tables, and natively decodes PCM audio tracks
// (sowt/twos/in16/in24/in32/fl32/fl64/raw/lpcm/ipcm+pcmC) to float32.
// Compressed codecs (mp4a/AAC, avc1/H.264) are demuxed — codec fourcc,
// decoder config (esds/avcC) and sample ranges are reported — with
// decode left to the consumer (cv2 decodes video frames today).
//
// Plain C ABI consumed via ctypes (triad/data/native.py); handle
// based, no global state, thread-safe for concurrent distinct handles.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

inline uint16_t be16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) << 8 | p[1];
}
inline uint32_t be32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) << 24 | static_cast<uint32_t>(p[1]) << 16 |
         static_cast<uint32_t>(p[2]) << 8 | p[3];
}
inline uint64_t be64(const uint8_t* p) {
  return static_cast<uint64_t>(be32(p)) << 32 | be32(p + 4);
}
inline uint32_t fourcc(const char* s) {
  return be32(reinterpret_cast<const uint8_t*>(s));
}

struct StscRun {
  uint32_t first_chunk;  // 1-based
  uint32_t samples_per_chunk;
};

struct SttsRun {
  uint32_t count;
  uint32_t delta;
};

struct Track {
  uint32_t id = 0;
  uint32_t handler = 0;  // 'vide' / 'soun' / ...
  uint32_t codec = 0;    // sample-entry fourcc: 'avc1', 'mp4a', 'sowt', ...
  uint32_t timescale = 0;
  uint64_t duration = 0;
  // audio
  uint32_t channels = 0;
  uint32_t bits = 0;  // bits per sample (PCM)
  uint32_t sample_rate = 0;
  bool pcm_float = false;
  bool pcm_le = false;
  bool is_pcm = false;
  // video
  uint32_t width = 0;
  uint32_t height = 0;
  // decoder config blob (esds payload for mp4a, avcC for avc1, ...)
  std::vector<uint8_t> dconf;
  // sample tables
  std::vector<uint32_t> sizes;      // per-sample (empty if uniform)
  uint32_t uniform_size = 0;
  std::vector<uint64_t> chunk_offsets;
  std::vector<StscRun> stsc;
  std::vector<SttsRun> stts;
  std::vector<uint32_t> sync;  // 1-based sample numbers (stss); empty = all sync
  // derived
  std::vector<uint64_t> sample_offsets;
  std::vector<uint32_t> sample_sizes;  // resolved (uniform expanded)
  // edit list (edts/elst): first non-empty edit. media_time is in
  // TRACK timescale units (for audio: sample frames — this is how MP4
  // signals the AAC encoder priming delay); segment_duration is in
  // MOVIE timescale units (converted via mvhd in mp4_track_edit).
  int64_t edit_media_time = -1;  // -1 = no edit list
  uint64_t edit_duration_mv = 0;
};

struct Mp4 {
  const uint8_t* data = nullptr;
  int64_t n = 0;
  uint32_t movie_timescale = 0;  // mvhd
  std::vector<Track> tracks;
};

// ---------------------------------------------------------------------------
// Box walking
// ---------------------------------------------------------------------------

struct Box {
  uint32_t type;
  const uint8_t* body;
  int64_t body_size;
  int64_t total_size;  // header + body, for advancing
};

// Reads the box at `p` (within `end - p` bytes). Returns false on a
// malformed header; truncated bodies are clamped to the buffer.
bool read_box(const uint8_t* p, const uint8_t* end, Box* out) {
  if (end - p < 8) return false;
  uint64_t size = be32(p);
  uint32_t type = be32(p + 4);
  int64_t hdr = 8;
  if (size == 1) {
    if (end - p < 16) return false;
    size = be64(p + 8);
    hdr = 16;
  } else if (size == 0) {
    size = end - p;  // box extends to end of file
  }
  if (size < static_cast<uint64_t>(hdr)) return false;
  // Reject sizes that do not fit in int64 (a crafted largesize near
  // 2^64 would otherwise go negative after the cast and make the box
  // walks stop advancing or step backwards out of the buffer).
  if (size > static_cast<uint64_t>(INT64_MAX)) return false;
  out->type = type;
  out->body = p + hdr;
  int64_t body = static_cast<int64_t>(size) - hdr;
  const int64_t avail = end - out->body;
  out->body_size = body < avail ? body : avail;
  out->total_size = hdr + out->body_size;
  return true;
}

void parse_stsd(const uint8_t* p, int64_t n, Track* t);

// stbl children
void parse_stbl(const uint8_t* p, int64_t n, Track* t) {
  const uint8_t* end = p + n;
  Box b;
  while (p < end && read_box(p, end, &b)) {
    const uint8_t* q = b.body;
    const int64_t m = b.body_size;
    if (b.type == fourcc("stsd") && m >= 8) {
      parse_stsd(q + 8, m - 8, t);  // skip version/flags + entry_count
    } else if (b.type == fourcc("stts") && m >= 8) {
      uint32_t cnt = be32(q + 4);
      for (uint32_t i = 0; i < cnt && 8 + 8 * (i + 1) <= m; ++i)
        t->stts.push_back({be32(q + 8 + 8 * i), be32(q + 12 + 8 * i)});
    } else if (b.type == fourcc("stsc") && m >= 8) {
      uint32_t cnt = be32(q + 4);
      for (uint32_t i = 0; i < cnt && 8 + 12 * (i + 1) <= m; ++i)
        t->stsc.push_back({be32(q + 8 + 12 * i), be32(q + 12 + 12 * i)});
    } else if (b.type == fourcc("stsz") && m >= 12) {
      t->uniform_size = be32(q + 4);
      uint32_t cnt = be32(q + 8);
      if (t->uniform_size == 0)
        for (uint32_t i = 0; i < cnt && 12 + 4 * (i + 1) <= m; ++i)
          t->sizes.push_back(be32(q + 12 + 4 * i));
      else
        t->sizes.assign(cnt, t->uniform_size);
    } else if (b.type == fourcc("stco") && m >= 8) {
      uint32_t cnt = be32(q + 4);
      for (uint32_t i = 0; i < cnt && 8 + 4 * (i + 1) <= m; ++i)
        t->chunk_offsets.push_back(be32(q + 8 + 4 * i));
    } else if (b.type == fourcc("co64") && m >= 8) {
      uint32_t cnt = be32(q + 4);
      for (uint32_t i = 0; i < cnt && 8 + 8 * (i + 1) <= m; ++i)
        t->chunk_offsets.push_back(be64(q + 8 + 8 * i));
    } else if (b.type == fourcc("stss") && m >= 8) {
      uint32_t cnt = be32(q + 4);
      for (uint32_t i = 0; i < cnt && 8 + 4 * (i + 1) <= m; ++i)
        t->sync.push_back(be32(q + 8 + 4 * i));
    }
    p += b.total_size;
  }
}

// One sample entry from stsd. Only the first entry is kept (multiple
// sample descriptions per track are vanishingly rare in practice).
void parse_stsd(const uint8_t* p, int64_t n, Track* t) {
  Box e;
  if (!read_box(p, p + n, &e) || e.body_size < 8) return;
  t->codec = e.type;
  const uint8_t* q = e.body;
  const int64_t m = e.body_size;
  // SampleEntry: 6 reserved bytes + u16 data_reference_index
  const uint8_t* body = q + 8;
  int64_t body_n = m - 8;
  int64_t child_off = -1;
  if (t->handler == fourcc("soun")) {
    if (body_n < 20) return;
    uint16_t version = be16(body);
    t->channels = be16(body + 8);
    t->bits = be16(body + 10);
    t->sample_rate = be32(body + 16) >> 16;  // 16.16 fixed
    if (version == 0) {
      child_off = 20;
    } else if (version == 1) {
      child_off = 20 + 16;
    } else if (version == 2 && body_n >= 56) {
      // QuickTime v2 sound description (lpcm): after the 20-byte v0
      // part comes sizeOfStructOnly(u32)@20, then f64 rate@24,
      // channels(u32)@32, always7F000000@36, bits(u32)@40, format
      // flags(u32)@44, bytes/packet@48, frames/packet@52.
      double rate;
      uint64_t bits_ = be64(body + 24);
      std::memcpy(&rate, &bits_, 8);
      t->sample_rate = static_cast<uint32_t>(rate + 0.5);
      t->channels = be32(body + 32);
      t->bits = be32(body + 40);
      const uint32_t flags = be32(body + 44);  // kAudioFormatFlag*
      t->pcm_float = flags & 0x1;
      t->pcm_le = !(flags & 0x2);
      child_off = 20 + 36;
    } else {
      child_off = 20;
    }
    const uint32_t c = t->codec;
    if (c == fourcc("sowt")) {
      t->is_pcm = true; t->bits = 16; t->pcm_le = true;
    } else if (c == fourcc("twos")) {
      t->is_pcm = true; t->bits = 16; t->pcm_le = false;
    } else if (c == fourcc("in16")) {
      t->is_pcm = true; t->bits = 16; t->pcm_le = false;
    } else if (c == fourcc("in24")) {
      t->is_pcm = true; t->bits = 24; t->pcm_le = false;
    } else if (c == fourcc("in32")) {
      t->is_pcm = true; t->bits = 32; t->pcm_le = false;
    } else if (c == fourcc("fl32")) {
      t->is_pcm = true; t->bits = 32; t->pcm_le = false; t->pcm_float = true;
    } else if (c == fourcc("fl64")) {
      t->is_pcm = true; t->bits = 64; t->pcm_le = false; t->pcm_float = true;
    } else if (c == fourcc("raw ")) {
      t->is_pcm = true; t->bits = 8; t->pcm_le = true;
    } else if (c == fourcc("lpcm")) {
      t->is_pcm = true;  // layout from the v2 flags above
    }
  } else if (t->handler == fourcc("vide")) {
    if (body_n < 70) return;
    // VisualSampleEntry: 16 bytes of pre_defined/reserved, then
    // width(2) height(2) at offsets 16/18.
    t->width = be16(body + 16);
    t->height = be16(body + 18);
    child_off = 70;
  } else {
    return;
  }
  // Child boxes of the sample entry: esds (mp4a), avcC (avc1),
  // pcmC (ipcm/fpcm, ISO/IEC 23003-5), enda (QuickTime endianness), ...
  if (child_off < 0 || child_off > body_n) return;
  const uint8_t* cp = body + child_off;
  const uint8_t* cend = body + body_n;
  Box cb;
  while (cp < cend && read_box(cp, cend, &cb)) {
    if (cb.type == fourcc("esds") || cb.type == fourcc("avcC") ||
        cb.type == fourcc("hvcC") || cb.type == fourcc("vpcC") ||
        cb.type == fourcc("av1C") || cb.type == fourcc("dOps")) {
      t->dconf.assign(cb.body, cb.body + cb.body_size);
    } else if (cb.type == fourcc("pcmC") && cb.body_size >= 6) {
      // FullBox: u32 version/flags, u8 format_flags (bit0 = little
      // endian), u8 PCM_sample_size.
      t->pcm_le = cb.body[4] & 0x1;
      t->bits = cb.body[5];
      t->is_pcm = true;
      t->pcm_float = t->codec == fourcc("fpcm");
    } else if (cb.type == fourcc("enda") && cb.body_size >= 2) {
      t->pcm_le = be16(cb.body) == 1;
    } else if (cb.type == fourcc("wave")) {
      // QuickTime wrapper: scan its children for enda/esds.
      const uint8_t* wp = cb.body;
      const uint8_t* wend = cb.body + cb.body_size;
      Box wb;
      while (wp < wend && read_box(wp, wend, &wb)) {
        if (wb.type == fourcc("enda") && wb.body_size >= 2)
          t->pcm_le = be16(wb.body) == 1;
        else if (wb.type == fourcc("esds"))
          t->dconf.assign(wb.body, wb.body + wb.body_size);
        wp += wb.total_size;
      }
    }
    cp += cb.total_size;
  }
  if (t->codec == fourcc("ipcm") || t->codec == fourcc("fpcm"))
    t->is_pcm = t->bits > 0;
}

void parse_trak(const uint8_t* p, int64_t n, Mp4* f) {
  Track t;
  const uint8_t* stbl_p = nullptr;
  int64_t stbl_n = 0;
  // trak -> tkhd + mdia -> mdhd/hdlr + minf -> stbl
  const uint8_t* end = p + n;
  Box b;
  while (p < end && read_box(p, end, &b)) {
    if (b.type == fourcc("tkhd") && b.body_size >= 12) {
      const uint8_t ver = b.body[0];
      // v1 layout reads bytes 20..23 — only with the bigger body.
      if (ver == 1) {
        if (b.body_size >= 24) t.id = be32(b.body + 20);
      } else {
        t.id = be32(b.body + 12);
      }
    } else if (b.type == fourcc("edts")) {
      // edts -> elst: entries are (segment_duration, media_time, rate).
      // Keep the first entry whose media_time >= 0 (an entry with
      // media_time == -1 is an empty edit = presentation delay; skip).
      const uint8_t* ep = b.body;
      const uint8_t* eend = b.body + b.body_size;
      Box eb;
      while (ep < eend && read_box(ep, eend, &eb)) {
        if (eb.type == fourcc("elst") && eb.body_size >= 8) {
          const uint8_t ver = eb.body[0];
          const uint32_t count = be32(eb.body + 4);
          const uint8_t* q = eb.body + 8;
          const int64_t entry = ver == 1 ? 20 : 12;
          for (uint32_t i = 0;
               i < count && q + entry <= eb.body + eb.body_size;
               ++i, q += entry) {
            uint64_t seg;
            int64_t mt;
            if (ver == 1) {
              seg = be64(q);
              mt = static_cast<int64_t>(be64(q + 8));
            } else {
              seg = be32(q);
              mt = static_cast<int32_t>(be32(q + 4));
            }
            if (mt >= 0) {
              t.edit_media_time = mt;
              t.edit_duration_mv = seg;
              break;
            }
          }
        }
        ep += eb.total_size;
      }
    } else if (b.type == fourcc("mdia")) {
      const uint8_t* mp = b.body;
      const uint8_t* mend = b.body + b.body_size;
      Box mb;
      while (mp < mend && read_box(mp, mend, &mb)) {
        if (mb.type == fourcc("mdhd") && mb.body_size >= 20) {
          const uint8_t ver = mb.body[0];
          if (ver == 1 && mb.body_size >= 32) {
            t.timescale = be32(mb.body + 20);
            t.duration = be64(mb.body + 24);
          } else {
            t.timescale = be32(mb.body + 12);
            t.duration = be32(mb.body + 16);
          }
        } else if (mb.type == fourcc("hdlr") && mb.body_size >= 12) {
          t.handler = be32(mb.body + 8);
        } else if (mb.type == fourcc("minf")) {
          const uint8_t* ip = mb.body;
          const uint8_t* iend = mb.body + mb.body_size;
          Box ib;
          while (ip < iend && read_box(ip, iend, &ib)) {
            if (ib.type == fourcc("stbl")) {
              stbl_p = ib.body;
              stbl_n = ib.body_size;
            }
            ip += ib.total_size;
          }
        }
        mp += mb.total_size;
      }
    }
    p += b.total_size;
  }
  if (stbl_p) parse_stbl(stbl_p, stbl_n, &t);

  // Resolve per-sample offsets from chunk offsets + stsc runs.
  const size_t n_samples = t.sizes.size();
  t.sample_offsets.reserve(n_samples);
  t.sample_sizes = t.sizes;
  size_t s = 0;
  for (size_t c = 0; c < t.chunk_offsets.size() && s < n_samples; ++c) {
    // samples-per-chunk for chunk c+1 (1-based) from the stsc runs
    uint32_t spc = 1;
    for (const auto& run : t.stsc) {
      if (run.first_chunk <= c + 1) spc = run.samples_per_chunk;
      else break;
    }
    uint64_t off = t.chunk_offsets[c];
    for (uint32_t k = 0; k < spc && s < n_samples; ++k, ++s) {
      t.sample_offsets.push_back(off);
      off += t.sample_sizes[s];
    }
  }
  // Truncated tables: drop samples we couldn't place.
  t.sample_sizes.resize(t.sample_offsets.size());
  if (t.handler == fourcc("vide") || t.handler == fourcc("soun"))
    f->tracks.push_back(std::move(t));
}

}  // namespace

extern "C" {

// Parses the container; returns an opaque handle (caller must
// mp4_close) or nullptr on malformed input. `data` must stay alive for
// the handle's lifetime (samples are read from it).
void* mp4_open(const uint8_t* data, int64_t n) {
  if (n < 8) return nullptr;
  Mp4* f = new Mp4;
  f->data = data;
  f->n = n;
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  Box b;
  bool saw_moov = false;
  while (p < end && read_box(p, end, &b)) {
    if (b.type == fourcc("moov")) {
      saw_moov = true;
      const uint8_t* mp = b.body;
      const uint8_t* mend = b.body + b.body_size;
      Box mb;
      while (mp < mend && read_box(mp, mend, &mb)) {
        if (mb.type == fourcc("trak")) {
          parse_trak(mb.body, mb.body_size, f);
        } else if (mb.type == fourcc("mvhd") && mb.body_size >= 20) {
          const uint8_t ver = mb.body[0];
          f->movie_timescale = ver == 1 && mb.body_size >= 28
                                   ? be32(mb.body + 20)
                                   : be32(mb.body + 12);
        }
        mp += mb.total_size;
      }
    }
    p += b.total_size;
  }
  if (!saw_moov) {
    delete f;
    return nullptr;
  }
  return f;
}

void mp4_close(void* h) { delete static_cast<Mp4*>(h); }

int32_t mp4_num_tracks(void* h) {
  if (!h) return -1;
  return static_cast<int32_t>(static_cast<Mp4*>(h)->tracks.size());
}

// Fills track metadata. `handler`/`codec` are big-endian fourcc u32s.
// Returns 0, or -1 on a bad track index.
int32_t mp4_track_info(void* h, int32_t ti, uint32_t* handler, uint32_t* codec,
                       uint32_t* timescale, int64_t* duration,
                       int64_t* n_samples, int32_t* channels, int32_t* bits,
                       int32_t* sample_rate, int32_t* width, int32_t* height,
                       int64_t* n_sync, int32_t* is_pcm) {
  Mp4* f = static_cast<Mp4*>(h);
  if (!f) return -1;
  if (ti < 0 || ti >= static_cast<int32_t>(f->tracks.size())) return -1;
  const Track& t = f->tracks[ti];
  *handler = t.handler;
  *codec = t.codec;
  *timescale = t.timescale;
  *duration = static_cast<int64_t>(t.duration);
  *n_samples = static_cast<int64_t>(t.sample_offsets.size());
  *channels = t.channels;
  *bits = t.bits;
  *sample_rate = t.sample_rate;
  *width = t.width;
  *height = t.height;
  *n_sync = t.sync.empty() ? *n_samples : static_cast<int64_t>(t.sync.size());
  *is_pcm = t.is_pcm ? 1 : 0;
  return 0;
}

// Edit-list (elst) info for a track, both values in TRACK timescale
// units: *media_time = presentation start offset into the media (for
// AAC audio this is the encoder priming delay in sample frames),
// *duration = presented length (0 if the elst did not record one).
// Returns 0; -1 on a bad handle/index; 1 when the track has no edit
// list (outputs set to 0).
int32_t mp4_track_edit(void* h, int32_t ti, int64_t* media_time,
                       int64_t* duration) {
  Mp4* f = static_cast<Mp4*>(h);
  if (!f) return -1;
  if (ti < 0 || ti >= static_cast<int32_t>(f->tracks.size())) return -1;
  const Track& t = f->tracks[ti];
  *media_time = 0;
  *duration = 0;
  if (t.edit_media_time < 0) return 1;
  *media_time = t.edit_media_time;
  if (t.edit_duration_mv > 0 && f->movie_timescale > 0 && t.timescale > 0) {
    *duration = static_cast<int64_t>(
        t.edit_duration_mv * static_cast<double>(t.timescale) /
        f->movie_timescale + 0.5);
  }
  return 0;
}

// Byte range of one sample. Returns 0, or <0 on bad index.
int32_t mp4_sample_range(void* h, int32_t ti, int64_t idx, int64_t* off,
                         int64_t* size) {
  Mp4* f = static_cast<Mp4*>(h);
  if (!f) return -1;
  if (ti < 0 || ti >= static_cast<int32_t>(f->tracks.size())) return -1;
  const Track& t = f->tracks[ti];
  if (idx < 0 || idx >= static_cast<int64_t>(t.sample_offsets.size())) return -2;
  *off = static_cast<int64_t>(t.sample_offsets[idx]);
  *size = t.sample_sizes[idx];
  return 0;
}

// 0-based sync-sample (keyframe) indices; all samples if no stss box.
// Returns the count written (<= max).
int64_t mp4_sync_samples(void* h, int32_t ti, int64_t* out, int64_t max) {
  Mp4* f = static_cast<Mp4*>(h);
  if (!f) return -1;
  if (ti < 0 || ti >= static_cast<int32_t>(f->tracks.size())) return -1;
  const Track& t = f->tracks[ti];
  int64_t n = 0;
  if (t.sync.empty()) {
    const int64_t total = static_cast<int64_t>(t.sample_offsets.size());
    for (; n < total && n < max; ++n) out[n] = n;
  } else {
    for (size_t i = 0; i < t.sync.size() && n < max; ++i)
      out[n++] = static_cast<int64_t>(t.sync[i]) - 1;
  }
  return n;
}

// Decoder-config blob (esds payload for mp4a, avcC for avc1, pcm boxes
// handled internally). Returns bytes written (<= max), 0 if none.
int64_t mp4_decoder_config(void* h, int32_t ti, uint8_t* out, int64_t max) {
  Mp4* f = static_cast<Mp4*>(h);
  if (!f) return -1;
  if (ti < 0 || ti >= static_cast<int32_t>(f->tracks.size())) return -1;
  const Track& t = f->tracks[ti];
  const int64_t n = std::min<int64_t>(t.dconf.size(), max);
  std::memcpy(out, t.dconf.data(), n);
  return static_cast<int64_t>(t.dconf.size());
}

// Bulk sample table: fills offsets[i]/sizes[i] for up to `max` samples
// in one FFI call (the compressed-codec decode path hands the whole
// packet table to libavcodec at once). Returns the count written, <0
// on a bad handle/track.
int64_t mp4_sample_table(void* h, int32_t ti, int64_t* offsets,
                         int64_t* sizes, int64_t max) {
  Mp4* f = static_cast<Mp4*>(h);
  if (!f) return -1;
  if (ti < 0 || ti >= static_cast<int32_t>(f->tracks.size())) return -1;
  const Track& t = f->tracks[ti];
  int64_t n = static_cast<int64_t>(t.sample_offsets.size());
  if (n > max) n = max;
  for (int64_t i = 0; i < n; ++i) {
    offsets[i] = static_cast<int64_t>(t.sample_offsets[i]);
    sizes[i] = t.sample_sizes[i];
  }
  return n;
}

// Total payload bytes across all samples of a track (one call instead
// of n_samples mp4_sample_range FFI round-trips — PCM tracks commonly
// table one sample per frame, ~160k for 10 s audio). Returns <0 on a
// bad handle/track.
int64_t mp4_track_total_bytes(void* h, int32_t ti) {
  Mp4* f = static_cast<Mp4*>(h);
  if (!f) return -1;
  if (ti < 0 || ti >= static_cast<int32_t>(f->tracks.size())) return -1;
  const Track& t = f->tracks[ti];
  uint64_t total = 0;
  for (uint32_t s : t.sample_sizes) total += s;
  return static_cast<int64_t>(total);
}

// Decodes one channel of a PCM audio track to float32 in [-1, 1].
// Returns frames written, or <0 (unsupported codec / bad track).
int64_t mp4_decode_pcm(void* h, int32_t ti, float* out, int64_t max_frames,
                       int32_t channel) {
  Mp4* f = static_cast<Mp4*>(h);
  if (!f) return -1;
  if (ti < 0 || ti >= static_cast<int32_t>(f->tracks.size())) return -1;
  const Track& t = f->tracks[ti];
  if (!t.is_pcm || t.channels == 0 || t.bits == 0) return -2;
  if (channel < 0 || channel >= static_cast<int32_t>(t.channels)) return -3;
  const uint32_t bytes_per = t.bits / 8;
  const uint64_t frame_bytes = static_cast<uint64_t>(t.channels) * bytes_per;
  if (frame_bytes == 0) return -4;
  int64_t written = 0;
  // PCM "samples" in the table may each hold one or many frames;
  // frames never straddle sample boundaries in valid files.
  for (size_t s = 0; s < t.sample_offsets.size() && written < max_frames; ++s) {
    const uint64_t off = t.sample_offsets[s];
    const uint64_t size = t.sample_sizes[s];
    if (off + size > static_cast<uint64_t>(f->n)) break;  // truncated
    const uint8_t* p = f->data + off + channel * bytes_per;
    const int64_t frames = static_cast<int64_t>(size / frame_bytes);
    for (int64_t k = 0; k < frames && written < max_frames; ++k,
                 p += frame_bytes) {
      float v = 0.f;
      if (t.pcm_float && t.bits == 32) {
        uint32_t u = t.pcm_le ? (p[0] | p[1] << 8 | p[2] << 16 |
                                 static_cast<uint32_t>(p[3]) << 24)
                              : be32(p);
        std::memcpy(&v, &u, 4);
      } else if (t.pcm_float && t.bits == 64) {
        uint64_t u = 0;
        if (t.pcm_le)
          for (int i = 7; i >= 0; --i) u = u << 8 | p[i];
        else
          u = be64(p);
        double d;
        std::memcpy(&d, &u, 8);
        v = static_cast<float>(d);
      } else if (t.bits == 16) {
        const int16_t x = t.pcm_le
                              ? static_cast<int16_t>(p[0] | p[1] << 8)
                              : static_cast<int16_t>(be16(p));
        v = x * (1.0f / 32768.0f);
      } else if (t.bits == 24) {
        int32_t x = t.pcm_le ? (p[0] << 8 | p[1] << 16 |
                                static_cast<int32_t>(p[2]) << 24)
                             : (p[2] << 8 | p[1] << 16 |
                                static_cast<int32_t>(p[0]) << 24);
        x >>= 8;
        v = x * (1.0f / 8388608.0f);
      } else if (t.bits == 32) {
        const int32_t x = static_cast<int32_t>(
            t.pcm_le ? (p[0] | p[1] << 8 | p[2] << 16 |
                        static_cast<uint32_t>(p[3]) << 24)
                     : be32(p));
        v = x * (1.0f / 2147483648.0f);
      } else if (t.bits == 8) {
        v = (static_cast<int32_t>(p[0]) - 128) * (1.0f / 128.0f);
      } else {
        return -5;
      }
      out[written++] = v;
    }
  }
  return written;
}

}  // extern "C"
