"""MP4 demux/mux tests (native/mp4.cc + triad/data/mp4.py).

Cross-validation strategy: cv2's VideoWriter (libavformat's MP4 muxer)
authors real files our demuxer must parse; our own muxer's output must
round-trip through BOTH our demuxer and cv2's decoder.
"""

import numpy as np
import pytest

from triad.data import native

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not native.available():
        pytest.skip("native library not buildable in this environment")


@pytest.fixture(scope="module")
def cv2_mp4(tmp_path_factory):
    """A real mp4v video (12 frames, 64x48 @ 10 fps) written by cv2."""
    path = tmp_path_factory.mktemp("mp4") / "vid.mp4"
    w = cv2.VideoWriter(
        str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48)
    )
    assert w.isOpened()
    for i in range(12):
        w.write(np.full((48, 64, 3), i * 20, np.uint8))
    w.release()
    return str(path)


class TestDemux:
    def test_track_metadata(self, cv2_mp4):
        from triad.data.mp4 import Mp4File

        with Mp4File.from_path(cv2_mp4) as f:
            tracks = f.tracks
            assert len(tracks) == 1
            t = tracks[0]
            assert t.handler == "vide"
            assert t.codec == "mp4v"
            assert (t.width, t.height) == (64, 48)
            assert t.n_samples == 12
            assert abs(t.duration_seconds - 1.2) < 0.05

    def test_sample_ranges_within_file(self, cv2_mp4):
        from triad.data.mp4 import Mp4File

        import os

        size = os.path.getsize(cv2_mp4)
        with Mp4File.from_path(cv2_mp4) as f:
            prev_end = 0
            for i in range(f.tracks[0].n_samples):
                off, n = f.sample_range(0, i)
                assert n > 0 and off >= prev_end and off + n <= size
                prev_end = off + n

    def test_decoder_config_present(self, cv2_mp4):
        from triad.data.mp4 import Mp4File

        with Mp4File.from_path(cv2_mp4) as f:
            # mp4v carries an esds decoder config
            assert len(f.decoder_config(0)) > 0

    def test_malformed_raises(self):
        from triad.data.mp4 import Mp4File

        with pytest.raises(ValueError):
            Mp4File(b"\x00\x00\x00\x08free not an mp4")


class TestMux:
    def test_remux_roundtrip(self, cv2_mp4, tmp_path):
        from triad.data.mp4 import Mp4File, extract_audio_pcm, mux_mp4

        sr = 16_000
        audio = (
            0.5 * np.sin(2 * np.pi * 440 * np.arange(sr) / sr)
        ).astype(np.float32)
        out = str(tmp_path / "remux.mp4")
        mux_mp4(out, cv2_mp4, audio, sr, audio_codec="sowt")

        # our demuxer reads both tracks back
        with Mp4File.from_path(out) as f:
            handlers = sorted(t.handler for t in f.tracks)
            assert handlers == ["soun", "vide"]
            a = f.tracks[f.find_track("soun")]
            assert a.codec == "sowt" and a.is_pcm
            assert a.sample_rate == sr and a.channels == 1
            v = f.tracks[f.find_track("vide")]
            assert (v.width, v.height) == (64, 48) and v.n_samples == 12

        # PCM roundtrip to 16-bit quantization
        got, got_sr = extract_audio_pcm(out)
        assert got_sr == sr and got.shape == (sr,)
        np.testing.assert_allclose(got, audio, atol=1.0 / 32000)

        # cv2 (libavformat) still decodes the remuxed video track
        cap = cv2.VideoCapture(out)
        frames = []
        while True:
            ok, fr = cap.read()
            if not ok:
                break
            frames.append(fr)
        cap.release()
        assert len(frames) == 12
        # frame content survived the byte-copy remux (lossy mp4v encode,
        # so compare means loosely)
        for i, fr in enumerate(frames):
            assert abs(float(fr.mean()) - i * 20) < 6.0

    def test_extract_audio_uses_native_mp4(self, cv2_mp4, tmp_path, capsys):
        """data/audio.extract_audio decodes PCM mp4 audio natively
        (no ffmpeg in this environment)."""
        from triad.data.audio import extract_audio
        from triad.data.mp4 import mux_mp4

        sr = 22_050
        audio = (
            0.3 * np.sin(2 * np.pi * 330 * np.arange(sr) / sr)
        ).astype(np.float32)
        out = str(tmp_path / "av.mp4")
        mux_mp4(out, cv2_mp4, audio, sr, audio_codec="sowt")
        got = extract_audio(out, target_sr=16_000)
        # resampled to 16 kHz, content preserved (not the zero sentinel)
        assert abs(len(got) - 16_000) <= 2
        spec = np.abs(np.fft.rfft(got))
        assert abs(float(np.argmax(spec)) - 330) < 5

    def test_attention_video_muxes_audio(self, tmp_path):
        """AudioVisualizer.make_attention_video embeds a PCM audio track
        without ffmpeg (the reference needs the ffmpeg binary for this,
        viz.py:128-137)."""
        from triad.data.mp4 import Mp4File
        from triad.viz.heatmaps import AudioVisualizer

        viz = AudioVisualizer(image_size=224)
        n_tokens = 4
        frame = np.zeros((224, 224, 3), np.float32)
        audio = 0.1 * np.sin(
            2 * np.pi * 440 * np.arange(16_000) / 16_000
        ).astype(np.float32)

        def similarity_fn(frame, audio):
            rng = np.random.default_rng(0)
            return rng.normal(size=(n_tokens, 16 * 16)).astype(np.float32)

        out = tmp_path / "attn.mp4"
        viz.make_attention_video(similarity_fn, frame, audio, str(out))
        assert out.exists()
        with Mp4File.from_path(str(out)) as f:
            handlers = sorted(t.handler for t in f.tracks)
            assert handlers == ["soun", "vide"]


def _lpcm_v2_entry(sample_rate, channels, bits, flags):
    """Hand-built QuickTime version-2 SoundDescription ('lpcm'):
    20-byte v0 part, then sizeOfStructOnly(u32)@20, f64 rate@24,
    channels@32, always7F000000@36, bits@40, format flags@44,
    bytes/packet@48, frames/packet@52."""
    import struct

    from triad.data.mp4 import _box

    body = (
        b"\x00" * 6 + struct.pack(">H", 1)  # reserved + data_ref_idx
        + struct.pack(">HHI", 2, 0, 0)  # version=2, revision, vendor
        + struct.pack(">HHHH", 3, 16, 0xFFFE, 0)  # always3/16/-2/0
        + struct.pack(">I", 0x00010000)  # always 65536 (16.16 "1.0")
        + struct.pack(">I", 72)  # sizeOfStructOnly
        + struct.pack(">d", float(sample_rate))
        + struct.pack(">I", channels)
        + struct.pack(">I", 0x7F000000)
        + struct.pack(">I", bits)
        + struct.pack(">I", flags)  # bit0 float, bit1 big-endian
        + struct.pack(">I", channels * bits // 8)
        + struct.pack(">I", 1)
    )
    return _box(b"lpcm", body)


def _audio_only_mp4(stsd_entry, pcm_bytes, sample_rate, n_frames):
    import struct

    from triad.data.mp4 import _box, _full_box, _stbl_boxes, _trak

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")
    mdat = _box(b"mdat", pcm_bytes)
    chunk_off = len(ftyp) + 8
    stbl = _stbl_boxes(1, n_frames, [len(pcm_bytes)], chunk_off, stsd_entry)
    trak = _trak(1, 1000, sample_rate, n_frames, b"soun", stbl)
    mvhd = _full_box(
        b"mvhd", 0, 0,
        struct.pack(">IIII", 0, 0, 1000, n_frames * 1000 // sample_rate)
        + struct.pack(">IH", 0x00010000, 0x0100)
        + b"\x00" * 10
        + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + b"\x00" * 24
        + struct.pack(">I", 2),
    )
    return ftyp + mdat + _box(b"moov", mvhd + trak)


class TestPcmVariants:
    def test_lpcm_v2_sound_description(self):
        """v2 ('lpcm') field offsets: rate@24, channels@32, bits@40,
        flags@44 (ADVICE round 1: these were read 4 bytes early)."""
        from triad.data.mp4 import Mp4File

        sr, ch = 48_000, 2
        n = 480
        t = np.arange(n) / sr
        left = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        right = (0.25 * np.sin(2 * np.pi * 880 * t)).astype(np.float32)
        inter = np.empty(2 * n, "<i2")
        inter[0::2] = np.round(left * 32767).astype("<i2")
        inter[1::2] = np.round(right * 32767).astype("<i2")
        # flags=0: integer, little-endian
        data = _audio_only_mp4(
            _lpcm_v2_entry(sr, ch, 16, 0), inter.tobytes(), sr, n
        )
        with Mp4File(data) as f:
            info = f.tracks[0]
            assert info.handler == "soun" and info.codec == "lpcm"
            assert info.sample_rate == sr
            assert info.channels == ch
            assert info.bits == 16
            assert info.is_pcm
            got0, got_sr = f.decode_pcm(0, channel=0)
            got1, _ = f.decode_pcm(0, channel=1)
        assert got_sr == sr and got0.shape == (n,)
        np.testing.assert_allclose(got0, left, atol=1.0 / 32000)
        np.testing.assert_allclose(got1, right, atol=1.0 / 32000)

    def test_lpcm_v2_float32_bigendian(self):
        from triad.data.mp4 import Mp4File

        sr, n = 16_000, 320
        x = np.linspace(-1, 1, n).astype(">f4")
        # flags: bit0 float | bit1 big-endian
        data = _audio_only_mp4(
            _lpcm_v2_entry(sr, 1, 32, 0x3), x.tobytes(), sr, n
        )
        with Mp4File(data) as f:
            info = f.tracks[0]
            assert info.is_pcm and info.bits == 32
            got, got_sr = f.decode_pcm(0)
        assert got_sr == sr
        np.testing.assert_allclose(got, x.astype(np.float32), atol=1e-6)

    def test_in16_codec(self):
        """'in16' = big-endian 16-bit integer PCM (v0 entry)."""
        import struct

        from triad.data.mp4 import Mp4File, _box

        sr, n = 8_000, 160
        x = (0.4 * np.sin(2 * np.pi * 100 * np.arange(n) / sr)).astype(
            np.float32
        )
        be = np.round(x * 32767).astype(">i2")
        body = (
            b"\x00" * 6 + struct.pack(">H", 1)
            + struct.pack(">HHI", 0, 0, 0)
            + struct.pack(">HHHH", 1, 16, 0, 0)
            + struct.pack(">I", sr << 16)
        )
        data = _audio_only_mp4(_box(b"in16", body), be.tobytes(), sr, n)
        with Mp4File(data) as f:
            info = f.tracks[0]
            assert info.is_pcm and info.bits == 16
            got, got_sr = f.decode_pcm(0)
        assert got_sr == sr
        np.testing.assert_allclose(got, x, atol=1.0 / 32000)

    def test_closed_handle_raises(self, cv2_mp4):
        """Methods after close() raise instead of passing NULL to the
        native API (segfault)."""
        from triad.data.mp4 import Mp4File

        f = Mp4File.from_path(cv2_mp4)
        f.close()
        with pytest.raises(ValueError, match="closed"):
            _ = f.tracks
        with pytest.raises(ValueError, match="closed"):
            f.sample_range(0, 0)


class TestAvDecode:
    """libavcodec-backed compressed-codec paths (native/avdecode.cc —
    the reference reaches the same library via torchcodec/torchaudio)."""

    @pytest.fixture(scope="class", autouse=True)
    def require_avdec(self):
        if not native.avdec_supported():
            pytest.skip("native library built without libavcodec")

    def test_aac_mux_demux_decode_roundtrip(self, cv2_mp4, tmp_path):
        """mp4a (AAC-LC) audio track: our muxer writes it (esds chain
        from the native encoder), our demuxer+libavcodec decode it."""
        from triad.data.mp4 import Mp4File, extract_audio_track, mux_mp4

        sr = 16_000
        audio = (
            0.4 * np.sin(2 * np.pi * 440 * np.arange(2 * sr) / sr)
        ).astype(np.float32)
        out = str(tmp_path / "aac.mp4")
        mux_mp4(out, cv2_mp4, audio, sr, audio_codec="mp4a")
        with Mp4File.from_path(out) as f:
            a = f.tracks[f.find_track("soun")]
            assert a.codec == "mp4a" and not a.is_pcm
            assert a.sample_rate == sr
        got, got_sr = extract_audio_track(out)
        assert got_sr == sr
        # The edit-list priming trim + encoder flush must hold the
        # presented length to within movie-timescale rounding (the
        # untrimmed/unflushed path was 1024 late and ~2k short).
        assert abs(len(got) - len(audio)) <= 32
        spec = np.abs(np.fft.rfft(got[2048 : 2048 + sr]))
        assert abs(int(np.argmax(spec)) - 440) <= 2

    def test_aac_roundtrip_sample_aligned(self, cv2_mp4, tmp_path):
        """Decoded AAC must align SAMPLE-EXACT with the source (no
        priming-delay shift): a 1024-frame lag is 64 ms of A/V skew,
        which dense grounding training would silently absorb. Noise is
        used because a sine correlates at every period."""
        from triad.data.mp4 import Mp4File, extract_audio_track, mux_mp4

        sr = 16_000
        rng = np.random.default_rng(7)
        n = sr * 2 + 500  # NOT a multiple of the 1024 AAC frame size
        kernel = np.hanning(33)
        audio = np.convolve(
            rng.normal(size=n), kernel / kernel.sum(), mode="same"
        ).astype(np.float32) * 0.3
        out = str(tmp_path / "aligned.mp4")
        mux_mp4(out, cv2_mp4, audio, sr, audio_codec="mp4a")
        with Mp4File.from_path(out) as f:
            ti = f.find_track("soun")
            assert f.edit_info(ti) is not None
            assert f.edit_info(ti)[0] == 1024  # encoder priming
        got, _ = extract_audio_track(out)
        m = min(len(got), n)
        corr = np.corrcoef(got[:m], audio[:m])[0, 1]
        assert corr > 0.98, f"misaligned decode (corr={corr:.3f})"

    def test_extract_audio_handles_aac(self, cv2_mp4, tmp_path):
        """data/audio.extract_audio decodes AAC natively (no ffmpeg
        binary in this image)."""
        from triad.data.audio import extract_audio
        from triad.data.mp4 import mux_mp4

        sr = 44_100
        audio = (
            0.3 * np.sin(2 * np.pi * 330 * np.arange(sr) / sr)
        ).astype(np.float32)
        out = str(tmp_path / "aac44.mp4")
        mux_mp4(out, cv2_mp4, audio, sr, audio_codec="mp4a")
        got = extract_audio(out, target_sr=16_000)
        assert got.size > 8000  # decoded + resampled, not the sentinel
        spec = np.abs(np.fft.rfft(got[:16_000]))
        assert abs(int(np.argmax(spec)) - 330) <= 2

    def test_native_video_frame_matches_cv2(self, cv2_mp4):
        """Native demux + libavcodec frame decode vs cv2 on the same
        mp4v file (identical codec, same frame index)."""
        from triad.data.mp4 import Mp4File

        with Mp4File.from_path(cv2_mp4) as f:
            ti = f.find_track("vide")
            rgb = f.decode_frame(ti, 5)
        assert rgb.shape == (48, 64, 3)
        cap = cv2.VideoCapture(cv2_mp4)
        cap.set(cv2.CAP_PROP_POS_FRAMES, 5)
        ok, bgr = cap.read()
        cap.release()
        assert ok
        ref = bgr[:, :, ::-1].astype(np.int16)
        diff = np.abs(rgb.astype(np.int16) - ref)
        assert float(diff.mean()) < 4.0, f"mean abs diff {diff.mean()}"

    def test_load_video_frame_uses_native(self, cv2_mp4):
        from triad.data.video import load_video_frame

        rng = np.random.default_rng(0)
        frame = load_video_frame(cv2_mp4, rng=rng, size=32,
                                 apply_augmentation=False)
        assert frame.shape == (32, 32, 3)
        assert np.isfinite(frame).all()

    def test_h264_author_demux_decode_roundtrip(self, tmp_path):
        """Native avc1 authoring (libx264 -> write_video_mp4) feeds the
        same avc1 decode path real AudioSet media exercises: avcC
        config, stss keyframe seek, H.264 decode at non-keyframe
        indices."""
        from triad.data import native
        from triad.data.mp4 import Mp4File, write_video_mp4

        if not native.h264_supported():
            pytest.skip("libavcodec built without an H.264 encoder")
        n, H, W = 30, 64, 64
        yy, xx = np.mgrid[0:H, 0:W]
        frames = np.zeros((n, H, W, 3), np.uint8)
        for i in range(n):
            frames[i, :, :, 0] = (xx * 255 // W).astype(np.uint8)
            frames[i, :, :, 1] = (yy * 255 // H).astype(np.uint8)
            x0 = (i * 2) % (W - 16)
            frames[i, 4:20, x0 : x0 + 16, 2] = 255
        sr = 16_000
        audio = 0.3 * np.sin(
            2 * np.pi * 440 * np.arange(sr) / sr
        ).astype(np.float32)
        out = str(tmp_path / "avc1.mp4")
        write_video_mp4(out, frames, fps=10, audio=audio, sample_rate=sr)
        with Mp4File.from_path(out) as f:
            v = f.tracks[f.find_track("vide")]
            assert v.codec == "avc1" and v.n_samples == n
            assert 1 < v.n_sync < n  # several GOPs -> stss written
            vi = f.find_track("vide")
            for idx in (0, 7, 17, n - 1):  # keyframes AND mid-GOP
                rgb = f.decode_frame(vi, idx)
                diff = np.abs(
                    rgb.astype(np.int16) - frames[idx].astype(np.int16)
                )
                assert diff.mean() < 4.0, f"frame {idx}: {diff.mean()}"

    def test_h264_file_readable_by_cv2(self, tmp_path):
        """Interop: cv2 (an independent demuxer+decoder) must accept
        the natively-authored avc1 file."""
        from triad.data import native
        from triad.data.mp4 import write_video_mp4

        if not native.h264_supported():
            pytest.skip("libavcodec built without an H.264 encoder")
        frames = np.linspace(0, 255, 8 * 64 * 64 * 3).reshape(
            8, 64, 64, 3
        ).astype(np.uint8)
        out = str(tmp_path / "interop.mp4")
        write_video_mp4(out, frames, fps=4)
        cap = cv2.VideoCapture(out)
        ok, first = cap.read()
        count = 1 if ok else 0
        while cap.read()[0]:
            count += 1
        cap.release()
        assert ok and first.shape == (64, 64, 3)
        assert count == 8

    def test_attention_video_aac_audio(self, tmp_path):
        """Attention videos now embed AAC audio (the reference's codec,
        viz.py:134) instead of PCM when libavcodec is linked."""
        from triad.data.mp4 import Mp4File
        from triad.viz.heatmaps import AudioVisualizer

        viz = AudioVisualizer(image_size=224)
        frame = np.zeros((224, 224, 3), np.float32)
        audio = 0.1 * np.sin(
            2 * np.pi * 440 * np.arange(16_000) / 16_000
        ).astype(np.float32)

        def similarity_fn(frame, audio):
            return np.random.default_rng(0).normal(
                size=(4, 16 * 16)
            ).astype(np.float32)

        out = tmp_path / "attn_aac.mp4"
        viz.make_attention_video(similarity_fn, frame, audio, str(out))
        with Mp4File.from_path(str(out)) as f:
            a = f.tracks[f.find_track("soun")]
            assert a.codec == "mp4a"


def test_trak_edit_list_box():
    """media_time/present_duration emit a single-entry elst whose
    segment duration is the PRESENTED length in movie-timescale units
    and whose media_time is the AAC priming delay."""
    import struct as _struct

    from triad.data.mp4 import _trak

    trak = _trak(
        2, 1000, 16000, 17408, b"soun", b"", media_time=1024,
        present_duration=16000,
    )
    i = trak.find(b"elst")
    assert i > 0
    # elst: size(4) type(4) ver/flags(4) count(4) then the v0 entry.
    count, seg_dur, media_time, rate_i, rate_f = _struct.unpack(
        ">IIiHH", trak[i + 8 : i + 24]
    )
    assert count == 1
    assert seg_dur == 16000 * 1000 // 16000  # 1 s in mvhd units
    assert media_time == 1024
    assert (rate_i, rate_f) == (1, 0)
    # and tkhd carries the presented (edited) duration too
    j = trak.find(b"tkhd")
    dur = _struct.unpack(">I", trak[j + 24 : j + 28])[0]
    assert dur == 1000


def test_trak_without_edit_list_unchanged():
    from triad.data.mp4 import _trak

    assert b"edts" not in _trak(1, 1000, 16000, 16000, b"soun", b"")
