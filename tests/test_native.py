"""Native data-ops library tests: builds via make, validates against the
numpy/scipy reference implementations."""

import numpy as np
import pytest

from triad.data import native


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not native.available():
        pytest.skip("native library not buildable in this environment")


class TestResample:
    def test_tone_preserved(self):
        sr, target = 44_100, 16_000
        t = np.arange(sr) / sr
        tone = np.sin(2 * np.pi * 440 * t).astype(np.float32)
        out = native.resample(tone, sr, target)
        assert abs(len(out) - target) <= 2
        spec = np.abs(np.fft.rfft(out[:target]))
        peak_hz = float(np.argmax(spec))
        assert abs(peak_hz - 440) < 5
        # amplitude roughly preserved (passband ~unity)
        assert 0.8 < np.abs(out[100:-100]).max() < 1.2

    def test_matches_scipy_closely(self):
        from triad.data.audio import resample as scipy_resample

        rng = np.random.default_rng(0)
        sr, target = 48_000, 16_000
        # band-limited signal below the target Nyquist
        t = np.arange(sr) / sr
        sig = sum(
            np.sin(2 * np.pi * f * t + p)
            for f, p in [(300, 0.1), (1200, 1.0), (3000, 2.0)]
        ).astype(np.float32)
        ours = native.resample(sig, sr, target)
        ref = scipy_resample(sig, sr, target)
        n = min(len(ours), len(ref)) - 200
        err = np.abs(ours[100 : 100 + n] - ref[100 : 100 + n]).max()
        assert err < 0.02, f"resample deviates from scipy by {err}"

    def test_identity_when_same_rate(self):
        x = np.random.default_rng(1).normal(size=1000).astype(np.float32)
        out = native.resample(x, 16_000, 16_000)
        np.testing.assert_array_equal(out, x)


class TestNormalizePad:
    def test_matches_numpy_reference(self):
        rng = np.random.default_rng(2)
        audio = rng.normal(size=5000).astype(np.float32)
        out = native.normalize_pad_waveform(audio, 8000)
        padded = np.zeros(8000, np.float32)
        padded[:5000] = audio
        ref = (padded - padded.mean()) / np.sqrt(padded.var() + 1e-7)
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)

    def test_trim(self):
        audio = np.ones(100, np.float32)
        out = native.normalize_pad_waveform(audio, 50)
        assert out.shape == (50,)
        # constant input -> zero mean after normalize
        np.testing.assert_allclose(out.mean(), 0.0, atol=1e-5)


class TestResizeNormalize:
    def test_matches_numpy_path(self):
        from triad.data.images import imagenet_normalize, resize_bilinear

        rng = np.random.default_rng(3)
        img = rng.integers(0, 256, size=(100, 160, 3), dtype=np.uint8)
        ours = native.resize_normalize_image(img, 64)
        ref = imagenet_normalize(
            resize_bilinear(img.astype(np.float32) / 255.0, 64)
        )
        np.testing.assert_allclose(ours, ref, atol=2e-2)

    def test_no_normalize_range(self):
        img = np.full((50, 50, 3), 128, np.uint8)
        out = native.resize_normalize_image(img, 32, normalize=False)
        np.testing.assert_allclose(out, 128 / 255.0, atol=1e-3)


class TestWavDecode:
    def _make_wav(self, sr=22050, n=2000, channels=2, width=2):
        import io
        import wave

        import numpy as np

        t = np.arange(n) / sr
        sig = np.stack(
            [np.sin(2 * np.pi * 440 * t), np.cos(2 * np.pi * 220 * t)][:channels],
            axis=1,
        )
        if width == 2:
            pcm = (sig * 32767).astype(np.int16)
        else:
            pcm = (sig * 2147483647).astype(np.int32)
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(width)
            w.setframerate(sr)
            w.writeframes(pcm.tobytes())
        return buf.getvalue(), sig

    def test_native_matches_stdlib(self):
        import numpy as np

        from triad.data import native

        data, sig = self._make_wav()
        out_py, sr_py = native._decode_wav_py(data, 0)
        if native.available():
            out, sr = native.decode_wav(data, 0)
            assert sr == sr_py == 22050
            np.testing.assert_allclose(out, out_py, atol=1e-6)
        np.testing.assert_allclose(out_py, sig[:, 0], atol=1e-3)

    def test_channel_selection_and_pcm32(self):
        import numpy as np

        from triad.data import native

        data, sig = self._make_wav(width=4)
        if native.available():
            out1, _ = native.decode_wav(data, 1)
        else:
            out1, _ = native._decode_wav_py(data, 1)
        np.testing.assert_allclose(np.asarray(out1), sig[:, 1], atol=1e-3)

    def test_load_wav_resamples(self, tmp_path):
        import numpy as np

        from triad.data.native import load_wav

        data, _ = self._make_wav(sr=22050, n=22050)
        p = tmp_path / "a.wav"
        p.write_bytes(data)
        out = load_wav(p, target_sr=16000)
        assert abs(len(out) - 16000) <= 2
        assert np.isfinite(out).all()

    def test_invalid_wav_raises(self):
        import pytest

        from triad.data import native

        if not native.available():
            pytest.skip("native lib unavailable")
        with pytest.raises(ValueError):
            native.decode_wav(b"not a wav file at all.........")
