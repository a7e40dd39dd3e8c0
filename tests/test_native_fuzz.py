"""Crash-safety fuzz for the native MP4 box parser (native/mp4.cc).

Production ingest feeds the demuxer bytes from arbitrary (possibly
truncated or corrupted) files; a malformed box must surface as a Python
error or empty result — NEVER a segfault. The parser is exercised in a
SUBPROCESS batch so an OOB read kills the child, not the test runner,
and the child's exit code is the verdict.

Inputs: seeded random garbage, truncations of a real muxed file, and
single-byte corruptions of it (box sizes/fourccs land in the first
kilobytes, so mutations concentrate there).
"""

import subprocess
import sys

import numpy as np
import pytest

from triad.data import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)

_CHILD = r"""
import sys
import tempfile

import numpy as np

sys.path.insert(0, ".")
from triad.data.mp4 import Mp4File, write_video_mp4

# a small REAL file to mutate (sowt PCM audio — encoder-free authoring)
rng = np.random.default_rng(0)
frames = rng.integers(0, 256, size=(4, 32, 32, 3), dtype=np.uint8)
wave = (np.sin(np.linspace(0, 440, 1600)) * 0.2).astype(np.float32)
with tempfile.NamedTemporaryFile(suffix=".mp4") as tf:
    write_video_mp4(tf.name, frames, fps=2, audio=wave,
                    sample_rate=16000, audio_codec="sowt")
    base = open(tf.name, "rb").read()

cases = []
for n in (0, 1, 7, 8, 64, 4096):
    cases.append(rng.integers(0, 256, size=n, dtype=np.uint8).tobytes())
for cut in rng.integers(1, len(base), size=60):
    cases.append(base[: int(cut)])
for _ in range(300):
    buf = bytearray(base)
    # box sizes/fourccs/sample tables live in the first KBs and the
    # trailing moov; hit both regions
    region = rng.integers(0, 2)
    lo, hi = (0, min(len(buf), 2048)) if region == 0 else (
        max(0, len(buf) - 4096), len(buf))
    pos = int(rng.integers(lo, hi))
    buf[pos] = int(rng.integers(0, 256))
    cases.append(bytes(buf))

survived = 0
for data in cases:
    try:
        f = Mp4File(data)
    except (ValueError, RuntimeError):
        continue
    try:
        for t, info in enumerate(f.tracks):
            try:
                if info.n_samples > 0:
                    f.sample_bytes(t, 0)
                if info.is_pcm:
                    f.decode_pcm(t)
            except (ValueError, RuntimeError, IndexError):
                pass
        survived += 1
    except (ValueError, RuntimeError, IndexError):
        pass
    finally:
        f.close()
print(f"fuzz done: {len(cases)} cases, {survived} parsed clean")
"""


def test_mp4_parser_survives_garbage():
    r = subprocess.run(
        [sys.executable, "-c", _CHILD],
        capture_output=True, text=True, timeout=600, cwd=".",
    )
    assert r.returncode == 0, (
        f"native parser crashed (rc={r.returncode}, likely SIGSEGV):\n"
        f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}"
    )
    assert "fuzz done" in r.stdout
