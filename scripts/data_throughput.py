"""Host-side input-pipeline throughput benchmark (SURVEY §7.3 item 5).

Builds a directory of synthetic MP4 clips (raw-RGB video + PCM audio via
the ffmpeg-free muxer in data/mp4.py), then measures AVLoader decode
throughput in clips/s for thread vs process workers at several widths.

The useful output is per-worker clips/s and the scaling slope: the
absolute number depends on the host's core count (printed first).

Run: python scripts/data_throughput.py [num_clips] [seconds_per_clip]
"""

import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, ".")

import numpy as np

from triad.data.datasets import FlatAudioVisualDataset
from triad.data.mp4 import mux_mp4
from triad.data.pipeline import AVLoader


def build_fixtures(root: str, n: int, secs: float, fps: int = 4) -> None:
    """H.264+AAC clips (real AudioSet's codecs) when libx264 is linked,
    else cv2 mp4v + AAC/PCM remux."""
    from triad.data import native

    rng = np.random.default_rng(0)
    frames = (rng.integers(0, 255, size=(int(secs * fps), 64, 64, 3))).astype(
        np.uint8
    )
    sr = 16_000
    t = np.arange(int(secs * sr)) / sr
    if native.h264_supported():
        from triad.data.mp4 import write_video_mp4

        for i in range(n):
            audio = (
                0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t)
            ).astype(np.float32)
            write_video_mp4(
                os.path.join(root, f"clip_{i:04d}.mp4"), frames, fps,
                audio=audio, sample_rate=sr,
            )
        return
    import cv2

    base = os.path.join(root, "_video_only.mp4")
    writer = cv2.VideoWriter(
        base, cv2.VideoWriter_fourcc(*"mp4v"), fps, (64, 64)
    )
    for f in frames:
        writer.write(f[:, :, ::-1])
    writer.release()
    for i in range(n):
        audio = (0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t)).astype(np.float32)
        mux_mp4(
            os.path.join(root, f"clip_{i:04d}.mp4"), base, audio, sr
        )
    os.remove(base)


def run(loader: AVLoader, n_batches: int) -> float:
    it = loader.epoch(0)
    # warm one batch (worker spawn, imports)
    next(it)
    t0 = time.perf_counter()
    clips = 0
    for _ in range(n_batches - 1):
        batch = next(it)
        clips += batch["images"].shape[0]
    dt = time.perf_counter() - t0
    return clips / dt


def run_packed(
    image_size: int = 224,
    audio_secs: float = 10.0,
    n_clips: int = 256,
    batch_size: int = 64,
    seconds: float = 10.0,
    workers: int = 4,
    mode: str = "thread",
    device_augment: bool = False,
) -> float:
    """Full-shape packed-pipeline measurement: TriadPack shard ->
    AVLoader (augmentation on) -> Prefetcher (device_put) at B=64,
    sustained over >= ``seconds`` wall seconds. This is the number to
    compare against the device's eval consumption (bench.py clips/s):
    the loader must outrun it."""
    import tempfile

    import jax

    from triad.data.datasets import SyntheticAVDataset
    from triad.data.packed import PackedAVDataset, pack_dataset
    from triad.data.pipeline import Prefetcher, cycling

    audio_samples = int(audio_secs * 16_000)
    tmp = tempfile.mkdtemp(prefix="triad_pack_bench_")
    path = os.path.join(tmp, "bench.tpack")
    try:
        src = SyntheticAVDataset(
            size=n_clips, image_size=image_size, audio_seconds=audio_secs
        )
        t0 = time.perf_counter()
        pack_dataset(
            src, path, image_size=image_size, audio_samples=audio_samples
        )
        print(f"packed {n_clips} clips in {time.perf_counter() - t0:.1f}s")
        ds = PackedAVDataset(path)
        loader = AVLoader(
            ds, batch_size=batch_size, audio_num_samples=audio_samples,
            num_workers=workers, worker_mode=mode, seed=0,
            device_augment=device_augment,
        )
        put = None
        if device_augment:
            from triad.data.device_aug import device_ingest_av

            put = device_ingest_av
        it = Prefetcher(
            cycling(lambda e, b: loader.epoch(e, b)), prefetch=4,
            device_put=put,
        )
        batch = next(it)  # warm: workers + device transfer + augment jit
        jax.block_until_ready(batch["images"])
        clips = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            batch = next(it)
            jax.block_until_ready(batch["images"])
            clips += batch["images"].shape[0]
        dt = time.perf_counter() - t0
        it.close()
        loader.pool.close()
        rate = clips / dt
        print(
            f"packed pipeline ({mode} x{workers}, B={batch_size}, "
            f"{image_size}px, {audio_secs}s audio, "
            f"device_augment={device_augment}): {rate:.1f} clips/s "
            f"to device over {dt:.1f}s"
        )
        return rate
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "packed":
        workers = int(sys.argv[2]) if len(sys.argv) > 2 else 4
        mode = sys.argv[3] if len(sys.argv) > 3 else "thread"
        dev_aug = len(sys.argv) > 4 and sys.argv[4] == "device_augment"
        run_packed(workers=workers, mode=mode, device_augment=dev_aug)
        return
    n_clips = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    secs = float(sys.argv[2]) if len(sys.argv) > 2 else 2.0
    cpus = os.cpu_count() or 1
    print(f"cpus: {cpus}; {n_clips} clips x {secs}s")
    root = tempfile.mkdtemp(prefix="triad_data_bench_")
    try:
        build_fixtures(root, n_clips, secs)
        ds = FlatAudioVisualDataset(root)
        bs = 8
        n_batches = max(2, n_clips // bs)
        for mode in ("thread", "process"):
            for workers in (1, 2, 4):
                if workers > 2 * cpus:
                    continue
                loader = AVLoader(
                    ds, batch_size=bs,
                    audio_num_samples=int(secs * 16_000),
                    num_workers=workers, worker_mode=mode, shuffle=False,
                )
                try:
                    rate = run(loader, n_batches)
                    print(
                        f"{mode:8s} workers={workers}: {rate:8.1f} clips/s "
                        f"({rate / workers:.1f}/worker)",
                        flush=True,
                    )
                finally:
                    loader.pool.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
