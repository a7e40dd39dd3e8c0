"""Fixed-shape batch assembly + background prefetch.

The reference leans on torch DataLoader workers (train.py:157-181: 10
workers, pin_memory, prefetch, persistent, drop_last). This version
assembles **fixed-shape** numpy batches on the host (audio padded to a
configured static length instead of the batch max, text padded to
max_text_tokens — SURVEY §7.1 "fixed shapes everywhere"), loads samples
with a thread pool, and double-buffers device transfer with a background
prefetch thread.

Exact mid-epoch resume (the reference fast-forwards its iterators batch
by batch, train.py:914-926): loaders are seeded per (seed, epoch) and
accept ``start_batch`` — the permutation is recomputed and the cursor
jumps in O(1), no decode replay.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from triad.data.audio import pad_or_trim
from triad.data.tokenizer import WordPieceTokenizer
from triad.data.workers import WorkerPool


def _check_shard(shard, batch_size: int):
    """Validate a (process_index, process_count) loader shard."""
    if shard is None:
        return None
    pi, pc = int(shard[0]), int(shard[1])
    if pc <= 1:
        return None
    if not 0 <= pi < pc:
        raise ValueError(f"bad process_shard {shard}")
    if batch_size % pc:
        raise ValueError(
            f"global batch_size {batch_size} not divisible by "
            f"process_count {pc}"
        )
    return pi, pc


def _shard_rows(idx: np.ndarray, shard) -> np.ndarray:
    """This process's row-slice of a global batch's sample indices.

    Row-contiguous slicing matches the mesh's device order: process p's
    rows land on its addressable devices under a batch-axis
    NamedSharding (jax.make_array_from_process_local_data), so the
    assembled global array is bitwise the single-process batch.
    """
    if shard is None:
        return idx
    pi, pc = shard
    local = len(idx) // pc
    return idx[pi * local : (pi + 1) * local]


class _IndexSampler:
    """Deterministic shuffled epoch permutation with O(1) cursor jump."""

    def __init__(self, size: int, batch_size: int, shuffle: bool, seed: int,
                 epoch: int, drop_last: bool = True):
        self.batch_size = batch_size
        rng = np.random.default_rng((seed, epoch))
        self.order = (
            rng.permutation(size) if shuffle else np.arange(size)
        )
        n_full = size // batch_size
        if not drop_last and size % batch_size:
            n_full += 1
        self.num_batches = n_full

    def batch_indices(self, batch_idx: int) -> np.ndarray:
        lo = batch_idx * self.batch_size
        return self.order[lo : lo + self.batch_size]


def video_id_from_path(path) -> str:
    """Source-video id of a clip file: the stem with trailing
    ``_<digits>`` clip/segment indices stripped, so AudioSet-style
    shards of one video ("ytid_30_40.mp4", "ytid_40_50.mp4") share an
    id. The reference's VideoBatchSampler takes precomputed vid_nums
    (dataset.py:137-141); this derives them from the filenames we have.
    """
    import re
    from pathlib import Path

    stem = Path(path).stem
    return re.sub(r"(_\d+)+$", "", stem) or stem


class UniqueVideoSampler:
    """Batches with unique source-video ids — no same-video false
    negatives inside a contrastive batch.

    The reference defines (but never wires) exactly this
    (VideoBatchSampler, dataset.py:137-164 — SURVEY §2.2 'dead code,
    but reveals intent'); here it is a first-class, deterministic,
    cursor-resumable alternative to _IndexSampler: pass
    ``video_ids[i]`` = the source id of sample i.
    """

    def __init__(self, video_ids, batch_size: int, seed: int, epoch: int):
        self.batch_size = batch_size
        video_ids = np.asarray(video_ids)
        rng = np.random.default_rng((seed, epoch, 7))
        order = rng.permutation(len(video_ids))
        batches: List[np.ndarray] = []
        current: List[int] = []
        used: set = set()
        for idx in order:
            vid = video_ids[idx]
            if vid in used:
                continue
            current.append(int(idx))
            used.add(vid)
            if len(current) == batch_size:
                batches.append(np.asarray(current))
                current, used = [], set()
        self._batches = batches
        self.num_batches = len(batches)

    def batch_indices(self, batch_idx: int) -> np.ndarray:
        return self._batches[batch_idx]


class AVLoader:
    """Audio-visual batches: {"images": (B,H,W,3), "audio": (B,T)}."""

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        audio_num_samples: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        augment: bool = True,
        drop_last: bool = True,
        unique_video_ids=None,
        unique_videos: bool = False,
        worker_mode: str = "thread",
        device_augment: bool = False,
        process_shard=None,
    ):
        """``unique_video_ids``: optional per-sample source-video ids;
        when given, batches are drawn with the UniqueVideoSampler (no
        same-video false negatives — the reference's VideoBatchSampler
        intent, dataset.py:137-164). ``unique_videos``: derive those ids
        from the dataset's current file list via video_id_from_path at
        each epoch start (tracks segment switches).

        ``worker_mode``: "thread" (in-process) or "process" (spawned
        decode workers — true CPU parallelism, data/workers.py).

        ``process_shard``: (process_index, process_count) on multi-host
        runs (parallel/distributed.py). Every process runs the SAME
        deterministic sampler and decodes only its row-slice of each
        global batch, so batch composition, order and augmentation
        draws are bitwise-identical to a single-process run."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.audio_num_samples = audio_num_samples
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.augment = augment
        self.drop_last = drop_last
        self.unique_video_ids = unique_video_ids
        self.unique_videos = unique_videos
        # Emit raw uint8 frames + draw params and let the device run the
        # augment math (data/device_aug.py) — requires a dataset with
        # raw_item and a Prefetcher using device_ingest_av.
        self.device_augment = device_augment and hasattr(
            dataset, "raw_item"
        )
        if unique_videos and unique_video_ids is None and not hasattr(
            dataset, "video_files"
        ):
            raise ValueError(
                "unique_videos needs a dataset with video_files (or pass "
                "unique_video_ids)"
            )
        self.process_shard = _check_shard(process_shard, batch_size)
        self.pool = WorkerPool(dataset, num_workers, worker_mode)

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def epoch(self, epoch: int, start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        ids = self.unique_video_ids
        if ids is None and self.unique_videos:
            ids = [video_id_from_path(p) for p in self.dataset.video_files]
        if ids is not None:
            sampler = UniqueVideoSampler(
                ids, self.batch_size, self.seed, epoch
            )
        else:
            sampler = _IndexSampler(
                len(self.dataset), self.batch_size, self.shuffle, self.seed,
                epoch, self.drop_last,
            )
        batched_aug = self.augment and hasattr(self.dataset, "raw_item")
        for b in range(start_batch, sampler.num_batches):
            idx = _shard_rows(sampler.batch_indices(b), self.process_shard)
            if batched_aug:
                # Fast path (pre-decoded datasets): fetch raw pixels,
                # then augment the whole batch with vectorized numpy
                # (or, with device_augment, ship uint8 + params and let
                # the accelerator do the math — data/device_aug.py).
                # Per-item augmentation is GIL-bound at chip-rate
                # ingest. Draws stay deterministic per (seed, epoch,
                # batch, idx).
                from triad.data.images import (
                    apply_av_batch,
                    draw_av_params,
                )

                ds = self.dataset
                items = list(
                    self.pool._ensure().map(ds.raw_item, [int(i) for i in idx])
                ) if self.pool.mode == "thread" else [
                    ds.raw_item(int(i)) for i in idx
                ]
                params = [
                    draw_av_params(
                        np.random.default_rng((self.seed, epoch, b, int(i)))
                    )
                    for i in idx
                ]
                if self.device_augment:
                    from triad.data.device_aug import av_param_arrays

                    # Wire dtypes: uint8 pixels + int16 audio (the
                    # shard's storage form) — the device divides by
                    # 255/32767. Host cost per clip is one memcpy.
                    yield {
                        "frames_u8": np.stack(
                            [it["frame_u8"] for it in items]
                        ),
                        "audio_i16": np.stack(
                            [
                                pad_or_trim(
                                    it["audio_i16"], self.audio_num_samples,
                                    np.int16,
                                )
                                for it in items
                            ]
                        ),
                        "video_paths": [it["video_path"] for it in items],
                        **av_param_arrays(params),
                    }
                    continue
                # Host-batched augmentation: one vectorized fp32
                # conversion for the whole batch (per-item /255 and
                # /32767 measured ~0.7 ms/clip on 1 core).
                images = apply_av_batch(
                    np.stack([it["frame_u8"] for it in items]).astype(
                        np.float32
                    )
                    / 255.0,
                    params,
                )
            else:
                # Deterministic augmentation: one RNG per draw, keyed on
                # (seed, epoch, batch, idx) — a resumed run replays the
                # exact augmentations (reference RNG restore,
                # train.py:500-514).
                seeds = [(self.seed, epoch, b, int(i)) for i in idx]
                items = self.pool.map(idx, self.augment, seeds=seeds)
                images = np.stack([it["video_frames"] for it in items])
            if "audio_i16" in items[0]:
                # Packed storage form: batch the int16 pad/stack, one
                # vectorized fp32 conversion.
                audio = (
                    np.stack(
                        [
                            pad_or_trim(
                                it["audio_i16"], self.audio_num_samples,
                                np.int16,
                            )
                            for it in items
                        ]
                    ).astype(np.float32)
                    / 32767.0
                )
            else:
                audio = np.stack(
                    [
                        pad_or_trim(it["audio"], self.audio_num_samples)
                        for it in items
                    ]
                )
            yield {
                "images": np.asarray(images, np.float32),  # no-op if f32
                "audio": audio,
                "video_paths": [it["video_path"] for it in items],
            }

    def __iter__(self):
        return self.epoch(0)


class TVLoader:
    """Text-visual batches:
    {"images": (B,H,W,3), "token_ids": (B,L), "text_mask": (B,L)}."""

    def __init__(
        self,
        dataset: Any,
        tokenizer: WordPieceTokenizer,
        batch_size: int,
        max_text_tokens: int = 128,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        augment: bool = True,
        drop_last: bool = True,
        worker_mode: str = "thread",
        process_shard=None,
        device_augment: bool = False,
    ):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.process_shard = _check_shard(process_shard, batch_size)
        self.pool = WorkerPool(dataset, num_workers, worker_mode)
        self.batch_size = batch_size
        self.max_text_tokens = max_text_tokens
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.augment = augment
        self.drop_last = drop_last
        # Ship decoded uint8 pixels + draw params; the augment math runs
        # on-device (data/device_aug.device_augment_tv). Needs a dataset
        # exposing raw_item and only applies while augmenting (the clean
        # path has no draw to defer).
        self.device_augment = device_augment and hasattr(
            dataset, "raw_item"
        )

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def epoch(self, epoch: int, start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        sampler = _IndexSampler(
            len(self.dataset), self.batch_size, self.shuffle, self.seed, epoch,
            self.drop_last,
        )
        for b in range(start_batch, sampler.num_batches):
            idx = _shard_rows(sampler.batch_indices(b), self.process_shard)
            if self.device_augment and self.augment:
                from triad.data.device_aug import tv_param_arrays
                from triad.data.images import draw_tv_params

                ds = self.dataset
                items = list(
                    self.pool._ensure().map(
                        ds.raw_item, [int(i) for i in idx]
                    )
                ) if self.pool.mode == "thread" else [
                    ds.raw_item(int(i)) for i in idx
                ]
                frames = np.stack([it["image_u8"] for it in items])
                h, w = frames.shape[1], frames.shape[2]
                # Same per-item draw keys as the host path, so a run is
                # bitwise-resumable across aug placements.
                params = [
                    draw_tv_params(
                        np.random.default_rng(
                            (self.seed, epoch, b, int(i))
                        ), h, w,
                    )
                    for i in idx
                ]
                captions = [it["caption"] for it in items]
                ids, mask = self.tokenizer.encode_batch(
                    captions, max_length=self.max_text_tokens,
                    pad_to=self.max_text_tokens,
                )
                yield {
                    "frames_u8": frames,
                    **tv_param_arrays(params),
                    "token_ids": ids,
                    "text_mask": mask.astype(np.float32),
                    "captions": captions,
                }
                continue
            seeds = [(self.seed, epoch, b, int(i)) for i in idx]
            items = self.pool.map(idx, self.augment, seeds=seeds)
            images = np.stack([img for img, _ in items])
            captions = [cap for _, cap in items]
            ids, mask = self.tokenizer.encode_batch(
                captions, max_length=self.max_text_tokens,
                pad_to=self.max_text_tokens,
            )
            yield {
                "images": np.asarray(images, np.float32),
                "token_ids": ids,
                "text_mask": mask.astype(np.float32),
                "captions": captions,
            }

    def __iter__(self):
        return self.epoch(0)


class Prefetcher:
    """Background-thread prefetch + device placement (double buffering —
    the host assembles batch N+k while the device runs batch N)."""

    def __init__(
        self,
        iterator: Iterator,
        prefetch: int = 2,
        device_put: Optional[Callable] = None,
    ):
        import jax

        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._sentinel = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        put = device_put or (
            lambda b: {
                k: jax.device_put(v) if isinstance(v, np.ndarray) else v
                for k, v in b.items()
            }
        )

        def worker():
            try:
                for batch in iterator:
                    item = put(batch)
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # noqa: BLE001
                self._err = e
            finally:
                try:
                    self._q.put_nowait(self._sentinel)
                except queue.Full:
                    pass

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the background thread (used between epochs — the wrapped
        iterator may be endless)."""
        self._stop.set()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def cycling(make_epoch: Callable[[int, int], Iterator], start_epoch: int = 0,
            start_batch: int = 0) -> Iterator:
    """Endless iterator over epochs (the reference restarts exhausted
    iterators mid-epoch, train.py:944-969)."""
    epoch = start_epoch
    batch = start_batch
    while True:
        yielded = False
        for item in make_epoch(epoch, batch):
            yielded = True
            yield item
        epoch += 1
        batch = 0
        if not yielded and epoch > start_epoch + 1:
            raise RuntimeError("empty dataset")
