"""TriadPack pre-decoded shard format (data/packed.py — SURVEY §7.3
item 5's packed-format escape hatch for chip-rate ingest)."""

import numpy as np
import pytest

from triad.data.datasets import SyntheticAVDataset
from triad.data.packed import PackedAVDataset, pack_dataset


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    root = tmp_path_factory.mktemp("pack")
    ds = SyntheticAVDataset(size=6, image_size=28, audio_seconds=0.1)
    path = str(root / "train_000.tpack")
    n = pack_dataset(ds, path, image_size=28, audio_samples=1600)
    assert n == 6
    return path, ds


class TestRoundTrip:
    def test_unaugmented_matches_source(self, shard):
        path, src = shard
        packed = PackedAVDataset(path)
        assert len(packed) == 6
        for i in range(6):
            a = src.__getitem__(i, apply_augmentation=False)
            b = packed.__getitem__(i, apply_augmentation=False)
            # uint8 quantization: pixel error <= 0.5/255 pre-normalize
            np.testing.assert_allclose(
                a["video_frames"], b["video_frames"], atol=0.5 / 255 / 0.22
            )
            a_audio = a["audio"][:1600]
            np.testing.assert_allclose(
                a_audio, b["audio"][: len(a_audio)], atol=1.5 / 32767
            )

    def test_deterministic_augmentation(self, shard):
        path, _ = shard
        packed = PackedAVDataset(path)
        r1 = packed.__getitem__(0, rng=np.random.default_rng((1, 2, 3)))
        r2 = packed.__getitem__(0, rng=np.random.default_rng((1, 2, 3)))
        np.testing.assert_array_equal(r1["video_frames"], r2["video_frames"])

    def test_corrupt_record_returns_zeros(self, shard, tmp_path):
        path, _ = shard
        import shutil

        bad = tmp_path / "bad.tpack"
        shutil.copy(path, bad)
        packed = PackedAVDataset(str(bad))
        packed.shards[0].paths = ["x"]  # force index error on sample 1
        item = packed.__getitem__(1, apply_augmentation=False)
        assert float(np.abs(item["video_frames"]).sum()) == 0.0

    def test_multi_shard_and_segments(self, tmp_path):
        ds = SyntheticAVDataset(size=4, image_size=28, audio_seconds=0.05)
        for k in range(2):
            pack_dataset(
                ds, str(tmp_path / f"s{k}.tpack"), image_size=28,
                audio_samples=800, indices=[0, 1] if k == 0 else [2, 3],
            )
        flat = PackedAVDataset(str(tmp_path))
        assert len(flat) == 4
        ref = ds.__getitem__(3, apply_augmentation=False)
        got = flat.__getitem__(3, apply_augmentation=False)
        np.testing.assert_allclose(
            ref["video_frames"], got["video_frames"], atol=0.5 / 255 / 0.22
        )

        seg = PackedAVDataset(str(tmp_path), segmented=True)
        assert len(seg) == 2
        seg.set_segment(1)
        got = seg.__getitem__(0, apply_augmentation=False)
        np.testing.assert_allclose(
            ds.__getitem__(2, apply_augmentation=False)["video_frames"],
            got["video_frames"], atol=0.5 / 255 / 0.22,
        )

    def test_av_loader_integration(self, shard):
        from triad.data.pipeline import AVLoader

        path, _ = shard
        packed = PackedAVDataset(path)
        loader = AVLoader(
            packed, batch_size=3, audio_num_samples=1600, num_workers=2,
            seed=1,
        )
        batches = list(loader.epoch(0))
        assert len(batches) == 2
        assert batches[0]["images"].shape == (3, 28, 28, 3)
        assert batches[0]["audio"].shape == (3, 1600)

    def test_trainer_root_detection(self, shard):
        from triad.train.trainer import _open_av_root

        path, _ = shard
        ds = _open_av_root(path, 28, segmented=False)
        assert isinstance(ds, PackedAVDataset)
        with pytest.raises(ValueError, match="image_size"):
            _open_av_root(path, 224, segmented=False)


class TestBatchedAugmentation:
    def test_apply_av_batch_matches_per_item(self):
        """Batched augmentation == per-item augment_av_frame with the
        same draws (tolerance: reduction-order ulps in the means)."""
        from triad.data.images import (
            apply_av_batch,
            augment_av_frame,
            draw_av_params,
        )

        rng = np.random.default_rng(0)
        imgs = rng.uniform(0, 1, size=(6, 32, 32, 3)).astype(np.float32)
        params = [
            draw_av_params(np.random.default_rng((5, i))) for i in range(6)
        ]
        batched = apply_av_batch(imgs.copy(), params)
        for i in range(6):
            single = augment_av_frame(
                imgs[i], np.random.default_rng((5, i))
            )
            np.testing.assert_allclose(batched[i], single, atol=2e-5)

    def test_loader_fast_path_deterministic(self, shard):
        from triad.data.pipeline import AVLoader

        path, _ = shard
        packed = PackedAVDataset(path)
        mk = lambda: AVLoader(
            packed, batch_size=3, audio_num_samples=1600, num_workers=2,
            seed=9, augment=True,
        )
        a = [b["images"] for b in mk().epoch(1)]
        b = [b["images"] for b in mk().epoch(1)]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


class TestIndexDiscipline:
    """Index errors are LOGIC errors and must escape the zero-tensor
    fault-tolerance net (the reference raises from video_files[idx]);
    only corrupt-record decodes degrade to zeros."""

    def test_out_of_range_raises(self, shard):
        path, _ = shard
        packed = PackedAVDataset(path)
        with pytest.raises(IndexError):
            packed[6]
        with pytest.raises(IndexError):
            packed.raw_item(6)
        # Python's __getitem__ iteration protocol terminates on it.
        assert len(list(packed[i] for i in range(len(packed)))) == 6

    def test_negative_index_is_pythonic(self, shard):
        path, _ = shard
        packed = PackedAVDataset(path)
        last = packed.__getitem__(len(packed) - 1, apply_augmentation=False)
        neg = packed.__getitem__(-1, apply_augmentation=False)
        np.testing.assert_array_equal(
            last["video_frames"], neg["video_frames"]
        )
        with pytest.raises(IndexError):
            packed[-7]

    def test_segmented_stale_index_raises(self, tmp_path):
        big = SyntheticAVDataset(size=5, image_size=28, audio_seconds=0.1)
        small = SyntheticAVDataset(size=2, image_size=28, audio_seconds=0.1)
        pack_dataset(big, str(tmp_path / "seg_000.tpack"),
                     image_size=28, audio_samples=1600)
        pack_dataset(small, str(tmp_path / "seg_001.tpack"),
                     image_size=28, audio_samples=1600)
        ds = PackedAVDataset(str(tmp_path), segmented=True)
        ds.set_segment(1)
        assert len(ds) == 2
        with pytest.raises(IndexError):
            ds[4]  # index from the previous (larger) segment

    def test_mismatched_shard_geometry_rejected(self, tmp_path):
        a = SyntheticAVDataset(size=2, image_size=28, audio_seconds=0.1)
        b = SyntheticAVDataset(size=2, image_size=32, audio_seconds=0.1)
        pack_dataset(a, str(tmp_path / "m_000.tpack"),
                     image_size=28, audio_samples=1600)
        pack_dataset(b, str(tmp_path / "m_001.tpack"),
                     image_size=32, audio_samples=1600)
        with pytest.raises(ValueError, match="geometry"):
            PackedAVDataset(str(tmp_path))

    def test_raw_item_zero_fallback_on_corrupt_record(self, shard):
        path, _ = shard
        ds = PackedAVDataset(path)
        # Simulate a corrupt/short mapping: the last record's bytes are
        # missing, so record() reshapes an undersized buffer and raises;
        # raw_item must degrade to zeros at STORAGE dtypes (the loader
        # fast path has no try of its own).
        ds.shards[0].mm = ds.shards[0].mm[: ds.shards[0].stride * 5]
        item = ds.raw_item(len(ds) - 1)
        assert item["frame_u8"].dtype == np.uint8
        assert item["audio_i16"].dtype == np.int16
        assert not item["frame_u8"].any()
        assert item["video_path"].startswith("packed://")
