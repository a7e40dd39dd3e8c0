"""Data pipeline tests: tokenizer (vs HF algorithm), audio utils,
augmentations, loaders, prefetch, resume cursor."""

import numpy as np
import pytest

from triad.data import (
    AVLoader,
    Prefetcher,
    SyntheticAVDataset,
    SyntheticTVDataset,
    TVLoader,
    WordPieceTokenizer,
    augment_av_frame,
    imagenet_normalize,
    pad_or_trim,
    resample,
    resize_bilinear,
)


class TestTokenizer:
    @pytest.fixture(scope="class")
    def tok(self):
        vocab = {
            "[PAD]": 0, "[UNK]": 1, "a": 2, "dog": 3, "play": 4, "##ing": 5,
            "in": 6, "the": 7, "park": 8, "##s": 9, ",": 10, "!": 11,
        }
        return WordPieceTokenizer(vocab)

    def test_wordpiece_continuation(self, tok):
        assert tok.tokenize("a dog playing") == ["a", "dog", "play", "##ing"]
        assert tok.tokenize("parks") == ["park", "##s"]

    def test_punctuation_split_and_lowercase(self, tok):
        assert tok.tokenize("A dog, playing!") == [
            "a", "dog", ",", "play", "##ing", "!",
        ]

    def test_unknown(self, tok):
        assert tok.tokenize("zebra") == ["[UNK]"]

    def test_encode_batch_fixed_shape(self, tok):
        ids, mask = tok.encode_batch(
            ["a dog", "a dog playing in the park"], max_length=4, pad_to=6
        )
        assert ids.shape == (2, 6) and mask.shape == (2, 6)
        assert mask[0].sum() == 2
        assert mask[1].sum() == 4  # truncated at max_length=4
        assert (ids[0, 2:] == 0).all()

    def test_matches_hf_algorithm(self):
        """Same vocab => same ids as the HF BERT WordPiece implementation."""
        from transformers import BertTokenizer
        import tempfile, os

        vocab_tokens = [
            "[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "the", "dog", "cat",
            "play", "##ing", "##ed", "in", "park", "run", "##s", ",", ".",
            "un", "##believ", "##able", "caf", "##e",
        ]
        with tempfile.NamedTemporaryFile(
            "w", suffix=".txt", delete=False
        ) as f:
            f.write("\n".join(vocab_tokens))
            path = f.name
        try:
            hf = BertTokenizer(path, do_lower_case=True)
            ours = WordPieceTokenizer.from_vocab_file(path)
            for text in [
                "A dog playing in the park.",
                "The cat runs, unbelievable!",
                "Café dogs played.",
                "  weird   spacing\tand\nnewlines ",
            ]:
                ref = hf.encode(text, add_special_tokens=False)
                got = ours.encode(text)
                assert got == ref, f"{text!r}: {got} != {ref}"
        finally:
            os.unlink(path)


class TestAudio:
    def test_pad_or_trim(self):
        a = np.ones(10, np.float32)
        padded = pad_or_trim(a, 16)
        assert padded.shape == (16,) and padded[:10].sum() == 10 and padded[10:].sum() == 0
        trimmed = pad_or_trim(a, 4)
        assert trimmed.shape == (4,) and (trimmed == 1).all()

    def test_resample_preserves_tone(self):
        sr, target = 44_100, 16_000
        t = np.arange(sr) / sr
        tone = np.sin(2 * np.pi * 440 * t).astype(np.float32)
        out = resample(tone, sr, target)
        assert abs(len(out) - target) <= 2
        # dominant frequency preserved
        spec = np.abs(np.fft.rfft(out[: target]))
        peak_hz = np.argmax(spec) * target / target
        assert abs(peak_hz - 440) < 5


class TestImages:
    def test_resize_shapes(self):
        img = np.random.default_rng(0).uniform(size=(100, 160, 3)).astype(np.float32)
        out = resize_bilinear(img, 224)
        assert out.shape == (224, 224, 3)

    def test_av_augment_output_range(self):
        rng = np.random.default_rng(0)
        img = rng.uniform(size=(224, 224, 3)).astype(np.float32)
        out = augment_av_frame(img, rng)
        # post-normalize range (reference viz asserts -3..3, viz.py:32-33)
        assert out.min() >= -3 and out.max() <= 3

    def test_normalize_values(self):
        img = np.ones((2, 2, 3), np.float32) * 0.5
        out = imagenet_normalize(img)
        expected = (0.5 - np.array([0.485, 0.456, 0.406])) / np.array(
            [0.229, 0.224, 0.225]
        )
        np.testing.assert_allclose(out[0, 0], expected, rtol=1e-5)


class TestLoaders:
    def test_av_loader_fixed_shapes(self):
        ds = SyntheticAVDataset(size=10, audio_seconds=1.0)
        loader = AVLoader(ds, batch_size=4, audio_num_samples=16_000, num_workers=2)
        batches = list(loader.epoch(0))
        assert len(batches) == 2  # drop_last
        for b in batches:
            assert b["images"].shape == (4, 224, 224, 3)
            assert b["audio"].shape == (4, 16_000)

    def test_tv_loader_fixed_shapes(self):
        ds = SyntheticTVDataset(size=8)
        tok = WordPieceTokenizer.build_from_corpus(ds.captions())
        loader = TVLoader(ds, tok, batch_size=4, max_text_tokens=16, num_workers=2)
        b = next(iter(loader))
        assert b["images"].shape == (4, 224, 224, 3)
        assert b["token_ids"].shape == (4, 16)
        assert b["text_mask"].shape == (4, 16)
        assert b["text_mask"].sum() > 0

    def test_resume_cursor_reproduces_batches(self):
        ds = SyntheticAVDataset(size=12, audio_seconds=0.5)
        loader = AVLoader(
            ds, batch_size=4, audio_num_samples=8000, num_workers=1, seed=3,
            augment=False,
        )
        full = list(loader.epoch(epoch=2))
        resumed = list(loader.epoch(epoch=2, start_batch=1))
        assert len(resumed) == len(full) - 1
        np.testing.assert_array_equal(full[1]["audio"], resumed[0]["audio"])

    def test_prefetcher_delivers_all(self):
        ds = SyntheticAVDataset(size=8, audio_seconds=0.5)
        loader = AVLoader(ds, batch_size=4, audio_num_samples=8000, num_workers=1)
        out = list(Prefetcher(loader.epoch(0), prefetch=2))
        assert len(out) == 2
        import jax

        assert isinstance(out[0]["audio"], jax.Array)


class TestUniqueVideoSampler:
    def test_no_duplicate_videos_in_batch(self):
        from triad.data.pipeline import UniqueVideoSampler

        ids = [0, 0, 0, 1, 1, 2, 2, 3, 4, 5, 6, 7]
        s = UniqueVideoSampler(ids, batch_size=4, seed=1, epoch=0)
        assert s.num_batches >= 1
        for b in range(s.num_batches):
            vids = [ids[i] for i in s.batch_indices(b)]
            assert len(set(vids)) == len(vids)

    def test_deterministic_per_epoch(self):
        from triad.data.pipeline import UniqueVideoSampler

        ids = list(range(16))
        a = UniqueVideoSampler(ids, 4, seed=0, epoch=3)
        b = UniqueVideoSampler(ids, 4, seed=0, epoch=3)
        c = UniqueVideoSampler(ids, 4, seed=0, epoch=4)
        import numpy as np

        np.testing.assert_array_equal(a.batch_indices(0), b.batch_indices(0))
        assert not np.array_equal(a.batch_indices(0), c.batch_indices(0))

    def test_av_loader_integration(self):
        from triad.data import AVLoader, SyntheticAVDataset

        ds = SyntheticAVDataset(size=8, audio_seconds=0.5)
        loader = AVLoader(
            ds, batch_size=4, audio_num_samples=8000, num_workers=1,
            unique_video_ids=[0, 0, 1, 1, 2, 2, 3, 3],
        )
        batches = list(loader.epoch(0))
        assert len(batches) == 1  # only 4 unique videos fit one batch


class _PlatformProbe:
    """Picklable dataset whose items report the worker's JAX backend."""

    def __len__(self):
        return 1

    def __getitem__(self, idx, apply_augmentation=False, rng=None):
        import jax

        return jax.config.jax_platforms, jax.default_backend()


class TestWorkerPool:
    def test_process_workers_keep_jax_on_cpu(self, monkeypatch):
        """Spawned decode workers never initialize an accelerator, even
        when the parent's environment names one: the trainer process
        holds the card's memory."""
        from triad.data.workers import WorkerPool

        monkeypatch.setenv("JAX_PLATFORMS", "cuda")
        pool = WorkerPool(_PlatformProbe(), 1, mode="process")
        try:
            assert pool.map([0], augment=False) == [("cpu", "cpu")]
        finally:
            pool.close()

    @pytest.mark.slow
    def test_process_pool_matches_thread_pool(self):
        """Spawned decode workers produce the same (deterministic,
        augmentation-off) batches as the in-process thread pool."""
        import numpy as np

        from triad.data.datasets import SyntheticAVDataset
        from triad.data.pipeline import AVLoader

        def make(mode):
            ds = SyntheticAVDataset(
                size=6, image_size=28, audio_seconds=0.05, seed=3
            )
            return AVLoader(
                ds, batch_size=2, audio_num_samples=800, augment=False,
                num_workers=2, worker_mode=mode, seed=5,
            )

        b_thread = list(make("thread").epoch(0))
        loader = make("process")
        try:
            b_proc = list(loader.epoch(0))
        finally:
            loader.pool.close()
        assert len(b_thread) == len(b_proc) == 3
        for bt, bp in zip(b_thread, b_proc):
            np.testing.assert_array_equal(bt["images"], bp["images"])
            np.testing.assert_array_equal(bt["audio"], bp["audio"])


class TestDeterministicAugmentation:
    """A resumed run must replay the exact augmentation draws of an
    uninterrupted one (the reference checkpoints+restores all four RNG
    states, train.py:500-514; here every draw is keyed on
    (seed, epoch, batch, idx))."""

    @pytest.fixture(scope="class")
    def caption_tree(self, tmp_path_factory):
        from PIL import Image

        root = tmp_path_factory.mktemp("captions")
        sub = root / "shard0"
        sub.mkdir()
        rng = np.random.default_rng(0)
        for i in range(8):
            arr = rng.integers(0, 255, size=(224, 224, 3), dtype=np.uint8)
            Image.fromarray(arr).save(sub / f"img{i}.jpg")
            (sub / f"img{i}.txt").write_text(f"caption number {i}")
        return str(root)

    def test_augmented_epoch_is_reproducible(self, caption_tree):
        from triad.data import LocalCaptionDataset, TVLoader, WordPieceTokenizer

        def make():
            ds = LocalCaptionDataset(caption_tree)
            tok = WordPieceTokenizer.build_from_corpus(
                [f"caption number {i}" for i in range(8)]
            )
            return TVLoader(
                ds, tok, batch_size=4, max_text_tokens=8, num_workers=2,
                seed=11, augment=True,
            )

        a = list(make().epoch(epoch=1))
        b = list(make().epoch(epoch=1))
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["images"], y["images"])

    def test_resumed_batches_bitwise_equal_augmented(self, caption_tree):
        from triad.data import LocalCaptionDataset, TVLoader, WordPieceTokenizer

        ds = LocalCaptionDataset(caption_tree)
        tok = WordPieceTokenizer.build_from_corpus(
            [f"caption number {i}" for i in range(8)]
        )
        loader = TVLoader(
            ds, tok, batch_size=4, max_text_tokens=8, num_workers=2,
            seed=7, augment=True,
        )
        full = list(loader.epoch(epoch=0))
        resumed = list(loader.epoch(epoch=0, start_batch=1))
        np.testing.assert_array_equal(
            full[1]["images"], resumed[0]["images"]
        )

    def test_different_epochs_differ(self, caption_tree):
        from triad.data import LocalCaptionDataset, TVLoader, WordPieceTokenizer

        ds = LocalCaptionDataset(caption_tree)
        tok = WordPieceTokenizer.build_from_corpus(["caption number 1"])
        loader = TVLoader(
            ds, tok, batch_size=8, max_text_tokens=8, num_workers=1,
            seed=7, augment=True, shuffle=False,
        )
        e0 = next(iter(loader.epoch(epoch=0)))
        e1 = next(iter(loader.epoch(epoch=1)))
        assert not np.array_equal(e0["images"], e1["images"])


class TestVideoIdDerivation:
    def test_strips_trailing_clip_indices(self):
        from triad.data.pipeline import video_id_from_path

        assert video_id_from_path("/x/ytid_30_40.mp4") == "ytid"
        assert video_id_from_path("/x/abc123_7.mp4") == "abc123"
        assert video_id_from_path("/x/plain.mp4") == "plain"
        # all-digits stem survives as itself
        assert video_id_from_path("/x/12345.mp4") == "12345"

    def test_av_loader_derives_ids_from_dataset(self):
        from triad.data.pipeline import AVLoader

        class StubDs:
            video_files = [
                f"/d/vid{i % 3}_{i}.mp4" for i in range(9)
            ]  # 3 source videos x 3 clips

            def __len__(self):
                return 9

            def __getitem__(self, idx, apply_augmentation=True, rng=None):
                return {
                    "video_path": self.video_files[idx],
                    "video_frames": np.zeros((28, 28, 3), np.float32),
                    "audio": np.zeros(800, np.float32),
                }

        loader = AVLoader(
            StubDs(), batch_size=3, audio_num_samples=800, num_workers=1,
            unique_videos=True,
        )
        for batch in loader.epoch(0):
            ids = [p.split("/")[-1].split("_")[0] for p in batch["video_paths"]]
            assert len(set(ids)) == 3  # one clip per source video
