"""On-device augmentation (data/device_aug.py): the device path
(uint8 frames + int16 audio + draw params shipped, math jitted on the
accelerator) must produce the same batches as the host-side vectorized
path (data/images.apply_av_batch) for the same (seed, epoch, batch,
idx) draws — it is the production ingest fast path at chip-rate."""

import os
import tempfile

import numpy as np
import pytest

from triad.data.datasets import SyntheticAVDataset
from triad.data.packed import PackedAVDataset, pack_dataset
from triad.data.pipeline import AVLoader


@pytest.fixture(scope="module")
def pack_path():
    tmp = tempfile.mkdtemp(prefix="triad_test_devaug_")
    path = os.path.join(tmp, "t.tpack")
    src = SyntheticAVDataset(size=12, image_size=32, audio_seconds=0.5)
    pack_dataset(src, path, image_size=32, audio_samples=8000)
    yield path
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)


def _loader(pack_path, device_augment):
    return AVLoader(
        PackedAVDataset(pack_path), batch_size=4, audio_num_samples=8000,
        num_workers=0, seed=7, device_augment=device_augment,
    )


def test_device_batch_carries_wire_dtypes(pack_path):
    batch = next(iter(_loader(pack_path, True)))
    assert batch["frames_u8"].dtype == np.uint8
    assert batch["audio_i16"].dtype == np.int16
    assert batch["frames_u8"].shape == (4, 32, 32, 3)
    assert batch["audio_i16"].shape == (4, 8000)
    for k in ("aug_flip", "aug_brightness", "aug_contrast", "aug_saturation"):
        assert k in batch


def test_device_ingest_matches_host_augmentation(pack_path):
    from triad.data.device_aug import device_ingest_av

    host = next(iter(_loader(pack_path, False)))
    dev = device_ingest_av(next(iter(_loader(pack_path, True))))
    np.testing.assert_allclose(
        np.asarray(dev["images"]), host["images"], rtol=2e-5, atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(dev["audio"]), host["audio"], rtol=1e-6, atol=1e-7
    )
    assert dev["video_paths"] == host["video_paths"]


def test_ingest_passthrough_for_augmented_batches(pack_path):
    from triad.data.device_aug import device_ingest_av

    host = next(iter(_loader(pack_path, False)))
    out = device_ingest_av(host)
    np.testing.assert_allclose(
        np.asarray(out["images"]), host["images"], rtol=0, atol=0
    )


# ---------------------------------------------------------------------------
# TV path: on-device augmentation vs the host apply (same draws)
# ---------------------------------------------------------------------------


def test_device_augment_tv_matches_host_apply():
    import jax.numpy as jnp

    from triad.data.device_aug import device_augment_tv, tv_param_arrays
    from triad.data.images import apply_tv_image, draw_tv_params

    rng = np.random.default_rng(7)
    b, h, w = 5, 28, 28
    frames = rng.integers(0, 256, size=(b, h, w, 3)).astype(np.uint8)
    params = [
        draw_tv_params(np.random.default_rng((3, 0, 0, i)), h, w)
        for i in range(b)
    ]
    host = np.stack([
        apply_tv_image(f.astype(np.float32) / 255.0, p)
        for f, p in zip(frames, params)
    ])
    arrs = tv_param_arrays(params)
    dev = device_augment_tv(
        jnp.asarray(frames), jnp.asarray(arrs["aug_flip"]),
        jnp.asarray(arrs["aug_dx"]), jnp.asarray(arrs["aug_dy"]),
        jnp.asarray(arrs["aug_perm"]), jnp.asarray(arrs["aug_factors"]),
    )
    np.testing.assert_allclose(np.asarray(dev), host, rtol=2e-4, atol=2e-4)


@pytest.fixture()
def caption_dir(tmp_path):
    """Tiny on-disk LocalCaptionDataset: pre-sized jpgs + captions."""
    from PIL import Image

    root = tmp_path / "caps"
    sub = root / "a"
    sub.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(6):
        arr = rng.integers(0, 256, size=(28, 28, 3)).astype(np.uint8)
        Image.fromarray(arr).save(sub / f"img{i}.jpg", quality=95)
        (sub / f"img{i}.txt").write_text(f"caption number {i}")
    return str(root)


def test_tv_loader_device_augment_matches_host(caption_dir):
    from triad.data.datasets import LocalCaptionDataset
    from triad.data.device_aug import device_ingest_tv
    from triad.data.pipeline import TVLoader
    from triad.data.tokenizer import WordPieceTokenizer

    ds = LocalCaptionDataset(caption_dir, image_size=28)
    tok = WordPieceTokenizer.build_from_corpus(
        [ds[i][1] for i in range(len(ds))]
    )

    def loader(devaug):
        return TVLoader(
            ds, tok, batch_size=4, max_text_tokens=8, seed=3,
            num_workers=1, device_augment=devaug,
        )

    host = next(iter(loader(False)))
    raw = next(iter(loader(True)))
    assert raw["frames_u8"].dtype == np.uint8
    dev = device_ingest_tv(raw)
    # both paths decode the same jpg and draw from the same
    # (seed, epoch, batch, idx) keys — equal to device-float noise
    np.testing.assert_allclose(
        np.asarray(dev["images"]), host["images"], rtol=2e-4, atol=2e-4
    )
    np.testing.assert_array_equal(
        np.asarray(dev["token_ids"]), host["token_ids"]
    )
    assert dev["captions"] == host["captions"]
