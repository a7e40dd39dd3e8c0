"""Visualization tests: heatmap math (double-squaring quirk), colormap,
overlay blending, PNG grid and mp4 generation (the reference's quick
tests, viz.py:345-379, made into real assertions)."""

import numpy as np
import pytest

from triad.data.images import imagenet_normalize
from triad.viz import (
    AudioVisualizer,
    TextVisualizer,
    denormalize_frame,
    overlay_heatmap,
    patches_to_heatmaps,
)


class TestHeatmapMath:
    def test_patches_to_heatmaps_shape_and_square(self):
        sims = np.full((3, 16), 2.0, np.float32)
        hm = patches_to_heatmaps(sims, grid=4, image_size=28)
        assert hm.shape == (3, 28, 28)
        # squared before upsample: constant 2 -> constant 4
        np.testing.assert_allclose(hm, 4.0, rtol=1e-5)

    def test_overlay_blend_alpha(self):
        frame = np.full((8, 8, 3), 200, np.uint8)
        heat = np.zeros((8, 8), np.float32)
        heat[0, 0] = 1.0  # max -> yellow; rest min -> transparent black
        out = overlay_heatmap(frame, heat, alpha=0.3)
        # min cell: 0.7*200 + 0.3*0 = 140
        assert tuple(out[4, 4]) == (140, 140, 140)
        # max cell: yellow (255,255,0) blended, floored to uint8
        np.testing.assert_array_equal(out[0, 0], [216, 216, 140])

    def test_denormalize_roundtrip(self):
        img = np.random.default_rng(0).uniform(size=(4, 4, 3)).astype(np.float32)
        rgb = denormalize_frame(imagenet_normalize(img))
        np.testing.assert_allclose(rgb, img * 255, atol=1.0)


@pytest.fixture
def fake_similarity():
    rng = np.random.default_rng(0)

    def fn(frame, audio):
        na = 7
        return rng.normal(size=(na, 256)).astype(np.float32)

    return fn


class TestAudioVisualizer:
    def test_token_grid_png(self, fake_similarity, tmp_path):
        viz = AudioVisualizer()
        frame = imagenet_normalize(
            np.ones((224, 224, 3), np.float32)
        )
        t = np.linspace(0, 2 * np.pi, 16331).astype(np.float32)
        audio = np.sin(2 * np.pi * 440 * t)
        out = tmp_path / "attn.png"
        viz.plot_audio_token_attentions(
            fake_similarity, frame, audio, str(out), num_tokens_to_show=5
        )
        assert out.exists() and out.stat().st_size > 1000

    def test_attention_video(self, fake_similarity, tmp_path):
        viz = AudioVisualizer()
        frame = imagenet_normalize(np.ones((224, 224, 3), np.float32))
        audio = np.sin(np.linspace(0, 100, 16331)).astype(np.float32)
        out = tmp_path / "attn.mp4"
        viz.make_attention_video(fake_similarity, frame, audio, str(out), fps=5)
        assert out.exists() and out.stat().st_size > 1000

    def test_input_validation(self, fake_similarity):
        viz = AudioVisualizer()
        bad_frame = np.full((224, 224, 3), 100.0, np.float32)  # not normalized
        with pytest.raises(AssertionError):
            viz.get_attention_maps(
                fake_similarity, bad_frame, np.zeros(16331, np.float32)
            )


class TestTextVisualizer:
    def test_token_grid_png(self, tmp_path):
        rng = np.random.default_rng(1)

        def sim_fn(frame, text):
            toks = text.split()
            return rng.normal(size=(len(toks), 256)).astype(np.float32), toks

        viz = TextVisualizer()
        frame = imagenet_normalize(np.ones((224, 224, 3), np.float32))
        out = tmp_path / "text_attn.png"
        viz.plot_token_attentions(
            sim_fn, frame, "a dog playing in the park", str(out)
        )
        assert out.exists() and out.stat().st_size > 1000
