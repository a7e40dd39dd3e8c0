"""Encoder parity tests vs HF torch models instantiated from config.

No network needed: HF models are built with random init from config
objects, their weights ported via triad.models.weights, and outputs
compared in fp32. This pins the numerics of every backbone (SURVEY §7.2
step 2; BASELINE north star requires outputs matching the torch
reference within tolerance).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from triad.core.config import DistilBertConfig, HubertConfig, ViTConfig
from triad.models.distilbert import DistilBertModel
from triad.models.hubert import HubertModel, normalize_waveform
from triad.models.vit import DinoViT
from triad.models.weights import port_distilbert, port_dinov2, port_hubert

torch.manual_seed(0)


# Small configs keep CPU test time reasonable; architecture code paths are
# identical to full size.
SMALL_TEXT = dict(
    vocab_size=120, hidden_size=32, num_layers=2, num_heads=4,
    intermediate_size=64, max_position_embeddings=64,
)
SMALL_VIT = dict(
    image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=4,
    num_register_tokens=4,
)
SMALL_HUBERT = dict(
    hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
    conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
)


class TestDistilBertParity:
    @pytest.fixture(scope="class")
    def models(self):
        from transformers import DistilBertConfig as HFConfig
        from transformers import DistilBertModel as HFModel

        hf = HFModel(
            HFConfig(
                vocab_size=SMALL_TEXT["vocab_size"],
                dim=SMALL_TEXT["hidden_size"],
                n_layers=SMALL_TEXT["num_layers"],
                n_heads=SMALL_TEXT["num_heads"],
                hidden_dim=SMALL_TEXT["intermediate_size"],
                max_position_embeddings=SMALL_TEXT["max_position_embeddings"],
            )
        ).eval()
        cfg = DistilBertConfig(**SMALL_TEXT)
        flax_model = DistilBertModel(cfg)
        params = jax.tree.map(jnp.asarray, port_distilbert(hf))
        return hf, flax_model, params

    def test_forward_parity(self, models):
        hf, flax_model, params = models
        rng = np.random.default_rng(1)
        ids = rng.integers(1, SMALL_TEXT["vocab_size"], size=(3, 12))
        lengths = np.array([12, 7, 4])
        mask = (np.arange(12)[None] < lengths[:, None]).astype(np.int64)
        with torch.no_grad():
            ref = hf(
                input_ids=torch.from_numpy(ids),
                attention_mask=torch.from_numpy(mask),
            ).last_hidden_state.numpy()
        ours = flax_model.apply(
            {"params": params}, jnp.asarray(ids), jnp.asarray(mask)
        )
        np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-4, atol=2e-5)

    def test_padding_positions_match_reference_behavior(self, models):
        """Changing a padded token id must not change valid positions
        (mask blocks attention to pads)."""
        hf, flax_model, params = models
        ids = np.full((1, 8), 5, np.int64)
        mask = np.array([[1, 1, 1, 1, 0, 0, 0, 0]], np.int64)
        out1 = flax_model.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
        ids2 = ids.copy()
        ids2[0, 6] = 9
        out2 = flax_model.apply({"params": params}, jnp.asarray(ids2), jnp.asarray(mask))
        np.testing.assert_allclose(out1[:, :4], out2[:, :4], atol=1e-6)


class TestDinoViTParity:
    @pytest.fixture(scope="class")
    def models(self):
        from transformers import Dinov2WithRegistersConfig as HFConfig
        from transformers import Dinov2WithRegistersModel as HFModel

        hf = HFModel(
            HFConfig(
                image_size=SMALL_VIT["image_size"],
                patch_size=SMALL_VIT["patch_size"],
                hidden_size=SMALL_VIT["hidden_size"],
                num_hidden_layers=SMALL_VIT["num_layers"],
                num_attention_heads=SMALL_VIT["num_heads"],
                num_register_tokens=SMALL_VIT["num_register_tokens"],
                mlp_ratio=4,
                layerscale_value=1.0,
            )
        ).eval()
        cfg = ViTConfig(**SMALL_VIT)
        return hf, cfg

    def test_forward_parity_no_lora(self, models):
        hf, cfg = models
        flax_model = DinoViT(cfg, use_lora=False)
        params = jax.tree.map(jnp.asarray, port_dinov2(hf, lora_rank=0))
        rng = np.random.default_rng(2)
        imgs = rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
        with torch.no_grad():
            ref = hf(
                pixel_values=torch.from_numpy(imgs.transpose(0, 3, 1, 2))
            ).last_hidden_state.numpy()
        ours = flax_model.apply({"params": params}, jnp.asarray(imgs))
        # HF last_hidden_state has the final layernorm applied, like ours.
        np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-4, atol=2e-5)

    def test_lora_starts_as_identity(self, models):
        """Freshly ported LoRA (B=0) must reproduce the base model."""
        hf, cfg = models
        base = DinoViT(cfg, use_lora=False)
        lora = DinoViT(cfg, use_lora=True)
        p_base = jax.tree.map(jnp.asarray, port_dinov2(hf, lora_rank=0))
        p_lora = jax.tree.map(jnp.asarray, port_dinov2(hf, lora_rank=cfg.lora_rank))
        rng = np.random.default_rng(3)
        imgs = jnp.asarray(rng.normal(size=(2, 28, 28, 3)).astype(np.float32))
        out_b = base.apply({"params": p_base}, imgs)
        out_l = lora.apply({"params": p_lora}, imgs)
        np.testing.assert_allclose(np.asarray(out_b), np.asarray(out_l), atol=1e-6)

    def test_patch_tokens_slice(self, models):
        """get_patch_tokens == get_intermediate_layers(x, 1)[0]: normed,
        patch tokens only (no CLS, no registers)."""
        hf, cfg = models
        flax_model = DinoViT(cfg, use_lora=False)
        params = jax.tree.map(jnp.asarray, port_dinov2(hf))
        rng = np.random.default_rng(4)
        imgs = rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
        tokens = flax_model.apply(
            {"params": params}, jnp.asarray(imgs),
            method=DinoViT.get_patch_tokens,
        )
        assert tokens.shape == (2, cfg.num_patches, cfg.hidden_size)
        with torch.no_grad():
            ref = hf(
                pixel_values=torch.from_numpy(imgs.transpose(0, 3, 1, 2))
            ).last_hidden_state.numpy()[:, 1 + cfg.num_register_tokens :]
        np.testing.assert_allclose(np.asarray(tokens), ref, rtol=1e-4, atol=2e-5)


class TestHubertParity:
    @pytest.fixture(scope="class")
    def models(self):
        from transformers import HubertConfig as HFConfig
        from transformers import HubertModel as HFModel

        hf = HFModel(
            HFConfig(
                hidden_size=SMALL_HUBERT["hidden_size"],
                num_hidden_layers=SMALL_HUBERT["num_layers"],
                num_attention_heads=SMALL_HUBERT["num_heads"],
                intermediate_size=SMALL_HUBERT["intermediate_size"],
                conv_dim=list(SMALL_HUBERT["conv_dim"]),
                conv_kernel=list(SMALL_HUBERT["conv_kernel"]),
                conv_stride=list(SMALL_HUBERT["conv_stride"]),
                num_feat_extract_layers=len(SMALL_HUBERT["conv_dim"]),
                num_conv_pos_embeddings=SMALL_HUBERT["num_conv_pos_embeddings"],
                num_conv_pos_embedding_groups=SMALL_HUBERT[
                    "num_conv_pos_embedding_groups"
                ],
                do_stable_layer_norm=False,
                feat_extract_norm="group",
                conv_bias=False,
            )
        ).eval()
        cfg = HubertConfig(**SMALL_HUBERT)
        flax_model = HubertModel(cfg)
        params = jax.tree.map(jnp.asarray, port_hubert(hf))
        return hf, flax_model, params, cfg

    def test_forward_parity(self, models):
        hf, flax_model, params, cfg = models
        rng = np.random.default_rng(5)
        audio = rng.normal(size=(2, 2000)).astype(np.float32)
        with torch.no_grad():
            ref = hf(torch.from_numpy(audio)).last_hidden_state.numpy()
        ours = flax_model.apply({"params": params}, jnp.asarray(audio))
        np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-3, atol=5e-5)

    def test_token_count_formula(self, models):
        _, flax_model, params, cfg = models
        audio = jnp.zeros((1, 2000))
        out = flax_model.apply({"params": params}, audio)
        assert out.shape[1] == cfg.num_audio_tokens(2000)

    def test_waveform_normalization_matches_hf_processor(self):
        """Per-padded-row zero-mean/unit-var (reference model.py:56-62)."""
        from transformers import Wav2Vec2FeatureExtractor

        proc = Wav2Vec2FeatureExtractor(
            do_normalize=True, return_attention_mask=True, feature_size=1,
            sampling_rate=16000, padding_value=0.0,
        )
        rng = np.random.default_rng(6)
        audio = rng.normal(size=(3, 1000)).astype(np.float32)
        audio[1, 600:] = 0.0  # pre-padded row, stats still over full row
        ref = proc(
            [a for a in audio], sampling_rate=16000, padding=True,
            return_tensors="np",
        ).input_values
        ours = normalize_waveform(jnp.asarray(audio))
        np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-4, atol=1e-5)


class TestFastVariants:
    @pytest.mark.slow
    def test_matmul_frontend_equals_conv(self):
        """frontend_impl='matmul' (im2col + one matmul) and
        'block_matmul' (contiguous-slice block matmuls) are numerically
        equivalent to the XLA conv path, sharing the same param layout."""
        import dataclasses
        cfg = HubertConfig(**SMALL_HUBERT)
        conv_model = HubertModel(cfg)
        rng = np.random.default_rng(7)
        audio = jnp.asarray(rng.normal(size=(2, 2000)).astype(np.float32))
        params = conv_model.init(jax.random.key(0), audio)["params"]
        out_conv = conv_model.apply({"params": params}, audio)
        for impl in ("matmul", "block_matmul"):
            alt = HubertModel(dataclasses.replace(cfg, frontend_impl=impl))
            out_alt = alt.apply({"params": params}, audio)
            np.testing.assert_allclose(
                np.asarray(out_alt), np.asarray(out_conv), rtol=1e-4,
                atol=1e-5, err_msg=impl,
            )

    def test_bf16_scores_attention_close_to_f32(self):
        from triad.models.layers import dot_product_attention

        rng = np.random.default_rng(8)
        q = jnp.asarray(rng.normal(size=(2, 10, 4, 8)).astype(np.float32))
        k = jnp.asarray(rng.normal(size=(2, 12, 4, 8)).astype(np.float32))
        v = jnp.asarray(rng.normal(size=(2, 12, 4, 8)).astype(np.float32))
        mask = jnp.asarray(
            (np.arange(12)[None] < np.array([[12], [7]])).astype(bool)
        )[:, None, None, :]
        f32 = dot_product_attention(q, k, v, mask, jnp.float32)
        bf = dot_product_attention(
            q.astype(jnp.bfloat16), k.astype(jnp.bfloat16),
            v.astype(jnp.bfloat16), mask, jnp.bfloat16,
            scores_dtype=jnp.bfloat16,
        )
        np.testing.assert_allclose(
            np.asarray(bf, np.float32), np.asarray(f32), atol=0.05
        )


class TestFlashAttention:
    def test_flash_matches_xla_with_padding_and_mask(self):
        """attention(impl="flash") (the Pallas kernel, interpret mode on
        CPU) == masked XLA softmax attention at a ragged length."""
        from triad.models.layers import attention

        B, N, H, D = 2, 37, 2, 16
        rng = np.random.default_rng(0)
        q, k, v = (
            jnp.asarray(rng.normal(size=(B, N, H, D)).astype(np.float32) * 0.3)
            for _ in range(3)
        )
        key_mask = jnp.asarray(
            (np.arange(N)[None, :] < np.array([[30], [37]])).astype(bool)
        )[:, None, None, :]

        ref = attention(q, k, v, key_mask, jnp.float32, impl="xla")
        out = attention(q, k, v, key_mask, jnp.float32, impl="flash")
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(ref), rtol=2e-5, atol=2e-5
        )


class TestLoRACompute:
    def test_folded_equals_separate(self):
        """lora_compute='folded' (x @ (W + s·A@B), one matmul) matches
        the peft-shaped 'separate' three-matmul form."""
        from triad.models.layers import LoRADense

        rng = np.random.default_rng(9)
        x = jnp.asarray(rng.normal(size=(3, 17, 32)).astype(np.float32))
        folded = LoRADense(24, rank=4, alpha=16.0, lora_compute="folded")
        separate = LoRADense(24, rank=4, alpha=16.0, lora_compute="separate")
        params = folded.init(jax.random.key(3), x)["params"]
        # B init is zeros (adapter no-op); perturb both factors so the
        # adapter actually contributes.
        params = dict(params)
        params["lora_a"] = jnp.asarray(
            rng.normal(size=params["lora_a"].shape).astype(np.float32) * 0.2
        )
        params["lora_b"] = jnp.asarray(
            rng.normal(size=params["lora_b"].shape).astype(np.float32) * 0.2
        )
        y_f = folded.apply({"params": params}, x)
        y_s = separate.apply({"params": params}, x)
        np.testing.assert_allclose(
            np.asarray(y_f), np.asarray(y_s), rtol=1e-5, atol=1e-5
        )
        # gradients agree too (the train path uses the same compute)
        g_f = jax.grad(lambda p: jnp.sum(folded.apply({"params": p}, x) ** 2))(
            params
        )
        g_s = jax.grad(lambda p: jnp.sum(separate.apply({"params": p}, x) ** 2))(
            params
        )
        for name in ("kernel", "bias", "lora_a", "lora_b"):
            np.testing.assert_allclose(
                np.asarray(g_f[name]), np.asarray(g_s[name]), rtol=1e-4,
                atol=1e-5, err_msg=name,
            )


class TestSpecAugment:
    """HF HuBERT applies SpecAugment time masking in train mode
    (modeling_hubert._mask_hidden_states; ACTIVE in the reference's
    training since model.train() keeps apply_spec_augment=True)."""

    def _model(self, **kw):
        from triad.core.config import HubertConfig
        from triad.models.hubert import HubertModel

        cfg = HubertConfig(
            hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64,
            conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            hidden_dropout=0.0, activation_dropout=0.0,
            attention_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
            **kw,
        )
        return HubertModel(cfg), cfg

    def test_eval_mode_unaffected(self):
        import jax
        import jax.numpy as jnp

        model, _ = self._model()
        audio = jnp.asarray(
            np.random.default_rng(0).normal(size=(2, 800)), jnp.float32
        )
        params = model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            audio, deterministic=True,
        )["params"]
        assert "masked_spec_embed" in params  # mask_time_prob > 0 default
        a = model.apply({"params": params}, audio, deterministic=True)
        b = model.apply({"params": params}, audio, deterministic=True)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_mask_fraction_and_replacement(self):
        """Direct check of the masking op: HF semantics — ~mask_prob of
        time steps replaced by the learned embed vector, span length L,
        at least min_masks spans."""
        import jax
        import jax.numpy as jnp

        from triad.models.hubert import _spec_augment_time_mask

        B, T, D = 16, 500, 8
        x = jnp.zeros((B, T, D), jnp.float32)
        embed = jnp.ones((D,), jnp.float32)
        out = np.asarray(
            _spec_augment_time_mask(
                x, embed, jax.random.key(0),
                mask_prob=0.05, mask_length=10, min_masks=2,
            )
        )
        masked = np.all(out == 1.0, axis=-1)  # (B, T)
        untouched = np.all(out == 0.0, axis=-1)
        assert np.all(masked | untouched)  # replaced or untouched, never mixed
        per_row = masked.sum(axis=1)
        # at least min_masks spans (overlap can reduce below 2*L only if
        # spans coincide; >= L always)
        assert np.all(per_row >= 10)
        # mean fraction in the right ballpark (5% target, span quantized)
        frac = masked.mean()
        assert 0.02 < frac < 0.15, f"masked fraction {frac}"

    def test_disabled_by_flag(self):
        import jax
        import jax.numpy as jnp

        model, _ = self._model(apply_spec_augment=False)
        audio = jnp.asarray(
            np.random.default_rng(0).normal(size=(2, 800)), jnp.float32
        )
        params = model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            audio, deterministic=True,
        )["params"]
        a = model.apply({"params": params}, audio, deterministic=True)
        b = model.apply(
            {"params": params}, audio, deterministic=False,
            rngs={"dropout": jax.random.key(3)},
        )
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)

    def test_zero_prob_has_no_param(self):
        import jax
        import jax.numpy as jnp

        model, _ = self._model(mask_time_prob=0.0)
        audio = jnp.zeros((1, 800), jnp.float32)
        params = model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)},
            audio, deterministic=True,
        )["params"]
        assert "masked_spec_embed" not in params


class TestPhaseFrontend:
    """frontend_impl='phase': pure-XLA phase-split matmul frontend must
    match the default conv path exactly at fp32 (same math, different
    schedule)."""

    @pytest.mark.slow
    def test_matches_conv_frontend(self):
        import dataclasses

        import jax
        import jax.numpy as jnp

        from triad.core.config import HubertConfig
        from triad.models.hubert import ConvFeatureEncoder

        base = HubertConfig()
        wave = jnp.asarray(
            np.random.default_rng(4).normal(size=(2, 16000)), jnp.float32
        )
        conv_fe = ConvFeatureEncoder(
            dataclasses.replace(base, frontend_impl="conv"),
            dtype=jnp.float32,
        )
        params = conv_fe.init(jax.random.key(0), wave)["params"]
        ref = np.asarray(conv_fe.apply({"params": params}, wave))
        phase_fe = ConvFeatureEncoder(
            dataclasses.replace(base, frontend_impl="phase"),
            dtype=jnp.float32,
        )
        got = np.asarray(phase_fe.apply({"params": params}, wave))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-5)

    @pytest.mark.slow
    def test_ragged_lengths(self):
        import dataclasses

        import jax
        import jax.numpy as jnp

        from triad.core.config import HubertConfig
        from triad.models.hubert import ConvFeatureEncoder

        base = HubertConfig()
        for t in (8000, 12345, 16331):
            wave = jnp.asarray(
                np.random.default_rng(t).normal(size=(1, t)), jnp.float32
            )
            conv_fe = ConvFeatureEncoder(
                dataclasses.replace(base, frontend_impl="conv"),
                dtype=jnp.float32,
            )
            params = conv_fe.init(jax.random.key(0), wave)["params"]
            # conv path consumes T % 10 != 0 tails; the phase path drops
            # them — compare on the 10-aligned prefix (token counts can
            # differ by at most one trailing token)
            ref = np.asarray(
                conv_fe.apply({"params": params}, wave[:, : t - t % 10])
            )
            phase_fe = ConvFeatureEncoder(
                dataclasses.replace(base, frontend_impl="phase"),
                dtype=jnp.float32,
            )
            got = np.asarray(phase_fe.apply({"params": params}, wave))
            n = min(got.shape[1], ref.shape[1])
            np.testing.assert_allclose(
                got[:, :n], ref[:, :n], atol=1e-5
            )
