"""Tests for the combined TriadModel: shapes, determinism, patch dropout,
the generic inference surface, and end-to-end loss computation."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from triad.core.config import (
    DistilBertConfig,
    HubertConfig,
    LossConfig,
    ModelConfig,
    ViTConfig,
)
from triad.models import TriadModel, init_triad_model
from triad.ops import av_loss, tv_loss


def small_model_config(**kw):
    return ModelConfig(
        embedding_dim=32,
        compute_dtype="float32",
        vit=ViTConfig(
            image_size=28, patch_size=14, hidden_size=32, num_layers=2,
            num_heads=4,
        ),
        hubert=HubertConfig(
            hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        ),
        text=DistilBertConfig(
            vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=64,
        ),
        **kw,
    )


@pytest.fixture(scope="module")
def model_and_params():
    cfg = small_model_config()
    params = init_triad_model(cfg, jax.random.key(0))
    return TriadModel(cfg), params, cfg


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return {
        "images": jnp.asarray(rng.normal(size=(2, 28, 28, 3)).astype(np.float32)),
        "audio": jnp.asarray(rng.normal(size=(2, 1600)).astype(np.float32)),
        "ids": jnp.asarray(rng.integers(1, 100, size=(2, 8))),
        "mask": jnp.asarray(
            np.array([[1] * 8, [1] * 5 + [0] * 3], dtype=np.float32)
        ),
    }


class TestTriadModel:
    def test_shapes(self, model_and_params, batch):
        model, params, cfg = model_and_params
        out = model.apply(
            {"params": params}, batch["images"], batch["audio"], batch["ids"],
            batch["mask"],
        )
        assert out["visual"].shape == (2, 4, 32)  # 28/14 -> 2x2 patches
        na = cfg.hubert.num_audio_tokens(1600)
        assert out["audio"].shape == (2, na, 32)
        assert out["text"].shape == (2, 8, 32)

    def test_eval_deterministic(self, model_and_params, batch):
        model, params, _ = model_and_params
        f = lambda: model.apply(
            {"params": params}, batch["images"], batch["audio"], batch["ids"],
            batch["mask"], train=False,
        )
        out1, out2 = f(), f()
        for k in out1:
            np.testing.assert_array_equal(np.asarray(out1[k]), np.asarray(out2[k]))

    def test_patch_dropout_zeroes_tokens_in_train(self, batch):
        cfg = small_model_config(visual_dropout_prob=0.5)
        params = init_triad_model(cfg, jax.random.key(0))
        model = TriadModel(cfg)
        feats = model.apply(
            {"params": params}, batch["images"],
            train=True, method=TriadModel.encode_visual,
            rngs={"dropout": jax.random.key(7)},
        )
        token_norms = np.asarray(jnp.linalg.norm(feats, axis=-1))
        assert (token_norms == 0).any(), "some tokens must be dropped"
        assert (token_norms > 0).any(), "some tokens must survive"
        # Eval mode: no dropout.
        feats_eval = model.apply(
            {"params": params}, batch["images"],
            train=False, method=TriadModel.encode_visual,
        )
        assert (np.asarray(jnp.linalg.norm(feats_eval, axis=-1)) > 0).all()

    def test_inference_forward_trimodal(self, model_and_params, batch):
        model, params, _ = model_and_params
        out = model.apply(
            {"params": params},
            images=batch["images"], audio=batch["audio"],
            token_ids=batch["ids"], attention_mask=batch["mask"],
            method=TriadModel.inference_forward,
        )
        assert "vis_text_sim_matrix" in out
        assert "vis_audio_sim_matrix" in out
        assert "text_audio_sim_matrix" in out  # tri-modal surface
        nt, nv = out["text_feats"].shape[1], out["visual_feats"].shape[1]
        assert out["vis_text_sim_matrix"].shape == (2, nt, nv)

    def test_inference_forward_requires_a_modality(self, model_and_params):
        model, params, _ = model_and_params
        with pytest.raises(ValueError):
            model.apply({"params": params}, method=TriadModel.inference_forward)

    @pytest.mark.slow
    def test_end_to_end_losses_finite_and_grad_flows(self, model_and_params, batch):
        model, params, cfg = model_and_params
        lcfg = LossConfig()

        def loss_fn(p):
            out = model.apply(
                {"params": p}, batch["images"], batch["audio"], batch["ids"],
                batch["mask"], train=True, rngs={"dropout": jax.random.key(0)},
            )
            temp = p["temperature"]
            av = av_loss(out["audio"], out["visual"], temp, lcfg)
            tv = tv_loss(out["text"], out["visual"], batch["mask"], temp, lcfg)
            return av.total + tv.total

        loss, grads = jax.value_and_grad(loss_fn)(params)
        assert np.isfinite(float(loss))
        gnorm = jnp.sqrt(
            sum(jnp.sum(g * g) for g in jax.tree.leaves(grads))
        )
        assert np.isfinite(float(gnorm)) and float(gnorm) > 0
        # temperature must receive gradient (it is a live parameter)
        assert float(jnp.abs(grads["temperature"])) > 0


def test_train_mode_dropouts_are_stochastic(model_and_params, batch):
    """HF-style dropouts (hubert hidden/attention/activation + layerdrop,
    distilbert dropout) are active in train mode and keyed by the rng."""
    model, params, _ = model_and_params
    out1 = model.apply(
        {"params": params}, batch["audio"], train=True,
        method=TriadModel.encode_audio, rngs={"dropout": jax.random.key(1)},
    )
    out2 = model.apply(
        {"params": params}, batch["audio"], train=True,
        method=TriadModel.encode_audio, rngs={"dropout": jax.random.key(2)},
    )
    assert np.abs(np.asarray(out1) - np.asarray(out2)).max() > 1e-6
    # eval mode: identical regardless of rng
    e1 = model.apply(
        {"params": params}, batch["audio"], train=False,
        method=TriadModel.encode_audio,
    )
    e2 = model.apply(
        {"params": params}, batch["audio"], train=False,
        method=TriadModel.encode_audio,
    )
    np.testing.assert_array_equal(np.asarray(e1), np.asarray(e2))
