"""The combined tri-modal model (reference MultiModalModel, model.py:331-353).

Three encoders project into a shared ``embedding_dim`` token space:

  visual: DINOv2 ViT-B/14+registers (LoRA) -> ProjectionHead -> patch dropout
          (model.py:346, 310-329)
  audio:  waveform normalize -> HuBERT-base -> ProjectionHead (model.py:43-70)
  text:   DistilBERT -> ProjectionHead, returns (feats, attention_mask)
          (model.py:93-118)

plus a learnable scalar ``temperature`` (model.py:348; trainer init 1.5,
train.py:239).

Unlike the reference (losses as model methods), the loss math lives in
``triad.ops`` as pure functions over these features — the model is
purely an encoder bank, which is what pjit/shard_map want to partition.

Dtype policy: backbones + projections run in ``cfg.compute_dtype``
(bf16 — the reference's autocast wraps the embedder calls including the
projections, model.py:483-485), parameters and loss math stay fp32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
from triad.core.config import ModelConfig
from triad.models import nn
from triad.models.distilbert import DistilBertModel
from triad.models.hubert import HubertModel, normalize_waveform
from triad.models.layers import ProjectionHead, patch_dropout_mask
from triad.models.vit import DinoViT
from triad.ops.similarity import pairwise_similarity


def _freeze_non_lora(variables):
    """stop_gradient on every non-LoRA leaf of the ViT base.

    The reference never optimizes the ViT base (train.py:296: no
    optimizer for vit_params; requires_grad=False means torch never
    computes their weight gradients either). stop_gradient makes XLA
    drop those dW matmuls from the backward — pure win; LoRA factors
    keep full gradients.
    """
    flat = nn.flatten_dict(variables)
    out = {
        k: (v if "lora" in k[-1] else jax.lax.stop_gradient(v))
        for k, v in flat.items()
    }
    return nn.unflatten_dict(out)


class TriadModel(nn.Module):
    cfg: ModelConfig

    def setup(self):
        c = self.cfg
        dtype = jnp.dtype(c.compute_dtype)
        param_dtype = jnp.dtype(c.param_dtype)
        frozen_vit_cls = nn.map_variables(DinoViT, _freeze_non_lora)
        self.visual_backbone = frozen_vit_cls(
            c.vit, use_lora=True, dtype=dtype, param_dtype=param_dtype,
            name="visual_backbone",
        )
        self.visual_projection = ProjectionHead(
            c.embedding_dim, dtype=dtype, param_dtype=param_dtype,
            name="visual_projection",
        )
        self.audio_backbone = HubertModel(
            c.hubert, dtype=dtype, param_dtype=param_dtype, name="audio_backbone"
        )
        self.audio_projection = ProjectionHead(
            c.embedding_dim, dtype=dtype, param_dtype=param_dtype,
            name="audio_projection",
        )
        self.text_backbone = DistilBertModel(
            c.text, dtype=dtype, param_dtype=param_dtype, name="text_backbone"
        )
        self.text_projection = ProjectionHead(
            c.embedding_dim, dtype=dtype, param_dtype=param_dtype,
            name="text_projection",
        )
        self.temperature = self.param(
            "temperature",
            lambda _: jnp.asarray(c.temperature_init, jnp.float32),
        )

    # -- encoders -------------------------------------------------------

    def encode_visual(self, images: jax.Array, train: bool = False) -> jax.Array:
        """images (B, H, W, 3) -> (B, Nv, D) projected patch tokens.

        Training applies patch dropout after projection (model.py:327):
        dropped tokens are zeroed (shape-static analog of the
        reference's physical removal + zero re-padding; see
        layers.patch_dropout_mask).
        """
        patches = self.visual_backbone.get_patch_tokens(images)
        feats = self.visual_projection(patches)
        rate = self.cfg.visual_dropout_prob
        if train and rate > 0:
            rng = self.make_rng("dropout")
            keep = patch_dropout_mask(rng, feats.shape[:2], rate)
            feats = feats * keep[..., None].astype(feats.dtype)
        return feats

    def encode_audio(self, audio: jax.Array, train: bool = False) -> jax.Array:
        """audio (B, T) raw 16 kHz waveform -> (B, Na, D)."""
        if self.cfg.hubert.normalize_waveform:
            audio = normalize_waveform(audio)
        hidden = self.audio_backbone(audio, deterministic=not train)
        return self.audio_projection(hidden)

    def encode_text(
        self, token_ids: jax.Array, attention_mask: jax.Array, train: bool = False
    ) -> jax.Array:
        """token_ids, attention_mask (B, Nt) -> (B, Nt, D)."""
        hidden = self.text_backbone(
            token_ids, attention_mask, deterministic=not train
        )
        return self.text_projection(hidden)

    # -- combined forwards ---------------------------------------------

    def __call__(
        self,
        images: jax.Array,
        audio: jax.Array,
        token_ids: jax.Array,
        attention_mask: jax.Array,
        train: bool = False,
    ) -> Dict[str, jax.Array]:
        """Tri-modal forward producing all projected features (used for
        init and the generic inference surface)."""
        return {
            "visual": self.encode_visual(images, train=train),
            "audio": self.encode_audio(audio, train=train),
            "text": self.encode_text(token_ids, attention_mask, train=train),
        }

    def inference_forward(
        self,
        images: Optional[jax.Array] = None,
        audio: Optional[jax.Array] = None,
        token_ids: Optional[jax.Array] = None,
        attention_mask: Optional[jax.Array] = None,
    ) -> Dict[str, jax.Array]:
        """The reference's generic ``forward`` (model.py:610-637): any
        subset of modalities -> features + normalized pairwise sim
        matrices, including the tri-modal text<->audio surface
        (model.py:631-636)."""
        if images is None and audio is None and token_ids is None:
            raise ValueError("At least one modality must be provided")
        out: Dict[str, jax.Array] = {}
        if images is not None:
            out["visual_feats"] = self.encode_visual(images)
        if audio is not None:
            out["audio_feats"] = self.encode_audio(audio)
        if token_ids is not None:
            out["text_feats"] = self.encode_text(token_ids, attention_mask)
        t = self.temperature
        if "visual_feats" in out and "text_feats" in out:
            out["vis_text_sim_matrix"] = pairwise_similarity(
                out["text_feats"], out["visual_feats"], t
            )
        if "visual_feats" in out and "audio_feats" in out:
            out["vis_audio_sim_matrix"] = pairwise_similarity(
                out["audio_feats"], out["visual_feats"], t
            )
        if "audio_feats" in out and "text_feats" in out:
            out["text_audio_sim_matrix"] = pairwise_similarity(
                out["text_feats"], out["audio_feats"], t
            )
        return out


def init_triad_model(
    cfg: ModelConfig, rng: jax.Array, data_cfg=None
) -> Dict[str, Any]:
    """Initialize a TriadModel param tree with tiny dummy shapes (shapes
    don't affect params — all modules are length-agnostic)."""
    model = TriadModel(cfg)
    img = jnp.zeros((1, cfg.vit.image_size, cfg.vit.image_size, 3), jnp.float32)
    # Smallest waveform the conv stack supports.
    min_t = 1
    for k, s in zip(cfg.hubert.conv_kernel, cfg.hubert.conv_stride):
        min_t = (min_t - 1) * s + k
    audio = jnp.zeros((1, min_t), jnp.float32)
    ids = jnp.zeros((1, 4), jnp.int32)
    mask = jnp.ones((1, 4), jnp.int32)
    variables = model.init(
        {"params": rng, "dropout": rng}, img, audio, ids, mask, train=False
    )
    return variables["params"]
