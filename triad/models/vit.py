"""DINOv2 ViT-B/14 with register tokens and LoRA adapters.

Reference vision backbone: ``torch.hub dinov2_vitb14_reg`` wrapped in peft
LoRA (reference model.py:207-329). This is a from-scratch JAX
implementation matching the DINOv2 computation graph (verified against HF
``Dinov2WithRegistersModel``, which mirrors the facebookresearch code):

  patch conv (14x14 s14) -> [cls | registers | patches+pos] -> 12 pre-LN
  blocks with LayerScale -> final LayerNorm

``get_patch_tokens`` reproduces ``get_intermediate_layers(x, n=1)[0]``
(reference model.py:325): final-norm applied, patch tokens only (no
CLS/registers).

LoRA (reference model.py:227-248): rank-8, alpha-16 adapters on the
**fused** qkv projection and the attention output projection, base model
frozen. The fused-qkv structure matters — peft's rank-8 adapter on the
fused 768->2304 qkv is not the same function class as three rank-8
adapters on separate q/k/v — so attention here uses a single fused qkv
Dense, and weight porting fuses HF's separate q/k/v.

Images are NHWC (channels-last); ``triad.data`` converts from the
reference's NCHW at the host boundary.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from triad.core.config import ViTConfig
from triad.models import nn
from triad.models.layers import LoRADense, Mlp, attention

Dtype = Any


class LayerScale(nn.Module):
    dim: int
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        gamma = self.param(
            "gamma", nn.initializers.ones, (self.dim,), self.param_dtype
        )
        return x * gamma.astype(self.dtype)


class ViTAttention(nn.Module):
    """Fused-qkv multi-head attention with optional LoRA on qkv + proj."""

    cfg: ViTConfig
    use_lora: bool = True
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        c = self.cfg
        B, N, D = x.shape
        head_dim = c.hidden_size // c.num_heads
        rank = c.lora_rank if self.use_lora else 0
        qkv = LoRADense(
            3 * c.hidden_size, rank=rank, alpha=c.lora_alpha,
            use_bias=c.qkv_bias, dtype=self.dtype, param_dtype=self.param_dtype,
            lora_compute=c.lora_compute, name="qkv",
        )(x)
        # Split along the LAST dim: reshaping to (B, N, 3, H, Dh) and
        # slicing axis 2 makes XLA materialize layout copies of the qkv
        # tensor; last-dim slices are free.
        h = c.hidden_size
        q = qkv[..., 0 * h : 1 * h].reshape(B, N, c.num_heads, head_dim)
        k = qkv[..., 1 * h : 2 * h].reshape(B, N, c.num_heads, head_dim)
        v = qkv[..., 2 * h : 3 * h].reshape(B, N, c.num_heads, head_dim)
        # DINOv2 has no attention dropout.
        out = attention(
            q, k, v, None, self.dtype, impl=c.attention_impl,
            scores_dtype=jnp.dtype(c.attention_scores_dtype),
        )
        out = out.reshape(B, N, D)
        return LoRADense(
            c.hidden_size, rank=rank, alpha=c.lora_alpha,
            dtype=self.dtype, param_dtype=self.param_dtype,
            lora_compute=c.lora_compute, name="proj",
        )(out)


class ViTBlock(nn.Module):
    cfg: ViTConfig
    use_lora: bool = True
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        c = self.cfg
        h = nn.LayerNorm(
            epsilon=c.layer_norm_eps, dtype=self.dtype, param_dtype=self.param_dtype,
            name="norm1",
        )(x)
        h = ViTAttention(
            c, use_lora=self.use_lora, dtype=self.dtype,
            param_dtype=self.param_dtype, name="attn",
        )(h)
        h = LayerScale(
            c.hidden_size, dtype=self.dtype, param_dtype=self.param_dtype, name="ls1"
        )(h)
        x = x + h
        h = nn.LayerNorm(
            epsilon=c.layer_norm_eps, dtype=self.dtype, param_dtype=self.param_dtype,
            name="norm2",
        )(x)
        h = Mlp(
            int(c.hidden_size * c.mlp_ratio), c.hidden_size,
            dtype=self.dtype, param_dtype=self.param_dtype, name="mlp",
        )(h)
        h = LayerScale(
            c.hidden_size, dtype=self.dtype, param_dtype=self.param_dtype, name="ls2"
        )(h)
        return x + h


class DinoViT(nn.Module):
    """DINOv2 ViT with register tokens.

    ``__call__(images)`` with images (B, H, W, 3) returns the full normed
    token sequence (B, 1 + R + P, D); ``get_patch_tokens`` slices the
    patch tokens (the reference's only consumed surface, model.py:325).
    """

    cfg: ViTConfig
    use_lora: bool = True
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, images: jax.Array) -> jax.Array:
        c = self.cfg
        B = images.shape[0]
        x = nn.Conv(
            c.hidden_size,
            kernel_size=(c.patch_size, c.patch_size),
            strides=(c.patch_size, c.patch_size),
            padding="VALID",
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            name="patch_embed",
        )(images.astype(self.dtype))
        x = x.reshape(B, -1, c.hidden_size)  # (B, P, D), row-major patches

        cls_token = self.param(
            "cls_token", nn.initializers.zeros, (1, 1, c.hidden_size),
            self.param_dtype,
        )
        register_tokens = self.param(
            "register_tokens",
            nn.initializers.zeros,
            (1, c.num_register_tokens, c.hidden_size),
            self.param_dtype,
        )
        pos_embed = self.param(
            "pos_embed",
            nn.initializers.normal(0.02),
            (1, 1 + c.num_patches, c.hidden_size),
            self.param_dtype,
        )
        cls = jnp.broadcast_to(
            cls_token.astype(self.dtype), (B, 1, c.hidden_size)
        )
        x = jnp.concatenate([cls, x], axis=1) + pos_embed.astype(self.dtype)
        # Register tokens are inserted between CLS and patches and carry
        # no positional embedding (DINOv2-with-registers order).
        regs = jnp.broadcast_to(
            register_tokens.astype(self.dtype),
            (B, c.num_register_tokens, c.hidden_size),
        )
        x = jnp.concatenate([x[:, :1], regs, x[:, 1:]], axis=1)

        for i in range(c.num_layers):
            x = ViTBlock(
                c, use_lora=self.use_lora, dtype=self.dtype,
                param_dtype=self.param_dtype, name=f"block_{i}",
            )(x)
        x = nn.LayerNorm(
            epsilon=c.layer_norm_eps, dtype=self.dtype, param_dtype=self.param_dtype,
            name="norm",
        )(x)
        return x

    def get_patch_tokens(self, images: jax.Array) -> jax.Array:
        """Equivalent of DINOv2 ``get_intermediate_layers(x, n=1)[0]``:
        normed last-block output, patch tokens only (B, P, D)."""
        tokens = self(images)
        return tokens[:, 1 + self.cfg.num_register_tokens :]
