"""DistilBERT encoder (reference text backbone, model.py:79-80 with
``distilbert/distilbert-base-uncased``, model.py:335/train.py:238).

A from-scratch JAX implementation matching the HF ``DistilBertModel``
computation graph so pretrained weights port 1:1
(triad.models.weights.port_distilbert):

  embeddings: word + learned-position embeddings, LayerNorm(1e-12), dropout
  6 post-LN transformer blocks: MHA -> LN(x+attn) -> FFN -> LN(x+ffn)
  padding mask applied to attention scores (never attends to pad keys)
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
from triad.core.config import DistilBertConfig
from triad.models import nn
from triad.models.layers import Mlp, attention

Dtype = Any


class DistilBertAttention(nn.Module):
    cfg: DistilBertConfig
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self, x: jax.Array, attn_mask: Optional[jax.Array],
        deterministic: bool = True,
    ) -> jax.Array:
        c = self.cfg
        head_dim = c.hidden_size // c.num_heads
        dense = lambda name: nn.Dense(
            c.hidden_size, dtype=self.dtype, param_dtype=self.param_dtype, name=name
        )
        q = dense("q_lin")(x).reshape(*x.shape[:2], c.num_heads, head_dim)
        k = dense("k_lin")(x).reshape(*x.shape[:2], c.num_heads, head_dim)
        v = dense("v_lin")(x).reshape(*x.shape[:2], c.num_heads, head_dim)
        mask = None
        if attn_mask is not None:
            # (B, Nk) -> (B, 1, 1, Nk); True = attend.
            mask = attn_mask.astype(bool)[:, None, None, :]
        # HF DistilBERT drops attention weights (attention_dropout).
        rate = 0.0 if deterministic else c.attention_dropout
        out = attention(
            q, k, v, mask, self.dtype, impl=c.attention_impl,
            scores_dtype=jnp.dtype(c.attention_scores_dtype),
            dropout_rate=rate,
            dropout_rng=self.make_rng("dropout") if rate > 0 else None,
        )
        out = out.reshape(*x.shape[:2], c.hidden_size)
        return dense("out_lin")(out)


class DistilBertBlock(nn.Module):
    cfg: DistilBertConfig
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self, x: jax.Array, attn_mask: Optional[jax.Array],
        deterministic: bool = True,
    ) -> jax.Array:
        c = self.cfg
        attn_out = DistilBertAttention(
            c, dtype=self.dtype, param_dtype=self.param_dtype, name="attention"
        )(x, attn_mask, deterministic=deterministic)
        x = nn.LayerNorm(
            epsilon=c.layer_norm_eps, dtype=self.dtype, param_dtype=self.param_dtype,
            name="sa_layer_norm",
        )(x + attn_out)
        ffn_out = Mlp(
            c.intermediate_size, c.hidden_size, dtype=self.dtype,
            param_dtype=self.param_dtype, name="ffn",
        )(x)
        # HF DistilBERT FFN ends with dropout before the residual.
        ffn_out = nn.Dropout(c.dropout, name="ffn_dropout")(
            ffn_out, deterministic=deterministic
        )
        x = nn.LayerNorm(
            epsilon=c.layer_norm_eps, dtype=self.dtype, param_dtype=self.param_dtype,
            name="output_layer_norm",
        )(x + ffn_out)
        return x


class DistilBertModel(nn.Module):
    """Returns last_hidden_state (B, N, hidden)."""

    cfg: DistilBertConfig
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        input_ids: jax.Array,
        attention_mask: Optional[jax.Array] = None,
        deterministic: bool = True,
    ) -> jax.Array:
        c = self.cfg
        word_emb = self.param(
            "word_embeddings",
            nn.initializers.normal(0.02),
            (c.vocab_size, c.hidden_size),
            self.param_dtype,
        )
        pos_emb = self.param(
            "position_embeddings",
            nn.initializers.normal(0.02),
            (c.max_position_embeddings, c.hidden_size),
            self.param_dtype,
        )
        n = input_ids.shape[1]
        x = word_emb[input_ids] + pos_emb[None, :n]
        x = x.astype(self.dtype)
        x = nn.LayerNorm(
            epsilon=c.layer_norm_eps, dtype=self.dtype, param_dtype=self.param_dtype,
            name="emb_layer_norm",
        )(x)
        # HF DistilBERT embeddings dropout shares config.dropout (was
        # hard-coded 0.1 — caught by the e2e train-parity harness).
        x = nn.Dropout(c.dropout)(x, deterministic=deterministic)
        for i in range(c.num_layers):
            x = DistilBertBlock(
                c, dtype=self.dtype, param_dtype=self.param_dtype, name=f"layer_{i}"
            )(x, attention_mask, deterministic=deterministic)
        return x
