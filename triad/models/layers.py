"""Shared building blocks for the triad encoders.

Everything is written mask-first and fixed-shape (XLA requirement), with a
``dtype`` knob implementing the reference's bf16-autocast-for-encoders
policy (reference model.py:483-485, 603-605): parameters stay fp32
(``param_dtype``), activations/matmuls run in ``dtype``.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from triad.models import nn

Dtype = Any


ATTENTION_IMPLS = ("xla", "flash", "cudnn")


def _dropout_seed(dropout_rng: jax.Array) -> jax.Array:
    """int32 kernel seed from a JAX PRNG key."""
    return jax.random.randint(
        dropout_rng, (), minval=0, maxval=jnp.iinfo(jnp.int32).max,
        dtype=jnp.int32,
    )


def dot_product_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    mask: Optional[jax.Array],
    dtype: Dtype,
    scores_dtype: Dtype = jnp.float32,
    probs_dropout=None,
) -> jax.Array:
    """Standard softmax attention, as XLA compiles it.

    q, k, v: (B, N, H, Dh). mask: optional (B, 1, 1, Nk) boolean mask
    (True = attend).

    scores_dtype float32 (default): fp32 scores + softmax — the
    reference's autocast behavior (torch softmax promotes to fp32).
    scores_dtype bfloat16: scores stay bf16 with a max-subtracted exp
    (half the score-matrix traffic); output differs at bf16 rounding.
    """
    depth = q.shape[-1]
    scale = jnp.asarray(1.0 / jnp.sqrt(depth), dtype)
    if jnp.dtype(scores_dtype) == jnp.float32:
        scores = jnp.einsum("bqhd,bkhd->bhqk", q * scale, k)
        scores = scores.astype(jnp.float32)
        if mask is not None:
            scores = jnp.where(mask, scores, jnp.finfo(jnp.float32).min)
        probs = jax.nn.softmax(scores, axis=-1).astype(dtype)
        if probs_dropout is not None:
            probs = probs_dropout(probs)
        return jnp.einsum("bhqk,bkhd->bqhd", probs, v)
    scores = jnp.einsum(
        "bqhd,bkhd->bhqk", q * scale, k, preferred_element_type=scores_dtype
    )
    if mask is not None:
        scores = jnp.where(mask, scores, jnp.asarray(-1e4, scores_dtype))
    m = jax.lax.stop_gradient(jnp.max(scores, axis=-1, keepdims=True))
    e = jnp.exp((scores - m).astype(jnp.float32)).astype(dtype)
    probs = e / jnp.sum(e, axis=-1, keepdims=True).astype(dtype)
    if probs_dropout is not None:
        probs = probs_dropout(probs)
    return jnp.einsum("bhqk,bkhd->bqhd", probs, v)


def over_batch(fn, batched, shared=()):
    """``fn(offset, *batched, *shared)``, split over the batch under a mesh.

    Inside a multi-device abstract mesh context (the train step's, see
    StepFactory.mesh_context), ``fn`` runs under shard_map: ``batched``
    arrays are split along dim 0 over every mesh axis, ``shared`` ones
    replicated, and ``offset`` is the global index of the shard's first
    row (0 outside a mesh). For per-example ops that the GSPMD
    partitioner would not split by batch on its own: a pallas_call is
    opaque to it, and for a grouped convolution it gathers the batch.
    """
    mesh = jax.sharding.get_abstract_mesh()
    if mesh.empty or mesh.size == 1 or batched[0].shape[0] % mesh.size:
        # No mesh, or a batch the mesh cannot split (an eval batch that
        # the caller keeps replicated): the op runs whole.
        return fn(0, *batched, *shared)
    axes = tuple(mesh.axis_names)

    def local(*args):
        return fn(jax.lax.axis_index(axes) * args[0].shape[0], *args)

    specs = (P(axes),) * len(batched) + (P(),) * len(shared)
    return jax.shard_map(local, mesh=mesh, in_specs=specs, out_specs=P(axes),
                         check_vma=False)(*batched, *shared)


def _flash(q, k, v, key_mask, rate: float, seed) -> jax.Array:
    """ops.flash_attention, split over the batch under a mesh. Each shard
    draws the dropout mask of its global batch rows, so the split run
    masks exactly as the whole batch would."""
    from triad.ops.flash_attention import flash_attention

    def fn(offset, q, k, v, *rest):
        *key_mask, seed = rest
        return flash_attention(
            q, k, v, key_mask[0] if key_mask else None, dropout_rate=rate,
            seed=seed, batch_offset=offset,
        )

    batched = (q, k, v) + (() if key_mask is None else (key_mask,))
    return over_batch(fn, batched, (seed,))


def attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    mask: Optional[jax.Array],
    dtype: Dtype,
    *,
    impl: str,
    scores_dtype: Dtype = jnp.float32,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[jax.Array] = None,
) -> jax.Array:
    """The encoders' one attention dispatch point, chosen by config.

    q, k, v: (B, N, H, Dh); mask: optional (B, 1, 1, Nk) boolean key
    mask (True = attend). Dropout on the probabilities is live when
    ``dropout_rate > 0`` and a ``dropout_rng`` is given.

    impl:
      "xla"   — the plain softmax path above (the parity reference;
                dropout materializes a (B, H, N, N) mask);
      "flash" — ops.flash_attention, the Pallas/Triton kernel with
                dropout drawn inside the kernel;
      "cudnn" — cuDNN's fused attention (jax.nn.dot_product_attention),
                for paths without live dropout: it takes dropout only
                with a static seed. What cuDNN refuses raises: on the
                H100 that is the training pass (forward with backward)
                at the odd lengths 499 and 261, and a (B, 1, 1, N) key
                mask (PERF.md).
    """
    live = dropout_rate > 0.0 and dropout_rng is not None
    if impl == "xla":
        probs_dropout = None
        if live:
            keep_prob = 1.0 - dropout_rate

            def probs_dropout(p):
                keep = jax.random.bernoulli(dropout_rng, keep_prob, p.shape)
                return jax.lax.select(keep, p / keep_prob, jnp.zeros_like(p))

        return dot_product_attention(
            q, k, v, mask, dtype, scores_dtype=scores_dtype,
            probs_dropout=probs_dropout,
        )
    if impl == "flash":
        b, n = q.shape[:2]
        key_mask = None if mask is None else mask.reshape(b, n)
        seed = _dropout_seed(dropout_rng) if live else jnp.zeros((), jnp.int32)
        q, k, v = (x.astype(dtype) for x in (q, k, v))
        return _flash(q, k, v, key_mask, dropout_rate if live else 0.0, seed)
    if impl == "cudnn":
        if live:
            raise ValueError(
                "attention_impl 'cudnn' cannot draw per-step dropout; "
                "use 'flash' or 'xla' where attention dropout is live"
            )

        def fn(offset, q, k, v, *mask):
            return jax.nn.dot_product_attention(
                q, k, v, mask=mask[0] if mask else None,
                implementation="cudnn",
            )

        q, k, v = (x.astype(dtype) for x in (q, k, v))
        return over_batch(fn, (q, k, v) + (() if mask is None else (mask,)))
    raise ValueError(
        f"unknown attention impl {impl!r} (expected one of {ATTENTION_IMPLS})"
    )


class LoRADense(nn.Module):
    """Dense layer with an optional LoRA adapter: y = xW + b + (α/r)·xAB.

    Mirrors peft LoRA on the reference ViT (model.py:235-248: r=8, α=16,
    dropout 0, applied to the fused qkv and the attention output proj).
    A is He-uniform initialized, B zeros, so the adapter starts as a
    no-op (peft default init).
    """

    features: int
    rank: int = 0
    alpha: float = 16.0
    use_bias: bool = True
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32
    # "folded" (default): y = x @ (W + s·A@B) — the adapter is merged
    # into the base kernel each call (one 768x768xR matmul, ~10 MFLOP)
    # so the activation makes ONE pass through a matmul instead of three.
    # "separate": peft-shaped x@W + s·(x@A)@B (bit-parity with torch
    # peft; fp32 association differences are ~1e-6).
    lora_compute: str = "folded"

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        in_features = x.shape[-1]
        kernel = self.param(
            "kernel",
            nn.initializers.lecun_normal(),
            (in_features, self.features),
            self.param_dtype,
        )
        lora_a = lora_b = None
        if self.rank > 0:
            lora_a = self.param(
                "lora_a",
                nn.initializers.he_uniform(),
                (in_features, self.rank),
                self.param_dtype,
            )
            lora_b = self.param(
                "lora_b",
                nn.initializers.zeros,
                (self.rank, self.features),
                self.param_dtype,
            )
        if self.rank > 0 and self.lora_compute == "folded":
            scaling = jnp.asarray(self.alpha / self.rank, self.param_dtype)
            w = kernel + scaling * jnp.dot(lora_a, lora_b)
            y = jnp.dot(x, w.astype(self.dtype))
        else:
            y = jnp.dot(x, kernel.astype(self.dtype))
            if self.rank > 0:
                scaling = jnp.asarray(self.alpha / self.rank, self.dtype)
                y = y + scaling * jnp.dot(
                    jnp.dot(x, lora_a.astype(self.dtype)),
                    lora_b.astype(self.dtype),
                )
        if self.use_bias:
            bias = self.param(
                "bias", nn.initializers.zeros, (self.features,), self.param_dtype
            )
            y = y + bias.astype(self.dtype)
        return y


class Mlp(nn.Module):
    """Transformer FFN: Dense -> GELU -> Dense."""

    hidden_features: int
    out_features: int
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32
    # HF-style "exact" gelu vs tanh approximation; all three reference
    # backbones use exact gelu.
    approximate_gelu: bool = False

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        x = nn.Dense(
            self.hidden_features, dtype=self.dtype, param_dtype=self.param_dtype,
            name="fc1",
        )(x)
        x = nn.gelu(x, approximate=self.approximate_gelu)
        x = nn.Dense(
            self.out_features, dtype=self.dtype, param_dtype=self.param_dtype,
            name="fc2",
        )(x)
        return x


class ProjectionHead(nn.Module):
    """The reference's shared projection pattern (model.py:32-34, 81-83,
    253-255): Linear(hidden -> 512) -> LayerNorm -> Linear(512 -> 512).

    LayerNorm eps matches torch's default (1e-5).
    """

    embedding_dim: int = 512
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        x = nn.Dense(
            self.embedding_dim, dtype=self.dtype, param_dtype=self.param_dtype,
            name="projection1",
        )(x)
        x = nn.LayerNorm(
            epsilon=1e-5, dtype=self.dtype, param_dtype=self.param_dtype,
            name="layer_norm",
        )(x)
        x = nn.Dense(
            self.embedding_dim, dtype=self.dtype, param_dtype=self.param_dtype,
            name="projection2",
        )(x)
        return x


def patch_dropout_mask(
    rng: jax.Array, shape: tuple, drop_rate: float
) -> jax.Array:
    """Bernoulli keep-mask for token dropout.

    Shape-static analog of the reference's physical token removal
    (model.py:268-308): instead of gathering kept tokens per sample and
    re-padding to the ragged batch max (shape-dynamic), we zero dropped
    tokens. Under max-mean aggregation a zero token contributes sim 0,
    exactly like the reference's zero-padding rows; eval mode is
    identical (dropout off, model.py:275).
    """
    return jax.random.bernoulli(rng, 1.0 - drop_rate, shape)
