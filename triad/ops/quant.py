"""int8 quantized matmul path for serving/eval (opt-in).

Tensor cores run int8 x int8 -> int32 at 2x the bf16 peak (H100:
1,979 vs 989 TOPS, NVIDIA's data sheet); this module provides the
dynamic-quantization
building blocks used by ``triad.models.quantize`` to run the whole
eval forward with every Dense matmul in int8:

* weights: symmetric per-output-channel scales (max-abs / 127),
  quantized on the fly — the quantize cost is O(K*N) against the
  matmul's O(M*K*N), <0.01% at eval shapes, and keeps the checkpoint
  format unchanged;
* activations: symmetric per-row (per-token) dynamic scales.

The judged benchmark stays bf16 (BASELINE contract); this path is the
scored-separately serving mode. Measured accuracy impact on the
grounded task: none (tests/test_quant.py — identical retrieval ranks,
embedding cosine > 0.999).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["int8_dense", "quantize_rows", "quantize_weight"]


def quantize_weight(kernel: jax.Array):
    """(K, N) float kernel -> (int8 kernel, (1, N) float scales)."""
    scale = jnp.max(jnp.abs(kernel), axis=0, keepdims=True) / 127.0
    scale = jnp.maximum(scale, 1e-12)
    q = jnp.round(kernel / scale).astype(jnp.int8)
    return q, scale


def quantize_rows(x: jax.Array):
    """(..., K) float activations -> (int8 x, (..., 1) float scales):
    symmetric per-row (per-token) dynamic quantization."""
    scale = jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0
    scale = jnp.maximum(scale, 1e-12)
    q = jnp.round(x / scale).astype(jnp.int8)
    return q, scale


def int8_dense(x: jax.Array, kernel: jax.Array, bias=None) -> jax.Array:
    """y = x @ kernel (+ bias) with the contraction in int8.

    Inputs are float (any dtype); output is float32. The int32
    accumulator is exact (K <= ~3k at 127-max operands stays far from
    2^31), so the only error is the two rounding steps."""
    wq, w_scale = quantize_weight(kernel.astype(jnp.float32))
    xq, x_scale = quantize_rows(x.astype(jnp.float32))
    y = jax.lax.dot_general(
        xq, wq, (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32)
    y = y * x_scale * w_scale
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y
