"""Opt-in int8 serving mode: run a trained TriadModel with every Dense
matmul quantized to int8, without touching model code or checkpoints.

Mechanism: a ``models.nn.intercept_methods`` interceptor swaps the
computation of every ``nn.Dense`` and ``LoRADense`` (LoRA folded into
the kernel first, as the eval fast path already does) for the dynamic
int8 matmul in ``triad.ops.quant``. Attention score/value
contractions (activation x activation, ~10% of matmul FLOPs at
reference sequence lengths) and the conv frontends stay in the float
path.

Usage::

    from triad.models.quantize import int8_interception

    with int8_interception():
        out = model.apply({"params": params}, images, audio, ids, mask,
                          train=False)

The context must be active while JAX *traces* (e.g. wrap the
``model.apply`` call inside your jitted function); the compiled
program then permanently contains the int8 graph.

"""

from __future__ import annotations

import contextlib

import jax.numpy as jnp

from triad.models import nn
from triad.models.layers import LoRADense
from triad.ops.quant import int8_dense

__all__ = ["int8_interception"]


def _intercept(next_fn, args, kwargs, context):
    mod = context.module
    if context.method_name != "__call__":
        return next_fn(*args, **kwargs)
    if isinstance(mod, nn.Dense):
        kernel = mod.get_variable("params", "kernel")
        if kernel is None:  # init pass: let the module create params
            return next_fn(*args, **kwargs)
        bias = mod.get_variable("params", "bias") if mod.use_bias else None
        return int8_dense(args[0], jnp.asarray(kernel), bias).astype(
            args[0].dtype
        )
    if isinstance(mod, LoRADense):
        kernel = mod.get_variable("params", "kernel")
        if kernel is None:
            return next_fn(*args, **kwargs)
        kernel = jnp.asarray(kernel, jnp.float32)
        if mod.rank > 0:
            lora_a = jnp.asarray(
                mod.get_variable("params", "lora_a"), jnp.float32
            )
            lora_b = jnp.asarray(
                mod.get_variable("params", "lora_b"), jnp.float32
            )
            kernel = kernel + (mod.alpha / mod.rank) * (lora_a @ lora_b)
        bias = mod.get_variable("params", "bias") if mod.use_bias else None
        return int8_dense(args[0], kernel, bias).astype(args[0].dtype)
    return next_fn(*args, **kwargs)


@contextlib.contextmanager
def int8_interception():
    """Context manager: all Dense/LoRADense matmuls traced inside run
    in int8 (dynamic per-token activations, per-channel weights)."""
    with nn.intercept_methods(_intercept):
        yield
