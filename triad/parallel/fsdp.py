"""FSDP-style (ZeRO-3) parameter sharding over the 'data' axis.

The reference keeps full replicas on its single GPU; ZeRO-1
(parallel/zero.py) already shards the optimizer moments. This module
goes the rest of the way when the *parameters themselves* are the HBM
problem: every large parameter is stored sharded over 'data' and XLA's
SPMD partitioner inserts the all-gather right where a layer consumes
its weights — and its transpose (reduce-scatter) on the gradients —
exactly torch-FSDP's gather-on-use semantics with zero model-code
changes. Per-step collective volume is one all-gather + one
reduce-scatter of the parameters, the same wire bytes as plain DP's
grad all-reduce, so FSDP is close to free at step granularity
(the cost is latency/overlap, which XLA schedules per-consumer).

Rules: shard the largest dim divisible by the data-axis size, but only
for parameters of at least ``min_size`` elements (gathering a (768,)
bias per step costs more in dispatch than it saves in HBM); small
leaves replicate. Composes with tensor parallelism by extending the
Megatron specs on a spec-free dim (mesh.tp > 1 + mesh.fsdp), and with
ZeRO-1 trivially (sharded params make sharded moments the natural
GSPMD placement — parallel/zero.py's param_specs path).

Like TP, FSDP needs the XLA impl knobs: a pallas_call is opaque to the
partitioner and would force its weight operands replicated
(parallel/tp.py resolve_xla_impls).
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def fsdp_param_specs(
    params: Any,
    mesh: Mesh,
    data_axis: str = "data",
    base_specs: Any = None,
    min_size: int = 1024,
) -> Any:
    """Params-shaped pytree of PartitionSpec with each large leaf's
    largest spec-free divisible dim sharded over ``data_axis``.

    ``base_specs``: optional params-shaped specs to extend (the TP
    specs from parallel/tp.py) — leaves already sharded over
    ``data_axis`` or with no free divisible dim keep their base spec.
    """
    n = int(mesh.shape[data_axis])

    def extend(base: P, x) -> P:
        shape = getattr(x, "shape", ())
        if int(np.prod(shape or (1,))) < min_size:
            return base
        entries = list(base) + [None] * (len(shape) - len(base))
        if any(
            data_axis in (e if isinstance(e, tuple) else (e,))
            for e in entries
            if e is not None
        ):
            return base
        best = None
        for d, s in enumerate(shape):
            if entries[d] is None and s % n == 0 and s >= n:
                if best is None or s > shape[best]:
                    best = d
        if best is None:
            return base
        entries[best] = data_axis
        return P(*entries)

    if base_specs is None:
        base_specs = jax.tree.map(lambda _: P(), params)
    return jax.tree.map(
        extend, base_specs, params,
        is_leaf=lambda s: isinstance(s, P),
    )
