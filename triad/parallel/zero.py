"""ZeRO-1 style optimizer-state sharding over the data axis.

The reference keeps full fp32 Adam state on its single GPU (4 torch
AdamW instances, train.py:272-287). At scale the moments are pure
memory ballast: every device in a DP mesh holds an identical copy. This
module shards the *storage* of the Adam moments (and the grad
accumulator, when present) across the 'data' axis via sharding
annotations, and lets GSPMD partition the update math:

  * gradients are still globally reduced (the loss collectives and the
    clip-norm scalars need full grads), exactly as before;
  * each chip applies the Adam update only to its 1/N shard of the
    moments and produces its 1/N shard of the parameter delta;
  * `params + updates` all-gathers the deltas back into replicated
    params (the encoders want replicated weights under pure DP).

Numerics match the replicated computation up to collective reduction
order (GSPMD may lower the grad reduction as reduce-scatter instead of
all-reduce when the consumer is sharded) — validated on the 8-device
CPU mesh in tests/test_parallel.py.

Sharding rule per array: partition the largest dimension divisible by
the mesh size; replicate anything too small or indivisible (biases,
LayerNorm scales, scalars). At full size this frees ~(1 - 1/N) of
~1.4 GB of moment state per device, buying memory headroom for bigger
per-device batches / less remat.
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def shard_largest_dim(x, mesh: Mesh, axis) -> NamedSharding:
    """NamedSharding partitioning x's largest mesh-divisible dim.
    ``axis``: a mesh axis name or tuple of names (multi-slice)."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    n = int(np.prod([mesh.shape[a] for a in names]))
    shape = getattr(x, "shape", ())
    best = None
    for d, s in enumerate(shape):
        if s % n == 0 and s >= n:
            if best is None or s > shape[best]:
                best = d
    if best is None:
        return NamedSharding(mesh, P())
    spec = [None] * len(shape)
    spec[best] = axis
    return NamedSharding(mesh, P(*spec))


def zero1_state_shardings(
    state: Any,
    mesh: Mesh,
    axis="data",
    param_specs: Any = None,
    partition: Any = None,
) -> Any:
    """Sharding pytree for a TrainState: params replicated, optimizer
    moments + grad accumulator sharded (ZeRO-1), scalars replicated.

    Tensor-parallel composition (``param_specs`` + ``partition`` given,
    parallel/tp.py): params keep their Megatron specs; every Adam
    moment inherits its param's TP spec and additionally shards its
    largest spec-free dim over ``axis`` — ZeRO-1 on top of TP, so the
    moment storage divides by dp*tp, not just dp. The mapping from a
    moment leaf back to its param rides the tree path: the moments live
    in per-group ``mu``/``nu`` leaf lists aligned with
    ``partition.split`` (train/optim.py OptimizerBank)."""
    replicated = NamedSharding(mesh, P())

    if param_specs is None:

        def moments(tree):
            return jax.tree.map(
                lambda x: shard_largest_dim(x, mesh, axis), tree
            )

        def spec_for_opt(opt_state):
            # BankState(adam={group: optax state}, sched_counts={group:
            # scalar}). Adam states hold count scalars + mu/nu trees;
            # shard every non-scalar leaf, replicate scalars (counts).
            return jax.tree.map(
                lambda x: (
                    shard_largest_dim(x, mesh, axis)
                    if getattr(x, "ndim", 0) >= 1
                    else replicated
                ),
                opt_state,
            )

        param_shardings = jax.tree.map(lambda _: replicated, state.params)
    else:
        spec_parts = partition.split(param_specs)
        axis_names = (axis,) if isinstance(axis, str) else tuple(axis)
        n_data = int(np.prod([mesh.shape[a] for a in axis_names]))

        def extend_with_data(base: P, x) -> NamedSharding:
            """base spec + ``axis`` on the largest free divisible dim.
            A base already using ``axis`` (FSDP param specs) is kept —
            the moments simply inherit the param's sharding."""
            shape = getattr(x, "shape", ())
            entries = list(base) + [None] * (len(shape) - len(base))
            used = {
                n for e in entries if e is not None
                for n in (e if isinstance(e, tuple) else (e,))
            }
            if used & set(axis_names):
                return NamedSharding(mesh, base)
            best = None
            for d, s in enumerate(shape):
                if entries[d] is None and s % n_data == 0 and s >= n_data:
                    if best is None or s > shape[best]:
                        best = d
            if best is not None:
                entries[best] = axis
            return NamedSharding(mesh, P(*entries))

        def spec_for_opt(opt_state):
            from jax.tree_util import DictKey, GetAttrKey, SequenceKey

            def leaf_spec(path, x):
                group = None
                field = None
                idx = None
                for k in path:
                    if isinstance(k, DictKey) and k.key in spec_parts:
                        group = k.key
                    elif isinstance(k, GetAttrKey) and k.name in ("mu", "nu"):
                        field = k.name
                    elif field is not None and isinstance(k, SequenceKey):
                        idx = k.idx
                        break
                if group is not None and field is not None and idx is not None:
                    return extend_with_data(spec_parts[group][idx], x)
                if getattr(x, "ndim", 0) >= 1:
                    return shard_largest_dim(x, mesh, axis)
                return replicated

            return jax.tree_util.tree_map_with_path(leaf_spec, opt_state)

        def moments(tree):
            # grad accumulator: params-shaped — TP spec + data extension
            spec_leaves = partition.leaves(param_specs)
            acc_leaves = partition.leaves(tree)
            out = [
                extend_with_data(s, x)
                for s, x in zip(spec_leaves, acc_leaves)
            ]
            return jax.tree_util.tree_unflatten(partition.treedef, out)

        param_shardings = jax.tree.map(
            lambda s: NamedSharding(mesh, s),
            param_specs,
            is_leaf=lambda s: isinstance(s, P),
        )

    return state.replace(
        params=param_shardings,
        opt=spec_for_opt(state.opt),
        grad_accum=(
            moments(state.grad_accum)
            if state.grad_accum is not None
            else None
        ),
        global_step=replicated,
        rng=replicated,
    )


def apply_zero1(
    state: Any,
    mesh: Mesh,
    axis="data",
    param_specs: Any = None,
    partition: Any = None,
) -> Any:
    """Place a TrainState with ZeRO-1 shardings on ``mesh`` (optionally
    composed with tensor-parallel ``param_specs`` — see
    zero1_state_shardings).

    Multi-process safe: routes through
    parallel.distributed.put_global_tree (every process holds the full
    host-initialized state; plain device_put rejects global shardings).
    """
    from triad.parallel.distributed import put_global_tree

    return put_global_tree(
        state,
        zero1_state_shardings(state, mesh, axis, param_specs, partition),
    )
