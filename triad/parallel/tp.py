"""Tensor (model) parallelism over a 2-D ('data', 'model') mesh.

The reference is single-GPU (SURVEY §2.6) — model parallelism has no
torch analog there. This is the scale-up axis for when one device's
memory or FLOPs stop being enough per model replica: parameters are
sharded Megatron-style over a 'model' mesh axis and XLA's SPMD
partitioner (GSPMD) inserts the collectives; the model code itself is
untouched. Composition with the existing scale-out stays clean:

  * batch stays sharded over 'data' (each model-parallel group is one
    data-parallel replica);
  * the all-gathered-negatives loss (parallel/dp.py) runs unchanged:
    its shard_map maps over 'data' and the 'model' axis simply
    replicates it (features leave the encoders replicated over
    'model' — the row-parallel output projections psum over the model
    axis inside GSPMD).

Sharding rules (Megatron-LM's column/row split, arXiv:1909.08053):

  * q/k/v projections + MLP input (``q_proj``/``k_proj``/``v_proj``,
    ``q_lin``/``k_lin``/``v_lin``, ``intermediate_dense``, ``fc1``):
    COLUMN-parallel — kernel P(None, 'model'), bias P('model'). The
    head reshape (B, T, H*hd) -> (B, T, H, hd) keeps the activations
    head-sharded when tp divides num_heads.
  * attention output + MLP output (``out_proj``/``out_lin``,
    ``output_dense``, ``fc2``): ROW-parallel — kernel P('model', None),
    bias replicated (added once, after GSPMD's psum over 'model').
  * ``word_embeddings``: vocab-sharded P('model', None).
  * ViT fused-qkv attention (``qkv``/``proj`` + LoRA): REPLICATED —
    the fused (D, 3D) layout interleaves q|k|v along the output dim,
    so a 'model' split does not align with the head reshape and GSPMD
    would immediately re-gather; the ViT MLP (the FLOPs majority)
    still shards.
  * everything else (LayerNorms, convs, positional/cls/register
    tokens, projection heads, temperature): replicated.

A dim is only sharded when divisible by the axis size; otherwise that
leaf falls back to replicated (still correct — GSPMD works with any
mix).

Pallas kernels do not partition under GSPMD (a pallas_call is an
opaque custom call to the partitioner), so tensor-parallel runs need
the XLA attention path — the Trainer rejects attention_impl="flash"
when mesh.tp > 1 (resolve_xla_impls).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# parents whose 'kernel' shards the OUTPUT (last) dim / 'bias' dim 0
_COLUMN_PARALLEL = frozenset({
    "q_proj", "k_proj", "v_proj",          # HuBERT attention
    "q_lin", "k_lin", "v_lin",             # DistilBERT attention
    "intermediate_dense",                  # HuBERT MLP in
    "fc1",                                 # DistilBERT FFN / ViT MLP in
})
# parents whose 'kernel' shards the INPUT (contraction) dim
_ROW_PARALLEL = frozenset({
    "out_proj", "out_lin",                 # attention output
    "output_dense",                        # HuBERT MLP out
    "fc2",                                 # DistilBERT FFN / ViT MLP out
})


def make_dp_tp_mesh(
    num_devices: Optional[int] = None,
    tp: int = 1,
    data_axis: str = "data",
    model_axis: str = "model",
) -> Mesh:
    """(num_devices/tp, tp) mesh; 'model' is the minor (fastest-varying)
    axis so each model-parallel group sits on adjacent devices (the
    per-layer psums are the chatty collectives)."""
    devices = jax.devices()
    if num_devices is None:
        num_devices = len(devices)
    if num_devices % tp:
        raise ValueError(f"num_devices={num_devices} not divisible by tp={tp}")
    grid = np.array(devices[:num_devices]).reshape(num_devices // tp, tp)
    return Mesh(grid, (data_axis, model_axis))


def make_multislice_tp_mesh(
    num_slices: int,
    data_per_slice: int,
    tp: int,
    replica_axis: str = "replica",
    data_axis: str = "data",
    model_axis: str = "model",
) -> Mesh:
    """3-D (num_slices, data_per_slice, tp) mesh — TP composed with the
    multi-slice layout: ``replica_axis`` spans slices (hosts),
    ``data_axis`` the data-parallel groups within a slice, and
    ``model_axis`` (minor, adjacent devices — the per-layer Megatron
    psums are the chatty collectives) the tensor-parallel group. The batch and
    the loss collectives ride the (replica, data) axis tuple exactly as
    in the 2-D multi-slice mesh (parallel/dp.py); every model-parallel
    group stays INSIDE one slice, so no Megatron psum ever crosses
    slices. jax.devices() orders devices host-major, so the reshape maps
    replica_axis onto the hosts."""
    devices = jax.devices()
    n = num_slices * data_per_slice * tp
    if len(devices) < n:
        raise ValueError(
            f"need {n} devices for {num_slices}x{data_per_slice}x{tp}, "
            f"have {len(devices)}"
        )
    grid = np.array(devices[:n]).reshape(num_slices, data_per_slice, tp)
    return Mesh(grid, (replica_axis, data_axis, model_axis))


def resolve_xla_impls(model_cfg):
    """Return ``model_cfg`` after checking that every encoder's attention
    is on the GSPMD-partitionable XLA path. A kernel ("flash", "cudnn")
    raises: a kernel call is opaque to the partitioner, so under tp > 1
    or fsdp it would force replicated operands and defeat the
    sharding."""
    for name in ("vit", "hubert", "text"):
        impl = getattr(model_cfg, name).attention_impl
        if impl != "xla":
            raise ValueError(
                f"mesh.tp > 1 / mesh.fsdp require XLA impls; "
                f"{name}.attention_impl={impl!r} is a kernel call "
                f"(allowed: 'xla')"
            )
    return model_cfg


def tp_param_specs(params: Any, tp: int, model_axis: str = "model") -> Any:
    """Params-shaped pytree of PartitionSpec (Megatron column/row rules,
    module docstring). Leaves that don't divide by ``tp`` replicate."""

    def spec(path, x) -> P:
        names = [getattr(p, "key", None) for p in path]
        leaf = names[-1] if names else None
        parent = names[-2] if len(names) >= 2 else None
        shape = getattr(x, "shape", ())

        def divisible(dim: int) -> bool:
            return len(shape) > dim and shape[dim] % tp == 0

        if parent in _COLUMN_PARALLEL:
            if leaf == "kernel" and divisible(len(shape) - 1):
                return P(*([None] * (len(shape) - 1)), model_axis)
            if leaf == "bias" and divisible(0):
                return P(model_axis)
        elif parent in _ROW_PARALLEL:
            if leaf == "kernel" and divisible(0):
                return P(model_axis, *([None] * (len(shape) - 1)))
            # row-parallel bias: replicated (added after the psum)
        elif leaf == "word_embeddings" and divisible(0):
            return P(model_axis, None)
        return P()

    return jax.tree_util.tree_map_with_path(spec, params)


def tp_state_shardings(state: Any, mesh: Mesh, param_specs: Any) -> Any:
    """NamedSharding tree for a TrainState under tensor parallelism:
    params (and the grad accumulator, params-shaped) carry the TP
    specs; optimizer moments and scalars replicate (Megatron default).
    For moments ALSO sharded over 'data' (ZeRO-1 x TP), use
    parallel.zero.apply_zero1(..., param_specs=..., partition=...)."""
    replicated = NamedSharding(mesh, P())

    def shard(tree_of_specs):
        return jax.tree.map(
            lambda s: NamedSharding(mesh, s),
            tree_of_specs,
            is_leaf=lambda s: isinstance(s, P),
        )

    return state.replace(
        params=shard(param_specs),
        opt=jax.tree.map(lambda _: replicated, state.opt),
        grad_accum=(
            shard(param_specs) if state.grad_accum is not None else None
        ),
        global_step=replicated,
        rng=replicated,
    )
