"""Data-parallel training over a jax.sharding.Mesh with all-gathered
in-batch negatives.

The reference is single-GPU (SURVEY §2.6: no distributed anything); its
"global batch" is whatever fits on one card (22 clips). This
scale-out keeps the *training semantics* — symmetric InfoNCE over the
full global BxB clip-sim matrix (model.py:430-472) — while distributing
the O(B^2 * Na * Nv) aggregation work across the data axis:

  * encoders run pure DP (batch sharded along 'data'; XLA partitions
    them automatically from the input shardings);
  * each device all-gathers the (small, 512-d projected) *visual key*
    tokens and computes only its **row block** of clip sims
    (local queries x global keys) — no device ever materializes the full
    volume, and the pairwise matmul work is sharded, not replicated;
    LossConfig.negatives="ring" swaps the all-gather for a ppermute
    ring of key shards (_ring_aggregate) — peak key memory two shards
    at any global batch, identical semantics;
  * row-direction CE is local; column-direction CE uses a distributed
    (pmax / psum) logsumexp; regularizer sums and similarity stats psum.

Gradients flow through the collectives (all_gather transposes to
reduce-scatter), so a plain jax.grad of the global loss yields correct
DP gradients with XLA-inserted communication — no hand-written NCCL
analog. Every scalar this module returns is replicated across chips and
bitwise-equal to the single-device computation on the concatenated
global batch (tested on an 8-device CPU mesh).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence, Tuple, Union

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

# A collective axis: one mesh axis name, or a tuple of them (multi-slice
# meshes — e.g. ("replica", "data") where 'replica' spans hosts and
# 'data' the devices inside one; collectives over the
# tuple span the full global batch, replica-major, matching
# lax.axis_index's flattened order).
Axis = Union[str, Tuple[str, ...]]


def _temp_varying(temperature: jax.Array, axis: "Axis") -> jax.Array:
    """Device-varying view of the replicated temperature for the
    (possibly custom-VJP) aggregation: pcastᵀ = psum folds the
    per-shard temperature cotangents, satisfying shard_map's transpose
    replication check. Multi-slice wrappers run check_vma=False (no
    vma tracking), where pcast is both unnecessary and rejected."""
    if isinstance(axis, tuple):
        return temperature
    return jax.lax.pcast(temperature, (axis,), to="varying")

from triad.core.config import LossConfig
from triad.ops.losses import (
    AVLossOut,
    TVLossOut,
    patch_sparsity,
    temperature_calibration,
)
from triad.ops.similarity import aggregate_crossbatch, diag_token_sims


def make_mesh(num_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(devices, (axis,))


def make_multislice_mesh(
    num_slices: int,
    devices_per_slice: Optional[int] = None,
    axes: Sequence[str] = ("replica", "data"),
) -> Mesh:
    """2-D (num_slices, devices_per_slice) mesh: axes[0] spans slices
    (hosts), axes[1] the devices within a slice. jax.devices() orders
    devices host-major, so this reshape maps axes[0] onto the hosts."""
    devices = jax.devices()
    if devices_per_slice is None:
        devices_per_slice = len(devices) // num_slices
    n = num_slices * devices_per_slice
    grid = np.array(devices[:n]).reshape(num_slices, devices_per_slice)
    return Mesh(grid, tuple(axes))


# ---------------------------------------------------------------------------
# Distributed pieces (run inside shard_map; axis_name = the data axis)
# ---------------------------------------------------------------------------


def _distributed_symmetric_infonce(
    clip_block: jax.Array, axis: Axis
) -> Tuple[jax.Array, jax.Array]:
    """Symmetric CE over the full global matrix from per-device row blocks.

    clip_block: (B_l, B) — local query rows x global key columns.
    Returns (contrastive_loss, diag_vals (B_l,)), both replicated /
    local respectively.
    """
    B_l, B = clip_block.shape
    idx = jax.lax.axis_index(axis)
    local_rows = jnp.arange(B_l)
    global_cols = idx * B_l + local_rows
    diag_vals = clip_block[local_rows, global_cols]

    # a2v (rows): full columns are local.
    row_lse = jax.nn.logsumexp(clip_block, axis=1)
    row_loss_sum = jnp.sum(row_lse - diag_vals)

    # v2a (columns): logsumexp over all rows, distributed. The max shift
    # is gradient-free (it cancels in logsumexp), and pmax has no VJP —
    # stop_gradient is exact here.
    col_max = jax.lax.stop_gradient(
        jax.lax.pmax(jnp.max(jax.lax.stop_gradient(clip_block), axis=0), axis)
    )  # (B,)
    sumexp = jax.lax.psum(
        jnp.sum(jnp.exp(clip_block - col_max[None, :]), axis=0), axis
    )
    col_lse = jnp.log(sumexp) + col_max  # (B,)
    col_loss_sum = jnp.sum(col_lse[global_cols] - diag_vals)

    contrastive = (
        jax.lax.psum(row_loss_sum, axis) + jax.lax.psum(col_loss_sum, axis)
    ) / (2.0 * B)
    return contrastive, diag_vals


def _distributed_stats(
    clip_block: jax.Array, diag_vals: jax.Array, axis: Axis, prefix: str
) -> Dict[str, jax.Array]:
    """pos/neg mean/std (Bessel), separation, hardest negative — global,
    matching ops.losses.similarity_stats on the full matrix. Stats are
    observability only (the reference reads them with .item(),
    model.py:443-447) — no gradient flows through them."""
    clip_block = jax.lax.stop_gradient(clip_block)
    diag_vals = jax.lax.stop_gradient(diag_vals)
    B_l, B = clip_block.shape
    idx = jax.lax.axis_index(axis)
    local_rows = jnp.arange(B_l)
    global_cols = idx * B_l + local_rows

    pos_sum = jax.lax.psum(jnp.sum(diag_vals), axis)
    pos_mean = pos_sum / B
    pos_sq = jax.lax.psum(jnp.sum((diag_vals - pos_mean) ** 2), axis)
    pos_std = jnp.sqrt(pos_sq / jnp.maximum(B - 1, 1))

    diag_mask = jnp.zeros_like(clip_block).at[local_rows, global_cols].set(1.0)
    offdiag = 1.0 - diag_mask
    n_neg = B * B - B
    neg_sum = jax.lax.psum(jnp.sum(clip_block * offdiag), axis)
    neg_mean = neg_sum / n_neg
    neg_sq = jax.lax.psum(jnp.sum(((clip_block - neg_mean) ** 2) * offdiag), axis)
    neg_std = jnp.sqrt(neg_sq / jnp.maximum(n_neg - 1, 1))
    hardest = jax.lax.pmax(
        jnp.max(jnp.where(offdiag > 0, clip_block, -jnp.inf)), axis
    )
    return {
        f"{prefix}_pos_sim_mean": pos_mean,
        f"{prefix}_pos_sim_std": pos_std,
        f"{prefix}_neg_sim_mean": neg_mean,
        f"{prefix}_neg_sim_std": neg_std,
        f"{prefix}_separation": pos_mean - neg_mean,
        f"{prefix}_hardest_negative": hardest,
    }


def _ring_aggregate(
    query: jax.Array,
    key_local: jax.Array,
    temperature: jax.Array,
    cfg: LossConfig,
    clamp_min: float,
    query_mask: Optional[jax.Array],
    axis: Axis,
):
    """Local-row block of global clip sims via a RING pass of the key
    shard (SURVEY §7.3 item 3's alternative to all-gathered negatives).

    Instead of materializing the full (B, Nk, D) gathered key set
    (0.4 GB at global 512 / 10 s audio; ~3.2 GB at 4096), each chip
    keeps a single key shard in flight: at every step it aggregates its
    local queries against the resident shard and ppermutes the shard one
    hop around the ring — peak key memory is 2 shards regardless of the
    global batch, and the ppermute overlaps with the next block's
    matmuls under XLA's async collectives. Semantics are identical to
    the all-gather path (tested: values and gradients match).

    Single mesh axis only: for multi-slice tuple axes keep
    "all_gather" (hierarchical rings would need slice-aware permutes).
    """
    if isinstance(axis, tuple):
        raise ValueError(
            "negatives='ring' supports a single mesh axis; use "
            "'all_gather' on multi-slice (tuple-axis) meshes"
        )
    n = jax.lax.psum(1, axis)
    rank = jax.lax.axis_index(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    B_l = query.shape[0]
    Nk = key_local.shape[1]

    def body(buf, _):
        agg = aggregate_crossbatch(
            query,
            buf,
            temperature,
            clamp_min=clamp_min,
            query_mask=query_mask,
            implementation=(
                "chunked" if cfg.implementation == "dense"
                else cfg.implementation
            ),
            chunk_size=cfg.chunk_size,
            compute_diag=False,
            precision=cfg.matmul_precision,
            volume_dtype=cfg.volume_dtype,
        )
        nxt = jax.lax.ppermute(buf, axis, perm)
        return nxt, (agg.clip_sims, agg.nonneg_sq_sum)

    _, (blocks, nns) = jax.lax.scan(body, key_local, None, length=n)
    # step s saw the shard that originated at chip (rank - s) mod n, so
    # column block j was computed at step (rank - j) mod n — the map is
    # its own inverse; gather the stacked blocks into global order.
    idx = (rank - jnp.arange(n)) % n
    cols = jnp.take(blocks, idx, axis=0)
    clip_sims = jnp.transpose(cols, (1, 0, 2)).reshape(B_l, n * B_l)
    numel = jnp.asarray(
        B_l * n * B_l * query.shape[1] * Nk, jnp.float32
    )
    from triad.ops.similarity import AggregateOut

    return AggregateOut(clip_sims, jnp.sum(nns), numel, None)


def _av_loss_shard(
    audio: jax.Array,
    visual: jax.Array,
    temperature: jax.Array,
    cfg: LossConfig,
    axis: Axis,
) -> AVLossOut:
    """Per-chip AV loss body. audio/visual: LOCAL (B_l, N, D) shards."""
    B_l, Na, _ = audio.shape
    Nv = visual.shape[1]
    n = jax.lax.psum(1, axis)
    B = n * B_l

    # The aggregation may run a custom-VJP op (implementation
    # "chunked_vjp") whose temperature cotangent comes back
    # device-varying — feed it a varying temperature (_temp_varying).
    # Only the aggregation consumes the varying copy: downstream psums
    # make its outputs replicated again, and the calibration term keeps
    # the replicated original.
    temp_v = _temp_varying(temperature, axis)

    if cfg.negatives == "ring":
        agg = _ring_aggregate(
            audio, visual, temp_v, cfg, cfg.av_nonneg_clamp_min, None,
            axis,
        )
    else:
        if cfg.negatives != "all_gather":
            raise ValueError(f"unknown negatives {cfg.negatives!r}")
        v_all = jax.lax.all_gather(visual, axis, tiled=True)  # (B, Nv, D)
        agg = aggregate_crossbatch(
            audio,
            v_all,
            temp_v,
            clamp_min=cfg.av_nonneg_clamp_min,
            implementation="chunked" if cfg.implementation == "dense" else cfg.implementation,
            chunk_size=cfg.chunk_size,
            compute_diag=False,
            precision=cfg.matmul_precision,
            volume_dtype=cfg.volume_dtype,
        )
    contrastive, diag_vals = _distributed_symmetric_infonce(agg.clip_sims, axis)

    l_nonneg = jax.lax.psum(agg.nonneg_sq_sum, axis) / (
        jnp.float32(B) * B * Na * Nv
    )
    diag_ts = diag_token_sims(audio, visual, temperature)  # positive pairs local
    smooth_sum = jnp.sum(
        (diag_ts[:, 1:, :] - diag_ts[:, :-1, :]) ** 2
    )
    l_smooth = jax.lax.psum(smooth_sum, axis) / (jnp.float32(B) * (Na - 1) * Nv)
    l_cal = temperature_calibration(temperature, cfg)
    reg = (
        cfg.temp_cal_weight * l_cal
        + cfg.av_nonneg_weight * l_nonneg
        + cfg.smooth_weight * l_smooth
    )
    stats = _distributed_stats(agg.clip_sims, diag_vals, axis, "av")
    smooth = cfg.smooth_weight * l_smooth
    return AVLossOut(contrastive + reg, contrastive, reg, smooth, stats)


def _tv_loss_shard(
    text: jax.Array,
    visual: jax.Array,
    text_mask: jax.Array,
    temperature: jax.Array,
    cfg: LossConfig,
    axis: Axis,
) -> TVLossOut:
    B_l, Nt, _ = text.shape
    Nv = visual.shape[1]
    n = jax.lax.psum(1, axis)
    B = n * B_l
    # See _av_loss_shard: varying temperature for the (possibly
    # custom-VJP) aggregation so its cotangent transposes cleanly.
    temp_v = _temp_varying(temperature, axis)

    if cfg.negatives == "ring":
        agg = _ring_aggregate(
            text, visual, temp_v, cfg, cfg.tv_nonneg_clamp_min,
            text_mask, axis,
        )
    else:
        if cfg.negatives != "all_gather":
            raise ValueError(f"unknown negatives {cfg.negatives!r}")
        v_all = jax.lax.all_gather(visual, axis, tiled=True)
        agg = aggregate_crossbatch(
            text,
            v_all,
            temp_v,
            clamp_min=cfg.tv_nonneg_clamp_min,
            query_mask=text_mask,
            implementation="chunked" if cfg.implementation == "dense" else cfg.implementation,
            chunk_size=cfg.chunk_size,
            compute_diag=False,
            precision=cfg.matmul_precision,
            volume_dtype=cfg.volume_dtype,
        )
    contrastive, diag_vals = _distributed_symmetric_infonce(agg.clip_sims, axis)

    l_nonneg = jax.lax.psum(agg.nonneg_sq_sum, axis) / (
        jnp.float32(B) * B * Nt * Nv
    )
    diag_ts = diag_token_sims(text, visual, temperature)
    # patch sparsity: mean over global batch of per-pair excess^2.
    sparsity_local = patch_sparsity(diag_ts, cfg.patch_sparsity_threshold)
    l_sparsity = jax.lax.psum(sparsity_local * B_l, axis) / B
    reg = cfg.tv_nonneg_weight * l_nonneg + cfg.patch_sparsity_weight * l_sparsity
    stats = _distributed_stats(agg.clip_sims, diag_vals, axis, "tv")
    return TVLossOut(contrastive + reg, contrastive, reg, stats)


# ---------------------------------------------------------------------------
# Public entry points (shard_map wrappers)
# ---------------------------------------------------------------------------


def distributed_av_loss(
    audio_feats: jax.Array,
    visual_feats: jax.Array,
    temperature: jax.Array,
    cfg: LossConfig,
    mesh: Mesh,
    axis: Axis = "data",
) -> AVLossOut:
    """Global AV loss over batch-sharded features. Inputs are sharded
    (B, ...) arrays on ``mesh``; all outputs replicated scalars. With a
    tuple ``axis`` (multi-slice mesh) the batch dim is sharded over all
    of its axes and negatives gather across slices too."""
    fn = partial(_av_loss_shard, cfg=cfg, axis=axis)
    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=AVLossOut(P(), P(), P(), P(), {
            k: P() for k in (
                "av_pos_sim_mean", "av_pos_sim_std", "av_neg_sim_mean",
                "av_neg_sim_std", "av_separation", "av_hardest_negative",
            )
        }),
        # Tuple-axis all_gather outputs defeat static replication
        # inference; the math replicates them (tested vs single device).
        check_vma=not isinstance(axis, tuple),
    )(audio_feats, visual_feats, temperature)


def distributed_tv_loss(
    text_feats: jax.Array,
    visual_feats: jax.Array,
    text_mask: jax.Array,
    temperature: jax.Array,
    cfg: LossConfig,
    mesh: Mesh,
    axis: Axis = "data",
) -> TVLossOut:
    fn = partial(_tv_loss_shard, cfg=cfg, axis=axis)
    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=TVLossOut(P(), P(), P(), {
            k: P() for k in (
                "tv_pos_sim_mean", "tv_pos_sim_std", "tv_neg_sim_mean",
                "tv_neg_sim_std", "tv_separation", "tv_hardest_negative",
            )
        }),
        check_vma=not isinstance(axis, tuple),
    )(text_feats, visual_feats, text_mask, temperature)
