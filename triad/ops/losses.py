"""Contrastive losses, regularizers and similarity statistics.

Pure fp32 functions over projected token features, replicating the
reference loss math exactly (citations into reference src/model.py):

* AV loss:   model.py:430-472 (InfoNCE) + 394-428 (regularizers)
* TV loss:   model.py:544-593 (InfoNCE) + 516-542 (regularizers)
* statistics: model.py:435-450 / 553-568 — computed *inside* the jitted
  step as jnp scalars (the reference's ``.item()`` calls are host syncs;
  we return a dict of device scalars instead).

Quirks preserved on purpose (parity demands them — SURVEY §7.3 item 4):
  - training token sims are **unnormalized** and **multiplied** by
    temperature (model.py:387) while retrieval divides (retrieval.py:108);
  - the temperature-calibration penalty only applies the "too low" branch
    (model.py:424 assigns ``l_cal = temp_low``; the high branch is dead);
  - the TV non-negativity and sparsity terms include padded text tokens
    (the reference masks only the clip-level mean, model.py:509-512).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from triad.core.config import LossConfig
from triad.ops.similarity import AggregateOut, aggregate_crossbatch


class AVLossOut(NamedTuple):
    total: jax.Array
    contrastive: jax.Array
    reg: jax.Array
    smooth: jax.Array
    stats: Dict[str, jax.Array]


class TVLossOut(NamedTuple):
    total: jax.Array
    contrastive: jax.Array
    reg: jax.Array
    stats: Dict[str, jax.Array]


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _std_unbiased(x: jax.Array) -> jax.Array:
    """torch.Tensor.std() semantics (Bessel-corrected, ddof=1)."""
    n = x.size
    mean = jnp.mean(x)
    var = jnp.sum((x - mean) ** 2) / jnp.maximum(n - 1, 1)
    return jnp.sqrt(var)


def symmetric_infonce(clip_sims: jax.Array) -> jax.Array:
    """Symmetric cross-entropy over the (B, B) clip-sim matrix with
    diagonal labels (model.py:453-459 / 572-578)."""
    log_p_rows = jax.nn.log_softmax(clip_sims, axis=1)
    log_p_cols = jax.nn.log_softmax(clip_sims.T, axis=1)
    diag_rows = jnp.diagonal(log_p_rows)
    diag_cols = jnp.diagonal(log_p_cols)
    return jnp.mean(-diag_rows - diag_cols) / 2.0


def similarity_stats(clip_sims: jax.Array, prefix: str) -> Dict[str, jax.Array]:
    """pos/neg mean/std, separation, hardest negative
    (model.py:435-450, 463-470)."""
    B = clip_sims.shape[0]
    pos = jnp.diagonal(clip_sims)
    # jit-compatible off-diagonal stats (no boolean gathering): masked sums.
    offdiag = 1.0 - jnp.eye(B, dtype=clip_sims.dtype)
    n_neg = B * B - B
    neg_sum = jnp.sum(clip_sims * offdiag)
    neg_mean = neg_sum / n_neg
    neg_sq_dev = jnp.sum(((clip_sims - neg_mean) ** 2) * offdiag)
    neg_std = jnp.sqrt(neg_sq_dev / jnp.maximum(n_neg - 1, 1))
    hardest = jnp.max(jnp.where(offdiag > 0, clip_sims, -jnp.inf))
    pos_mean = jnp.mean(pos)
    return {
        f"{prefix}_pos_sim_mean": pos_mean,
        f"{prefix}_pos_sim_std": _std_unbiased(pos),
        f"{prefix}_neg_sim_mean": neg_mean,
        f"{prefix}_neg_sim_std": neg_std,
        f"{prefix}_separation": pos_mean - neg_mean,
        f"{prefix}_hardest_negative": hardest,
    }


def temperature_calibration(temperature: jax.Array, cfg: LossConfig) -> jax.Array:
    """max(0, log(low) - log(T))^2 — the only live branch (model.py:420-424)."""
    t = temperature.astype(jnp.float32)
    temp_low = jnp.maximum(jnp.log(jnp.float32(cfg.temp_cal_low)) - jnp.log(t), 0.0) ** 2
    return temp_low


def temporal_smoothness(diag_token_sims: jax.Array) -> jax.Array:
    """Mean squared first difference along audio time of positive-pair
    token sims (model.py:394-408). diag_token_sims: (B, Na, Nv)."""
    diffs = diag_token_sims[:, 1:, :] - diag_token_sims[:, :-1, :]
    return jnp.mean(diffs * diffs)


def patch_sparsity(
    diag_token_sims: jax.Array, threshold: float
) -> jax.Array:
    """Patch-usage sparsity on positive pairs (model.py:533-540).

    softmax over patches per text token, fraction of mass per patch
    (summed over tokens / Nt — padded tokens included, as in the
    reference), squared excess above the threshold, meaned.
    """
    patch_probs = jax.nn.softmax(diag_token_sims, axis=-1)  # (B, Nt, Nv)
    nt = diag_token_sims.shape[1]
    patch_fraction = jnp.sum(patch_probs, axis=1) / nt  # (B, Nv)
    excess = jax.nn.relu(patch_fraction - threshold)
    return jnp.mean(excess * excess)


# ---------------------------------------------------------------------------
# Audio-visual loss (model.py:430-488)
# ---------------------------------------------------------------------------


def av_loss_from_aggregate(
    agg: AggregateOut, temperature: jax.Array, cfg: LossConfig
) -> AVLossOut:
    contrastive = symmetric_infonce(agg.clip_sims)
    l_nonneg = agg.nonneg_sq_sum / agg.volume_numel
    l_cal = temperature_calibration(temperature, cfg)
    l_smooth = temporal_smoothness(agg.diag_token_sims)
    reg = (
        cfg.temp_cal_weight * l_cal
        + cfg.av_nonneg_weight * l_nonneg
        + cfg.smooth_weight * l_smooth
    )
    smooth = cfg.smooth_weight * l_smooth
    stats = similarity_stats(agg.clip_sims, "av")
    return AVLossOut(contrastive + reg, contrastive, reg, smooth, stats)


def av_loss(
    audio_feats: jax.Array,
    visual_feats: jax.Array,
    temperature: jax.Array,
    cfg: LossConfig,
) -> AVLossOut:
    """Full AV loss from projected tokens.

    audio_feats: (B, Na, D); visual_feats: (B, Nv, D); temperature: scalar.
    """
    agg = aggregate_crossbatch(
        audio_feats,
        visual_feats,
        temperature,
        clamp_min=cfg.av_nonneg_clamp_min,
        implementation=cfg.implementation,
        chunk_size=cfg.chunk_size,
        precision=cfg.matmul_precision,
        volume_dtype=cfg.volume_dtype,
    )
    return av_loss_from_aggregate(agg, temperature, cfg)


# ---------------------------------------------------------------------------
# Text-visual loss (model.py:516-608)
# ---------------------------------------------------------------------------


def tv_loss_from_aggregate(
    agg: AggregateOut, cfg: LossConfig
) -> TVLossOut:
    contrastive = symmetric_infonce(agg.clip_sims)
    l_nonneg = agg.nonneg_sq_sum / agg.volume_numel
    l_sparsity = patch_sparsity(agg.diag_token_sims, cfg.patch_sparsity_threshold)
    reg = cfg.tv_nonneg_weight * l_nonneg + cfg.patch_sparsity_weight * l_sparsity
    stats = similarity_stats(agg.clip_sims, "tv")
    return TVLossOut(contrastive + reg, contrastive, reg, stats)


def tv_loss(
    text_feats: jax.Array,
    visual_feats: jax.Array,
    text_mask: jax.Array,
    temperature: jax.Array,
    cfg: LossConfig,
) -> TVLossOut:
    """Full TV loss from projected tokens.

    text_feats: (B, Nt, D); visual_feats: (B, Nv, D);
    text_mask: (B, Nt) 1 = valid token (masks the clip-level mean only,
    model.py:509-512).
    """
    agg = aggregate_crossbatch(
        text_feats,
        visual_feats,
        temperature,
        clamp_min=cfg.tv_nonneg_clamp_min,
        query_mask=text_mask,
        implementation=cfg.implementation,
        chunk_size=cfg.chunk_size,
        precision=cfg.matmul_precision,
        volume_dtype=cfg.volume_dtype,
    )
    return tv_loss_from_aggregate(agg, cfg)
