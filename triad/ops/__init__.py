from triad.ops.losses import (
    AVLossOut,
    TVLossOut,
    av_loss,
    av_loss_from_aggregate,
    patch_sparsity,
    similarity_stats,
    symmetric_infonce,
    temperature_calibration,
    temporal_smoothness,
    tv_loss,
    tv_loss_from_aggregate,
)
from triad.ops.similarity import (
    AggregateOut,
    aggregate_crossbatch,
    diag_token_sims,
    l2_normalize,
    pairwise_similarity,
)

__all__ = [
    "AggregateOut",
    "AVLossOut",
    "TVLossOut",
    "aggregate_crossbatch",
    "av_loss",
    "av_loss_from_aggregate",
    "diag_token_sims",
    "l2_normalize",
    "pairwise_similarity",
    "patch_sparsity",
    "similarity_stats",
    "symmetric_infonce",
    "temperature_calibration",
    "temporal_smoothness",
    "tv_loss",
    "tv_loss_from_aggregate",
]
