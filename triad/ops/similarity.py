"""Dense token-similarity volumes and DenseAV-style max-mean aggregation.

Reference semantics (all citations into reference src/model.py):

* ``pairwise_similarity``  — inference/viz path (model.py:355-368):
  L2-normalize both token sets, batched matmul, **multiply** by temperature,
  computed in fp32.
* ``aggregate_crossbatch`` — training path (model.py:370-392, 490-514):
  token_sims[i, j, q, k] = <query_i_q, key_j_k> * temperature with **no
  normalization**, max over key tokens, (masked) mean over query tokens
  => clip_sims (B, B).  The reference materializes the full fp32
  (B, B, Nq, Nk) volume; at global batch 512 that volume is intractable,
  so we provide these implementations:

  - ``dense``:       materialize the volume (tests / small batches).
  - ``chunked``:     lax.scan over key-batch chunks with rematerialization —
                     O(B * chunk * Nq * Nk) live memory, gradients recompute
                     each chunk (flash-attention-style, via autodiff).
  - ``chunked_unrolled``: ``chunked`` with the scan unrolled.
  - ``chunked_vjp``: same forward, hand-written backward (chunks
                     recomputed at the operand dtype, no autodiff
                     residual stash — see _maxmean_chunked_vjp).

  All return bitwise-comparable results (tested) and also accumulate
  the non-negativity regularizer statistics (sum of clamp(ts, m, 0)^2 over
  the full volume, model.py:417, 524) so no caller ever needs the volume.

Gradient note: the subgradient of ``max`` at ties differs between torch
(routes to the first argmax) and XLA (splits evenly among ties). Ties have
measure zero for continuous features; parity tests use distinct values.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp


def _prec(precision: str):
    return (
        jax.lax.Precision.HIGHEST
        if precision == "highest"
        else jax.lax.Precision.DEFAULT
    )


def _volume_pet(volume_dtype: str):
    """preferred_element_type of the token-sim einsums: the matmul always
    accumulates in f32; "bfloat16" only rounds the memory-resident volume
    (halving the loss path's dominant memory traffic). Consumers upcast
    back to f32 in-register, so means/clamp^2 sums stay f32."""
    if volume_dtype == "bfloat16":
        return jnp.bfloat16
    if volume_dtype == "float32":
        return jnp.float32
    raise ValueError(f"unknown volume_dtype {volume_dtype!r}")


def _volume_operands(query: jax.Array, key: jax.Array, precision: str):
    """Resolve (q, k, einsum precision) for the token-sim matmuls.

    The reference computes sims in fp32 over bf16-autocast features
    (model.py:487: autocast off for the loss). When the incoming
    features ARE bf16, a bf16 x bf16 matmul with fp32 accumulation
    yields the same products as casting to fp32 and running HIGHEST —
    bf16 products are exact in the fp32 accumulator; fp32-HIGHEST
    merely re-derives them through a multi-pass decomposition at
    several times the matmul cost.
    fp32 inputs keep the full HIGHEST path (parity tests feed fp32).
    """
    if (
        precision == "highest"
        and query.dtype == jnp.bfloat16
        and key.dtype == jnp.bfloat16
    ):
        return query, key, jax.lax.Precision.DEFAULT
    keep = query.dtype if precision != "highest" else jnp.float32
    return query.astype(keep), key.astype(keep), _prec(precision)


class AggregateOut(NamedTuple):
    """Outputs of cross-batch max-mean aggregation.

    clip_sims:  (B, B) fp32 — aggregated clip-level similarities; rows are
                queries (audio/text), columns are keys (visual).
    nonneg_sq_sum: () fp32 — sum over the *entire* (B,B,Nq,Nk) volume of
                clamp(token_sims, clamp_min, 0)^2 (reference model.py:417,
                524 take the mean; divide by ``volume_numel``).
    volume_numel: () fp32 — B*B*Nq*Nk, denominator for the mean.
    diag_token_sims: (B, Nq, Nk) fp32 — token sims of positive pairs
                (i == j), needed by the temporal-smoothness (model.py:394-408)
                and patch-sparsity (model.py:516-542) regularizers.
    """

    clip_sims: jax.Array
    nonneg_sq_sum: jax.Array
    volume_numel: jax.Array
    diag_token_sims: jax.Array


def l2_normalize(x: jax.Array, axis: int = -1, eps: float = 1e-12) -> jax.Array:
    """torch.nn.functional.normalize semantics: x / max(||x||, eps)."""
    norm = jnp.linalg.norm(x, axis=axis, keepdims=True)
    return x / jnp.maximum(norm, eps)


def pairwise_similarity(
    feats1: jax.Array, feats2: jax.Array, temperature: jax.Array
) -> jax.Array:
    """Inference-path similarity (reference model.py:355-368).

    feats1: (B, N1, D), feats2: (B, N2, D) -> (B, N1, N2) fp32,
    both L2-normalized, scaled by (multiplied with) temperature.
    """
    f1 = l2_normalize(feats1.astype(jnp.float32))
    f2 = l2_normalize(feats2.astype(jnp.float32))
    sim = jnp.einsum("bnd,bmd->bnm", f1, f2, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    return sim * temperature.astype(jnp.float32)


def _masked_mean_over_queries(
    max_sims: jax.Array, query_mask: Optional[jax.Array]
) -> jax.Array:
    """Mean over the query-token axis (last axis of max_sims (..., Nq)).

    With a mask, replicates the reference TV path (model.py:509-512):
    masked sum / clamp(valid_count, 1e-7).
    """
    if query_mask is None:
        return jnp.mean(max_sims, axis=-1)
    # max_sims: (B, Bk, Nq); query_mask: (B, Nq) -> broadcast over Bk.
    mask = query_mask.astype(jnp.float32)[:, None, :]
    masked_sum = jnp.sum(max_sims * mask, axis=-1)
    valid = jnp.maximum(jnp.sum(mask, axis=-1), 1e-7)
    return masked_sum / valid


def diag_token_sims(
    query: jax.Array, key: jax.Array, temperature: jax.Array
) -> jax.Array:
    """Positive-pair (i == i) token sims: (B, Nq, Nk) fp32, unnormalized,
    scaled by temperature (the diagonal of the reference's token_sims volume,
    model.py:387/505)."""
    q, k, prec = _volume_operands(query, key, "highest")
    ts = jnp.einsum("bqd,bkd->bqk", q, k, preferred_element_type=jnp.float32, precision=prec)
    return ts * temperature.astype(jnp.float32)


# ---------------------------------------------------------------------------
# Dense implementation (reference-shaped; materializes the volume)
# ---------------------------------------------------------------------------


def _aggregate_dense(
    query: jax.Array,
    key: jax.Array,
    temperature: jax.Array,
    clamp_min: float,
    query_mask: Optional[jax.Array],
    compute_diag: bool = True,
    precision: str = "highest",
    volume_dtype: str = "float32",
) -> AggregateOut:
    Bq, Nq, _ = query.shape
    Bk, Nk = key.shape[0], key.shape[1]
    q, k, prec = _volume_operands(query, key, precision)
    # token_sims[i,j,q,k] (model.py:384-387 / 502-505)
    ts = jnp.einsum("iqd,jkd->ijqk", q, k, preferred_element_type=_volume_pet(volume_dtype), precision=prec)
    ts = ts.astype(jnp.float32) * temperature.astype(jnp.float32)
    max_sims = jnp.max(ts, axis=3)  # over key tokens (model.py:389/507)
    clip_sims = _masked_mean_over_queries(max_sims, query_mask)
    clamped = jnp.clip(ts, clamp_min, 0.0)
    nonneg_sq_sum = jnp.sum(clamped * clamped)
    numel = jnp.asarray(Bq * Bk * Nq * Nk, jnp.float32)
    diag = None
    if compute_diag:
        diag = jnp.einsum("bqd,bkd->bqk", q, k, preferred_element_type=jnp.float32, precision=prec)
        diag = diag * temperature.astype(jnp.float32)
    return AggregateOut(clip_sims, nonneg_sq_sum, numel, diag)


# ---------------------------------------------------------------------------
# Chunked implementation (scan over key-batch chunks, rematerialized)
# ---------------------------------------------------------------------------


def _aggregate_chunked(
    query: jax.Array,
    key: jax.Array,
    temperature: jax.Array,
    clamp_min: float,
    query_mask: Optional[jax.Array],
    chunk_size: int,
    compute_diag: bool = True,
    precision: str = "highest",
    unroll: bool = False,
    volume_dtype: str = "float32",
) -> AggregateOut:
    Bq, Nq, D = query.shape
    Bk, Nk = key.shape[0], key.shape[1]
    q, k, prec = _volume_operands(query, key, precision)
    temp = temperature.astype(jnp.float32)
    pet = _volume_pet(volume_dtype)

    # largest divisor <= chunk_size so shapes stay static (shared with
    # the custom-VJP path — _chunk_sizes).
    chunk, num_chunks = _chunk_sizes(Bk, chunk_size)
    k_chunks = k.reshape(num_chunks, chunk, Nk, D)

    @jax.checkpoint
    def chunk_fn(k_chunk):
        # (Bq, chunk, Nq, Nk) — the only live slice of the volume.
        ts = jnp.einsum("iqd,jkd->ijqk", q, k_chunk, preferred_element_type=pet, precision=prec)
        ts = ts.astype(jnp.float32) * temp
        max_sims = jnp.max(ts, axis=3)
        clip = _masked_mean_over_queries(max_sims, query_mask)  # (Bq, chunk)
        clamped = jnp.clip(ts, clamp_min, 0.0)
        return clip, jnp.sum(clamped * clamped)

    if unroll:
        # Python-unrolled chunks: XLA schedules/overlaps freely (the
        # scan's sequential while-loop constrains the backward).
        results = [chunk_fn(k_chunks[i]) for i in range(num_chunks)]
        clips = jnp.stack([r[0] for r in results])
        nonneg_sq_sum = sum(r[1] for r in results)
    else:
        def scan_body(carry, k_chunk):
            # carry-free scan (stack + reduce) keeps the body's output
            # types axis-varying-agnostic for shard_map.
            return carry, chunk_fn(k_chunk)

        _, (clips, nns) = jax.lax.scan(scan_body, None, k_chunks)
        nonneg_sq_sum = jnp.sum(nns)
    # clips: (num_chunks, Bq, chunk) -> (Bq, Bk) with key order restored.
    clip_sims = jnp.transpose(clips, (1, 0, 2)).reshape(Bq, Bk)
    numel = jnp.asarray(Bq * Bk * Nq * Nk, jnp.float32)
    diag = None
    if compute_diag:
        diag = jnp.einsum("bqd,bkd->bqk", q, k, preferred_element_type=jnp.float32, precision=prec) * temp
    return AggregateOut(clip_sims, nonneg_sq_sum, numel, diag)


# ---------------------------------------------------------------------------
# Chunked implementation with a hand-written VJP
# ---------------------------------------------------------------------------
#
# Autodiff of the chunked scan stashes per-chunk residuals and
# rematerializes the (Bq, chunk, Nq, Nk) volume in f32 on the way back
# (f32 residual chunks plus dynamic-update-slice residual stashing).
# This VJP recomputes each chunk's token sims flash-style in the
# operand dtype (bf16 in production), routes the max gradient through
# the JAX reduce_max semantics (ties split equally — matching the
# autodiff path bit-for-bit at fp32), and accumulates dQ as a scan
# carry / dK as stacked chunk outputs, with no residual volume ever
# reaching HBM.


def _chunk_sizes(bk: int, chunk_size: int) -> Tuple[int, int]:
    chunk = min(chunk_size, bk)
    while bk % chunk != 0:
        chunk -= 1
    return chunk, bk // chunk


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7))
def _maxmean_chunked_vjp(
    q, k, temperature, coeff, clamp_min: float, chunk_size: int,
    prec: jax.lax.Precision, volume_dtype: str = "float32",
):
    """(clip_sims (Bq, Bk) f32, nonneg_sq_sum () f32) with a custom
    backward. q/k are the RESOLVED volume operands and ``prec`` the
    matching RESOLVED einsum precision (both from _volume_operands —
    resolved once by the caller so forward and backward cannot drift
    from its policy); coeff (Bq, Nq) f32 is the per-query-token mean
    weight (1/Nq, or mask/count for the masked TV mean) — linear, so
    clip_sims = sum_a coeff[i,a] * max_v ts[i,j,a,v]."""
    clip, nonneg = _mm_fwd_scan(
        q, k, temperature, coeff, clamp_min, chunk_size, prec, volume_dtype
    )
    return clip, nonneg


def _mm_fwd_scan(q, k, temperature, coeff, clamp_min, chunk_size, prec,
                 volume_dtype):
    Bq, Nq, D = q.shape
    Bk, Nk = k.shape[0], k.shape[1]
    temp = temperature.astype(jnp.float32)
    pet = _volume_pet(volume_dtype)
    chunk, num_chunks = _chunk_sizes(Bk, chunk_size)
    k_chunks = k.reshape(num_chunks, chunk, Nk, D)

    def body(carry, k_chunk):
        ts = jnp.einsum(
            "iqd,jkd->ijqk", q, k_chunk,
            preferred_element_type=pet, precision=prec,
        ).astype(jnp.float32) * temp
        max_sims = jnp.max(ts, axis=3)  # (Bq, chunk, Nq)
        # exact f32 multiply+reduce (an einsum here would run at the
        # platform's DEFAULT matmul precision — bf16 or TF32 operands —
        # while the "chunked" path's masked mean is an exact sum).
        clip = jnp.sum(max_sims * coeff[:, None, :], axis=-1)
        clamped = jnp.clip(ts, clamp_min, 0.0)
        return carry, (clip, jnp.sum(clamped * clamped))

    _, (clips, nns) = jax.lax.scan(body, None, k_chunks)
    clip_sims = jnp.transpose(clips, (1, 0, 2)).reshape(Bq, Bk)
    return clip_sims, jnp.sum(nns)


def _mm_vjp_fwd(q, k, temperature, coeff, clamp_min, chunk_size, prec,
                volume_dtype):
    out = _mm_fwd_scan(
        q, k, temperature, coeff, clamp_min, chunk_size, prec, volume_dtype
    )
    return out, (q, k, temperature, coeff)


def _mm_vjp_bwd(clamp_min, chunk_size, prec, volume_dtype, res, cts):
    q, k, temperature, coeff = res
    g_clip, g_nn = cts
    Bq, Nq, D = q.shape
    Bk, Nk = k.shape[0], k.shape[1]
    temp = temperature.astype(jnp.float32)
    pet = _volume_pet(volume_dtype)
    chunk, num_chunks = _chunk_sizes(Bk, chunk_size)
    k_chunks = k.reshape(num_chunks, chunk, Nk, D)
    g_chunks = jnp.transpose(
        g_clip.astype(jnp.float32).reshape(Bq, num_chunks, chunk), (1, 0, 2)
    )  # (num_chunks, Bq, chunk)
    g_nn = g_nn.astype(jnp.float32)
    op_dtype = q.dtype

    def body(carry, xs):
        dq_acc, dtemp_acc = carry
        k_chunk, g_c = xs
        # Recompute at the forward's volume dtype so eq/argmax routing
        # is bit-identical to the forward's max.
        ts = jnp.einsum(
            "iqd,jkd->ijqk", q, k_chunk,
            preferred_element_type=pet, precision=prec,
        ).astype(jnp.float32) * temp  # (Bq, chunk, Nq, Nk)
        max_sims = jnp.max(ts, axis=3, keepdims=True)
        eq = (ts == max_sims).astype(jnp.float32)
        count = jnp.sum(eq, axis=3, keepdims=True)
        # d clip / d ts: coeff routed through the (tie-splitting) max —
        # identical to jax.grad of jnp.max.
        g_max = g_c[:, :, None] * coeff[:, None, :]  # (Bq, chunk, Nq)
        dts = eq * (g_max[..., None] / count)
        # d nonneg_sq_sum / d ts = 2*clamped inside the active window.
        clamped = jnp.clip(ts, clamp_min, 0.0)
        active = jnp.logical_and(ts > clamp_min, ts < 0.0)
        dts = dts + g_nn * 2.0 * jnp.where(active, ts, 0.0)
        # temperature: ts = raw * T  =>  dT += sum(dts * raw)
        dtemp_acc = dtemp_acc + jnp.sum(dts * ts) / temp
        dts_op = (dts * temp).astype(op_dtype)
        dq_acc = dq_acc + jnp.einsum(
            "ijqk,jkd->iqd", dts_op, k_chunk,
            preferred_element_type=jnp.float32, precision=prec,
        )
        dk_c = jnp.einsum(
            "ijqk,iqd->jkd", dts_op, q,
            preferred_element_type=jnp.float32, precision=prec,
        )
        return (dq_acc, dtemp_acc), dk_c

    # Derive the zero carries from traced inputs so their varying-axis
    # type matches the body outputs under shard_map (a fresh
    # jnp.zeros(...) is unvarying and lax.scan rejects the carry pair).
    init = (
        q.astype(jnp.float32) * 0.0,
        g_nn * 0.0,
    )
    (dq, dtemp), dk_chunks = jax.lax.scan(body, init, (k_chunks, g_chunks))
    dk = dk_chunks.reshape(Bk, Nk, D)
    # coeff carries no parameter gradient (it derives from the 0/1 text
    # mask); return a structural zero.
    dcoeff = jnp.zeros_like(coeff)
    return (
        dq.astype(q.dtype), dk.astype(k.dtype),
        dtemp.astype(temperature.dtype), dcoeff,
    )


_maxmean_chunked_vjp.defvjp(_mm_vjp_fwd, _mm_vjp_bwd)


def _aggregate_chunked_custom(
    query: jax.Array,
    key: jax.Array,
    temperature: jax.Array,
    clamp_min: float,
    query_mask: Optional[jax.Array],
    chunk_size: int,
    compute_diag: bool = True,
    precision: str = "highest",
    volume_dtype: str = "float32",
) -> AggregateOut:
    """Chunked aggregation routed through the hand-written VJP
    (implementation="chunked_vjp"). Forward values match "chunked"
    exactly; backward recomputes chunks in the operand dtype instead of
    autodiff's f32 residual stash."""
    Bq, Nq, _ = query.shape
    Bk, Nk = key.shape[0], key.shape[1]
    q, k, prec_resolved = _volume_operands(query, key, precision)
    if query_mask is None:
        coeff = jnp.full((Bq, Nq), 1.0 / Nq, jnp.float32)
    else:
        m = query_mask.astype(jnp.float32)
        coeff = m / jnp.maximum(jnp.sum(m, axis=1, keepdims=True), 1e-7)
    clip_sims, nonneg_sq_sum = _maxmean_chunked_vjp(
        q, k, temperature, coeff, clamp_min, chunk_size, prec_resolved,
        volume_dtype,
    )
    numel = jnp.asarray(Bq * Bk * Nq * Nk, jnp.float32)
    diag = None
    if compute_diag:
        diag = jnp.einsum(
            "bqd,bkd->bqk", q, k, preferred_element_type=jnp.float32,
            precision=prec_resolved,
        ) * temperature.astype(jnp.float32)
    return AggregateOut(clip_sims, nonneg_sq_sum, numel, diag)


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


def aggregate_crossbatch(
    query: jax.Array,
    key: jax.Array,
    temperature: jax.Array,
    *,
    clamp_min: float,
    query_mask: Optional[jax.Array] = None,
    implementation: str = "dense",
    chunk_size: int = 8,
    compute_diag: bool = True,
    precision: str = "highest",
    volume_dtype: str = "float32",
) -> AggregateOut:
    """Cross-batch max-mean aggregation (reference model.py:370-392/490-514).

    query: (B, Nq, D) audio or text tokens (rows of clip_sims).
    key:   (B, Nk, D) visual tokens (columns of clip_sims).
    temperature: scalar (multiplied — training semantics, model.py:387).
    clamp_min: lower clamp of the non-negativity regularizer
        (-60 AV model.py:417, -20 TV model.py:524).
    query_mask: optional (B, Nq) validity mask => masked mean over queries
        (the reference TV path, model.py:509-512).
    """
    unroll = False
    if implementation == "chunked_unrolled":
        implementation, unroll = "chunked", True
    if implementation == "dense":
        return _aggregate_dense(
            query, key, temperature, clamp_min, query_mask, compute_diag,
            precision, volume_dtype,
        )
    if implementation == "chunked":
        return _aggregate_chunked(
            query, key, temperature, clamp_min, query_mask, chunk_size,
            compute_diag, precision, unroll, volume_dtype,
        )
    if implementation == "chunked_vjp":
        return _aggregate_chunked_custom(
            query, key, temperature, clamp_min, query_mask, chunk_size,
            compute_diag, precision, volume_dtype,
        )
    raise ValueError(f"Unknown implementation {implementation!r}")
