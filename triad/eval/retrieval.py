"""1000-way cross-modal retrieval (R@1/5/10/20, four directions).

Reference protocol (reference src/retrieval.py):
  * persisted random subset of 1000 items (retrieval.py:9-30);
  * no-augmentation re-embedding (retrieval.py:32-104, 200-248):
    AV features L2-normalized (retrieval.py:93-94), TV features NOT
    normalized and text truncated to valid tokens (retrieval.py:236-246)
    — asymmetric on purpose, kept for parity;
  * per-pair aggregator: token_sims = Q·Kᵀ / temperature (DIVIDED here
    vs multiplied in training — retrieval.py:108 vs model.py:387), max
    over candidate tokens, mean over query tokens;
  * R@K from the rank of the diagonal (retrieval.py:117-144).

The reference scores N^2 pairs with a double Python loop — 1M tiny GPU
kernels (SURVEY §3.3). Here each direction is a handful of big masked
einsums: queries are processed in batched blocks against ALL candidate
tokens at once, with padding masks replacing the ragged per-item token
lists. ~1e6x fewer dispatches, same numbers (tested against a per-pair
oracle).
"""

from __future__ import annotations

import functools
import json
import os
import random
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from triad.parallel.distributed import fetch


def select_subset_indices(
    dataset_size: int, subset_file: str, subset_size: int = 1000
) -> List[int]:
    """Load-or-create the persisted subset (reference retrieval.py:9-30).

    Multi-process: process 0 loads-or-creates and the result is
    broadcast to everyone (every process must embed the SAME subset —
    the per-host filesystems need not be shared, and concurrent
    create+read of the JSON would race).
    """
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        # Fixed-size wire format (broadcast needs equal shapes): slot 0
        # is the true length, the rest the zero-padded subset.
        buf = np.zeros(subset_size + 1, dtype=np.int64)
        if jax.process_index() == 0:
            subset = _load_or_create_subset(
                dataset_size, subset_file, subset_size
            )[:subset_size]
            buf[0] = len(subset)
            buf[1 : 1 + len(subset)] = subset
        buf = multihost_utils.broadcast_one_to_all(buf)
        return [int(i) for i in buf[1 : 1 + int(buf[0])]]
    return _load_or_create_subset(dataset_size, subset_file, subset_size)


def _load_or_create_subset(
    dataset_size: int, subset_file: str, subset_size: int
) -> List[int]:
    if os.path.exists(subset_file):
        with open(subset_file) as f:
            indices = json.load(f)
        print(f"Loaded {len(indices)} subset indices from {subset_file}")
        return indices
    indices = list(range(dataset_size))
    random.shuffle(indices)
    subset = indices[:subset_size]
    tmp = subset_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(subset, f)
    os.replace(tmp, subset_file)
    print(f"Created new subset of size {len(subset)} -> {subset_file}")
    return subset


# ---------------------------------------------------------------------------
# Vectorized scoring
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("qb", "kb", "precision"))
def _score_all(
    q_tokens: jax.Array,  # (N, Nq, D) padded query tokens
    q_mask: jax.Array,  # (N, Nq)
    k_tokens: jax.Array,  # (N, Nk, D) padded candidate tokens
    k_mask: jax.Array,  # (N, Nk)
    inv_temp: jax.Array,
    qb: int,
    kb: int,
    precision: str,
) -> jax.Array:
    """Full (N, N) aggregated scores in ONE device program.

    Two-level blocking: lax.map over query blocks x lax.scan over key
    blocks; each tile is a (qb*Nq, D) x (D, kb*Nk) matmul with a
    running masked max-mean — the token-sim volume never exceeds one
    (qb, Nq, kb, Nk) tile (~tens of MB), vs ~16 GB for a naive
    (block, N, Nq, Nk) einsum at the reference's 1000-way scale.
    """
    n, nq, d = q_tokens.shape
    nk = k_tokens.shape[1]
    prec = (
        jax.lax.Precision.HIGHEST
        if precision == "highest"
        else jax.lax.Precision.DEFAULT
    )
    neg = jnp.finfo(jnp.float32).min
    k_blocks = k_tokens.reshape(n // kb, kb, nk, d)
    km_blocks = k_mask.reshape(n // kb, kb, nk)

    def q_block(args):
        q, qm = args  # (qb, Nq, D), (qb, Nq)
        q2 = q.reshape(qb * nq, d)
        counts = jnp.maximum(jnp.sum(qm, axis=1), 1.0)  # (qb,)

        def k_step(_, kargs):
            k, km = kargs  # (kb, Nk, D), (kb, Nk)
            sims = jax.lax.dot_general(
                q2, k.reshape(kb * nk, d),
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=prec,
            ) * inv_temp  # (qb*Nq, kb*Nk)
            sims = sims.reshape(qb, nq, kb, nk)
            sims = jnp.where(km[None, None, :, :] > 0, sims, neg)
            mx = jnp.max(sims, axis=3)  # (qb, Nq, kb)
            mean = jnp.sum(mx * qm[:, :, None], axis=1) / counts[:, None]
            return 0, mean  # (qb, kb)

        _, tiles = jax.lax.scan(k_step, 0, (k_blocks, km_blocks))
        return jnp.transpose(tiles, (1, 0, 2)).reshape(qb, n)

    rows = jax.lax.map(
        q_block,
        (
            q_tokens.reshape(n // qb, qb, nq, d),
            q_mask.reshape(n // qb, qb, nq),
        ),
    )
    return rows.reshape(n, n)


def score_matrix(
    q_tokens: np.ndarray,
    q_mask: np.ndarray,
    k_tokens: np.ndarray,
    k_mask: np.ndarray,
    temperature: float,
    block: int = 8,
    key_block: int = 16,
    precision: str = "highest",
) -> np.ndarray:
    """Full (N, N) aggregated similarity matrix (one jitted program).

    N is padded up to a block multiple with fully-masked items: padded
    *candidates* score finfo.min against everything (ranked last);
    padded *query* rows are sliced off before returning.
    """
    N = q_tokens.shape[0]
    lcm = block * key_block // np.gcd(block, key_block)
    n_pad = int(np.ceil(N / lcm)) * lcm
    if n_pad != N:
        pad = n_pad - N

        def padded(x):
            w = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, w)

        q_tokens, q_mask = padded(q_tokens), padded(q_mask)
        k_tokens, k_mask = padded(k_tokens), padded(k_mask)
    out = _score_all(
        jnp.asarray(q_tokens), jnp.asarray(q_mask),
        jnp.asarray(k_tokens), jnp.asarray(k_mask),
        jnp.float32(1.0 / temperature),
        qb=block, kb=key_block, precision=precision,
    )
    return np.asarray(out)[:N, :N]


def compute_recall_at_k(sim_matrix: np.ndarray) -> Dict[str, float]:
    """R@{1,5,10,20} of the diagonal (reference retrieval.py:117-144)."""
    N = sim_matrix.shape[0]
    order = np.argsort(-sim_matrix, axis=1)
    ranks = np.argmax(order == np.arange(N)[:, None], axis=1)
    return {
        "r1": float(np.mean(ranks < 1)),
        "r5": float(np.mean(ranks < 5)),
        "r10": float(np.mean(ranks < 10)),
        "r20": float(np.mean(ranks < 20)),
    }


# ---------------------------------------------------------------------------
# Embedding + metric entry points
# ---------------------------------------------------------------------------


def embed_av_subset(
    encode_fn,
    dataset,
    indices: List[int],
    audio_num_samples: int,
    batch_size: int = 8,
    num_tokens_fn=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """No-augmentation embedding of the AV subset, L2-normalized
    (reference retrieval.py:32-104).

    encode_fn(images (B,H,W,3), audio (B,T)) -> (audio_feats, visual_feats)
    Returns (audio_tokens (N,Na,D), audio_mask (N,Na), visual_tokens
    (N,Nv,D)); the audio mask flags frames produced by real (non-padding)
    audio. ``num_tokens_fn(num_samples) -> num_tokens`` gives the exact
    conv-stack length map (HubertConfig.num_audio_tokens); without it a
    proportional approximation is used.
    """
    from triad.data.audio import pad_or_trim

    a_list, am_list, v_list = [], [], []
    for lo in range(0, len(indices), batch_size):
        chunk = indices[lo : lo + batch_size]
        items = [
            dataset.__getitem__(int(i), apply_augmentation=False) for i in chunk
        ]
        images = np.stack([it["video_frames"] for it in items]).astype(np.float32)
        raw_lens = [min(len(it["audio"]), audio_num_samples) for it in items]
        audio = np.stack(
            [pad_or_trim(it["audio"], audio_num_samples) for it in items]
        )
        a_feats, v_feats = encode_fn(jnp.asarray(images), jnp.asarray(audio))
        a_feats = fetch(a_feats).astype(np.float32)
        v_feats = fetch(v_feats).astype(np.float32)
        na = a_feats.shape[1]
        for b, raw_len in enumerate(raw_lens):
            if num_tokens_fn is not None:
                valid = max(1, min(na, num_tokens_fn(raw_len)))
            else:
                valid = max(1, int(na * raw_len / audio_num_samples))
            mask = np.zeros(na, np.float32)
            mask[:valid] = 1.0
            a_list.append(a_feats[b])
            am_list.append(mask)
            v_list.append(v_feats[b])
    a = _l2(np.stack(a_list))
    v = _l2(np.stack(v_list))
    return a, np.stack(am_list), v


def embed_tv_subset(
    encode_fn,
    dataset,
    indices: List[int],
    tokenizer,
    max_text_tokens: int,
    batch_size: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """TV subset embedding: text mask-truncated, NOT normalized
    (reference retrieval.py:200-248 asymmetry, kept)."""
    t_list, tm_list, v_list = [], [], []
    for lo in range(0, len(indices), batch_size):
        chunk = indices[lo : lo + batch_size]
        items = [
            dataset.__getitem__(int(i), apply_augmentation=False) for i in chunk
        ]
        images = np.stack([img for img, _ in items]).astype(np.float32)
        captions = [cap for _, cap in items]
        ids, mask = tokenizer.encode_batch(
            captions, max_length=max_text_tokens, pad_to=max_text_tokens
        )
        t_feats, v_feats = encode_fn(
            jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask)
        )
        t_list.append(fetch(t_feats).astype(np.float32))
        tm_list.append(mask.astype(np.float32))
        v_list.append(fetch(v_feats).astype(np.float32))
    return (
        np.concatenate(t_list),
        np.concatenate(tm_list),
        np.concatenate(v_list),
    )


def _l2(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    norm = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(norm, eps)


def av_retrieval_metrics(
    audio_tokens: np.ndarray,
    audio_mask: np.ndarray,
    visual_tokens: np.ndarray,
    temperature: float,
) -> Dict[str, float]:
    """A->V and V->A recall (reference retrieval.py:146-188)."""
    N, Nv = visual_tokens.shape[0], visual_tokens.shape[1]
    v_mask = np.ones((N, Nv), np.float32)
    a2v = score_matrix(audio_tokens, audio_mask, visual_tokens, v_mask, temperature)
    v2a = score_matrix(visual_tokens, v_mask, audio_tokens, audio_mask, temperature)
    m_a2v = compute_recall_at_k(a2v)
    m_v2a = compute_recall_at_k(v2a)
    out = {f"A->V_r{k[1:]}": v for k, v in m_a2v.items()}
    out.update({f"V->A_r{k[1:]}": v for k, v in m_v2a.items()})
    return out


def tv_retrieval_metrics(
    text_tokens: np.ndarray,
    text_mask: np.ndarray,
    visual_tokens: np.ndarray,
    temperature: float,
) -> Dict[str, float]:
    """T->V and V->T recall (reference retrieval.py:250-292)."""
    N, Nv = visual_tokens.shape[0], visual_tokens.shape[1]
    v_mask = np.ones((N, Nv), np.float32)
    t2v = score_matrix(text_tokens, text_mask, visual_tokens, v_mask, temperature)
    v2t = score_matrix(visual_tokens, v_mask, text_tokens, text_mask, temperature)
    m_t2v = compute_recall_at_k(t2v)
    m_v2t = compute_recall_at_k(v2t)
    out = {f"T->V_r{k[1:]}": v for k, v in m_t2v.items()}
    out.update({f"V->T_r{k[1:]}": v for k, v in m_v2t.items()})
    return out


def at_retrieval_metrics(
    audio_tokens: np.ndarray,
    audio_mask: np.ndarray,
    text_tokens: np.ndarray,
    text_mask: np.ndarray,
    temperature: float,
) -> Dict[str, float]:
    """A->T and T->A recall — the TRANSITIVE tri-modal direction.

    The reference claims text<->audio alignment emerges through the
    shared visual space (README.md:15) and exposes the similarity only
    qualitatively in the generic forward (model.py:631-636); it never
    measures it. This completes the eval surface for datasets that
    carry all three modalities per item (e.g. the grounded synthetic
    task, or AV data with captions). Both sides masked; same max-mean
    /temperature aggregator as the other directions."""
    a2t = score_matrix(audio_tokens, audio_mask, text_tokens, text_mask, temperature)
    t2a = score_matrix(text_tokens, text_mask, audio_tokens, audio_mask, temperature)
    m_a2t = compute_recall_at_k(a2t)
    m_t2a = compute_recall_at_k(t2a)
    out = {f"A->T_r{k[1:]}": v for k, v in m_a2t.items()}
    out.update({f"T->A_r{k[1:]}": v for k, v in m_t2a.items()})
    return out
