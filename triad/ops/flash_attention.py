"""Training attention for Hopper: flash attention with in-kernel dropout.

A Pallas kernel on the Triton route (``backend="triton"``), adapted from
the Triton-route kernel that ships with JAX
(``jax/experimental/pallas/ops/gpu/attention.py``): the same online-
softmax forward and the same fused dK/dV + dQ backward that recomputes
the probabilities from the saved log-sum-exp. Added here:

- dropout on the attention probabilities. The keep bit of element
  (batch, head, query, key) is a counter-based hash of those indices and
  a seed, so the backward regenerates the forward's mask and no
  (B, H, N, N) mask or probability tensor ever reaches device memory —
  which is what the XLA path pays for in both directions;
- ragged sequence lengths (HuBERT's 499 tokens, the ViT's 261): the last
  query and key blocks are masked in the kernel, with no padded copies;
- an optional per-row key mask (text padding).

Layout is (B, N, H, D), the projections' own layout: a kernel instance
reads one head's (N, D) slab with a row stride of H*D, so no transposes
surround the call. ``attention_reference`` is the plain float32 version
of the same function, dropout mask included, that tests and the chip
smoke test compare against.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Masked (padding) keys get a large finite negative score, as in the XLA
# path (a row whose keys are all masked averages them uniformly); keys
# past the sequence end get -inf and never contribute.
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
_LOG2E = math.log2(math.e)
# Powers of two for Triton; a (64, 64) bf16 tile pair plus a float32
# accumulator sits well inside a block's 227 KB of shared memory.
BLOCK_FWD = 64
BLOCK_BWD = 32

# The kernel compiles for a GPU only; elsewhere Pallas refuses to lower it
# ("Only interpret mode is supported on CPU backend"). Code that runs it
# on the CPU, the test suite, opts into the Pallas interpreter here.
_interpret_default = False


def use_interpreter(enabled: bool) -> None:
    """Run every later flash_attention call in the Pallas interpreter
    (``enabled=True``) or compiled for the GPU (the default)."""
    global _interpret_default
    _interpret_default = bool(enabled)


def _hash32(x: jax.Array) -> jax.Array:
    """uint32 -> uint32 avalanche hash (lowbias32)."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    return x ^ (x >> 16)


def _stream_key(seed, batch_index, head, num_heads):
    bh = (batch_index * num_heads + head).astype(jnp.uint32)
    return _hash32(seed.astype(jnp.uint32) ^ _hash32(bh + jnp.uint32(0x9E3779B9)))


def _keep(key, rows, cols, n: int, rate: float):
    """Keep bits for a (rows x cols) tile; P(keep) = 1 - rate."""
    idx = (rows[:, None] * n + cols[None, :]).astype(jnp.uint32)
    threshold = jnp.uint32(min(int(rate * 2.0**32), 2**32 - 1))
    return _hash32(idx ^ key) >= threshold


def dropout_keep_mask(seed, batch: int, heads: int, n: int, rate: float,
                      batch_offset=0) -> jax.Array:
    """The kernel's keep mask as a (B, H, N, N) bool array."""
    b = jnp.arange(batch)[:, None] + batch_offset
    h = jnp.arange(heads)[None, :]
    key = _stream_key(jnp.asarray(seed), b, h, heads)  # (B, H)
    rows = jnp.arange(n)
    idx = (rows[:, None] * n + rows[None, :]).astype(jnp.uint32)
    threshold = jnp.uint32(min(int(rate * 2.0**32), 2**32 - 1))
    return _hash32(idx[None, None] ^ key[:, :, None, None]) >= threshold


def attention_reference(q, k, v, key_mask=None, *, dropout_rate=0.0,
                        seed=0, batch_offset=0, sm_scale=None):
    """Float32 softmax attention with the kernel's dropout mask.

    q, k, v: (B, N, H, D); key_mask: optional (B, N), nonzero = attend.
    Call under ``jax.default_matmul_precision("highest")`` for a float32
    reference on a GPU, where float32 matmuls default to TF32."""
    b, n, h, d = q.shape
    sm_scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    q, k, v = (x.astype(jnp.float32) for x in (q, k, v))
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    if key_mask is not None:
        s = jnp.where(key_mask[:, None, None, :] != 0, s, MASK_VALUE)
    p = jax.nn.softmax(s, axis=-1)
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(seed, b, h, n, dropout_rate, batch_offset)
        p = jnp.where(keep, p, 0.0) / (1.0 - dropout_rate)
    return jnp.einsum("bhqk,bkhd->bqhd", p, v)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def _scores(q, k, kmask_ref, start_k, cols, col_ok, sm_scale):
    """Base-2 scaled scores of a tile, masked."""
    s = pl.dot(q, k.T) * (sm_scale * _LOG2E)
    if kmask_ref is not None:
        km = plgpu.load(kmask_ref.at[pl.ds(start_k, cols.shape[0])],
                        mask=col_ok, other=0.0)
        s = jnp.where(km[None, :] != 0, s, MASK_VALUE)
    return jnp.where(col_ok[None, :], s, -jnp.inf)


def _fwd_kernel(seed_ref, q_ref, k_ref, v_ref, kmask_ref, o_ref, lse_ref, *,
                sm_scale, rate, n, num_heads, block_q, block_k):
    iq, b, h = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    d = q_ref.shape[-1]
    key = _stream_key(seed_ref[0], seed_ref[1] + b, h, num_heads)
    rows = iq * block_q + jnp.arange(block_q)
    row_ok = rows < n
    q = plgpu.load(q_ref, mask=row_ok[:, None], other=0.0)

    def body(j, carry):
        o, m, l = carry
        start = j * block_k
        cols = start + jnp.arange(block_k)
        col_ok = cols < n
        k = plgpu.load(k_ref.at[pl.ds(start, block_k), :],
                       mask=col_ok[:, None], other=0.0)
        s = _scores(q, k, kmask_ref, start, cols, col_ok, sm_scale)
        m_new = jnp.maximum(m, jnp.max(s, axis=-1))
        corr = jnp.exp2(m - m_new)
        p = jnp.exp2(s - m_new[:, None])
        l = l * corr + jnp.sum(p, axis=-1)
        if rate > 0.0:
            p = jnp.where(_keep(key, rows, cols, n, rate), p, 0.0)
        v = plgpu.load(v_ref.at[pl.ds(start, block_k), :],
                       mask=col_ok[:, None], other=0.0)
        o = o * corr[:, None] + pl.dot(p.astype(v.dtype), v)
        return o, m_new, l

    init = (
        jnp.zeros((block_q, d), jnp.float32),
        jnp.full((block_q,), -jnp.inf, jnp.float32),
        jnp.zeros((block_q,), jnp.float32),
    )
    o, m, l = lax.fori_loop(0, pl.cdiv(n, block_k), body, init)
    o = o / (l[:, None] * (1.0 - rate))
    plgpu.store(o_ref, o.astype(o_ref.dtype), mask=row_ok[:, None])
    plgpu.store(lse_ref, m + jnp.log2(l), mask=row_ok)


def _bwd_kernel(seed_ref, q_ref, k_ref, v_ref, kmask_ref, do_ref, lse_ref,
                delta_ref, dq_ref, dk_ref, dv_ref, *, sm_scale, rate, n,
                num_heads, block):
    b, h, i = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    d = q_ref.shape[-1]
    key = _stream_key(seed_ref[0], seed_ref[1] + b, h, num_heads)
    inv_keep = 1.0 / (1.0 - rate)
    nblocks = pl.cdiv(n, block)

    def load_rows(ref, start, ok):
        return plgpu.load(ref.at[pl.ds(start, block), :], mask=ok[:, None],
                          other=0.0)

    def load_vec(ref, start, ok):
        return plgpu.load(ref.at[pl.ds(start, block)], mask=ok, other=0.0)

    # dK, dV for key block i: loop over query blocks.
    start_k = i * block
    cols = start_k + jnp.arange(block)
    col_ok = cols < n
    k = load_rows(k_ref, start_k, col_ok)
    v = load_rows(v_ref, start_k, col_ok)

    def dkdv(jq, carry):
        dk, dv = carry
        start_q = jq * block
        rows = start_q + jnp.arange(block)
        row_ok = rows < n
        q = load_rows(q_ref, start_q, row_ok)
        do = load_rows(do_ref, start_q, row_ok)
        lse = load_vec(lse_ref, start_q, row_ok)
        di = load_vec(delta_ref, start_q, row_ok)
        p = jnp.exp2(
            _scores(q, k, kmask_ref, start_k, cols, col_ok, sm_scale)
            - lse[:, None]
        )
        dp = pl.dot(do, v.T)
        if rate > 0.0:
            keep = _keep(key, rows, cols, n, rate)
            pd = jnp.where(keep, p, 0.0) * inv_keep
            dp = jnp.where(keep, dp, 0.0) * inv_keep
        else:
            pd = p
        dv = dv + pl.dot(pd.astype(do.dtype).T, do)
        ds = p * (dp - di[:, None]) * sm_scale
        dk = dk + pl.dot(ds.astype(q.dtype).T, q)
        return dk, dv

    zeros = jnp.zeros((block, d), jnp.float32)
    dk, dv = lax.fori_loop(0, nblocks, dkdv, (zeros, zeros))
    plgpu.store(dk_ref, dk.astype(dk_ref.dtype), mask=col_ok[:, None])
    plgpu.store(dv_ref, dv.astype(dv_ref.dtype), mask=col_ok[:, None])

    # dQ for query block i: loop over key blocks.
    start_q = i * block
    rows = start_q + jnp.arange(block)
    row_ok = rows < n
    q = load_rows(q_ref, start_q, row_ok)
    do = load_rows(do_ref, start_q, row_ok)
    lse = load_vec(lse_ref, start_q, row_ok)
    di = load_vec(delta_ref, start_q, row_ok)

    def dq_body(jk, dq):
        start = jk * block
        kcols = start + jnp.arange(block)
        kcol_ok = kcols < n
        kk = load_rows(k_ref, start, kcol_ok)
        vv = load_rows(v_ref, start, kcol_ok)
        p = jnp.exp2(
            _scores(q, kk, kmask_ref, start, kcols, kcol_ok, sm_scale)
            - lse[:, None]
        )
        dp = pl.dot(do, vv.T)
        if rate > 0.0:
            keep = _keep(key, rows, kcols, n, rate)
            dp = jnp.where(keep, dp, 0.0) * inv_keep
        ds = p * (dp - di[:, None]) * sm_scale
        return dq + pl.dot(ds.astype(kk.dtype), kk)

    dq = lax.fori_loop(0, nblocks, dq_body, zeros)
    plgpu.store(dq_ref, dq.astype(dq_ref.dtype), mask=row_ok[:, None])


# ---------------------------------------------------------------------------
# Calls
# ---------------------------------------------------------------------------


def _block(n: int, cap: int) -> int:
    return max(16, min(cap, pl.next_power_of_2(n)))


def _forward(q, k, v, kmask, seed, rate, sm_scale, interpret):
    b, n, h, d = q.shape
    bq = bk = _block(n, BLOCK_FWD)
    n_pad = pl.cdiv(n, bk) * bk
    kernel = functools.partial(
        _fwd_kernel, sm_scale=sm_scale, rate=rate, n=n, num_heads=h,
        block_q=bq, block_k=bk,
    )
    kv_spec = pl.BlockSpec((None, n_pad, None, d), lambda i, j, hh: (j, 0, hh, 0))
    in_specs = [
        pl.BlockSpec((2,), lambda i, j, hh: (0,)),
        pl.BlockSpec((None, bq, None, d), lambda i, j, hh: (j, i, hh, 0)),
        kv_spec,
        kv_spec,
        None if kmask is None
        else pl.BlockSpec((None, n_pad), lambda i, j, hh: (j, 0)),
    ]
    out, lse = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, bq), b, h),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((None, bq, None, d), lambda i, j, hh: (j, i, hh, 0)),
            pl.BlockSpec((None, None, bq), lambda i, j, hh: (j, hh, i)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct(q.shape, q.dtype),
            jax.ShapeDtypeStruct((b, h, n), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="flash_attention_fwd",
    )(seed, q, k, v, kmask)
    return out, lse


def _backward(q, k, v, kmask, seed, out, lse, do, rate, sm_scale, interpret):
    b, n, h, d = q.shape
    blk = _block(n, BLOCK_BWD)
    n_pad = pl.cdiv(n, blk) * blk
    delta = jnp.einsum(
        "bnhd,bnhd->bhn", out.astype(jnp.float32), do.astype(jnp.float32)
    )
    kernel = functools.partial(
        _bwd_kernel, sm_scale=sm_scale, rate=rate, n=n, num_heads=h,
        block=blk,
    )
    full = pl.BlockSpec((None, n_pad, None, d), lambda j, hh, i: (j, 0, hh, 0))
    row = pl.BlockSpec((None, None, n_pad), lambda j, hh, i: (j, hh, 0))
    tile = pl.BlockSpec((None, blk, None, d), lambda j, hh, i: (j, i, hh, 0))
    dq, dk, dv = pl.pallas_call(
        kernel,
        grid=(b, h, pl.cdiv(n, blk)),
        in_specs=[
            pl.BlockSpec((2,), lambda j, hh, i: (0,)),
            full, full, full,
            None if kmask is None
            else pl.BlockSpec((None, n_pad), lambda j, hh, i: (j, 0)),
            full, row, row,
        ],
        out_specs=[tile, tile, tile],
        out_shape=[jax.ShapeDtypeStruct(x.shape, x.dtype) for x in (q, k, v)],
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="flash_attention_bwd",
    )(seed, q, k, v, kmask, do, lse, delta)
    return dq, dk, dv


@functools.partial(jax.custom_vjp, nondiff_argnums=(5, 6, 7))
def _flash(q, k, v, kmask, seed, rate, sm_scale, interpret):
    return _forward(q, k, v, kmask, seed, rate, sm_scale, interpret)[0]


def _flash_fwd(q, k, v, kmask, seed, rate, sm_scale, interpret):
    out, lse = _forward(q, k, v, kmask, seed, rate, sm_scale, interpret)
    return out, (q, k, v, kmask, seed, out, lse)


def _flash_bwd(rate, sm_scale, interpret, res, do):
    q, k, v, kmask, seed, out, lse = res
    dq, dk, dv = _backward(q, k, v, kmask, seed, out, lse, do, rate,
                           sm_scale, interpret)
    return dq, dk, dv, None, None


_flash.defvjp(_flash_fwd, _flash_bwd)


def flash_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    key_mask: Optional[jax.Array] = None,
    *,
    dropout_rate: float = 0.0,
    seed: jax.Array | int = 0,
    batch_offset: jax.Array | int = 0,
    sm_scale: Optional[float] = None,
    interpret: Optional[bool] = None,
) -> jax.Array:
    """Softmax attention over (B, N, H, D) inputs, dropout in the kernel.

    key_mask: optional (B, N), nonzero = attend. seed: int32 scalar;
    batch_offset: global index of this call's first batch row, so that
    a batch split over devices draws the same mask as the whole batch.
    Differentiable in q, k and v. ``interpret`` (default: as set by
    ``use_interpreter``, off unless changed) runs the kernel in the Pallas
    interpreter instead of compiling it for the GPU."""
    b, n, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} not in [0, 1)")
    if interpret is None:
        interpret = _interpret_default
    if not interpret and (d < 16 or d & (d - 1)):
        raise ValueError(f"head_dim {d} must be a power of two >= 16")
    sm_scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    seeds = jnp.stack([
        jnp.asarray(seed, jnp.int32).reshape(()),
        jnp.asarray(batch_offset, jnp.int32).reshape(()),
    ])
    kmask = None if key_mask is None else key_mask.astype(jnp.float32)
    return _flash(q, k, v, kmask, seeds, float(dropout_rate), sm_scale,
                  bool(interpret))
