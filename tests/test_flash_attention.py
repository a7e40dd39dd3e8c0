"""The flash attention kernel (ops/flash_attention.py) in the Pallas
interpreter, against the plain float32 reference: forward values,
gradients, ragged lengths, key masks, and the in-kernel dropout mask —
its keep rate, its 1/(1-p) scaling, its replay in the backward, and its
dependence on the seed and the batch offset. Plus the encoders' one
attention dispatch point (models/layers.attention)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from triad.ops.flash_attention import (
    attention_reference,
    dropout_keep_mask,
    flash_attention,
)


def _qkv(shape, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    return tuple(
        jnp.asarray(rng.normal(size=shape).astype(np.float32) * scale)
        for _ in range(3)
    )


def _key_mask(b, n, seed=1):
    rng = np.random.default_rng(seed)
    m = rng.random((b, n)) > 0.3
    m[:, 0] = True  # every row keeps at least one key
    return jnp.asarray(m, jnp.float32)


@pytest.mark.parametrize("n", [16, 37, 70])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_reference(n, rate, masked):
    q, k, v = _qkv((2, n, 2, 16))
    km = _key_mask(2, n) if masked else None
    out = flash_attention(q, k, v, km, dropout_rate=rate, seed=7)
    ref = attention_reference(q, k, v, km, dropout_rate=rate, seed=7)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("n,rate,masked", [
    (16, 0.0, False), (37, 0.1, False), (37, 0.1, True), (70, 0.3, True),
])
def test_gradients_match_reference(n, rate, masked):
    q, k, v = _qkv((2, n, 2, 16), seed=3)
    do = _qkv((2, n, 2, 16), seed=4)[0]
    km = _key_mask(2, n) if masked else None

    def vjp(f):
        return jax.vjp(
            lambda q, k, v: f(q, k, v, km, dropout_rate=rate, seed=11),
            q, k, v,
        )[1](do)

    for got, want, name in zip(
        vjp(flash_attention), vjp(attention_reference), "qkv"
    ):
        rel = float(jnp.linalg.norm(got - want) / jnp.linalg.norm(want))
        assert rel < 1e-5, (name, rel)


def test_bf16_inputs_accumulate_in_float32():
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv((2, 37, 2, 16)))
    out = flash_attention(q, k, v)
    assert out.dtype == jnp.bfloat16
    ref = attention_reference(q, k, v)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref), atol=2e-2
    )


def _kernel_mask(seed, n, rate, batch_offset=0, b=2, h=2):
    """Read the kernel's own keep mask back: with q = k = 0 every
    probability is 1/n, and v = identity rows make output[i, j] =
    keep[i, j] / (n (1 - rate))."""
    q = jnp.zeros((b, n, h, n), jnp.float32)
    v = jnp.broadcast_to(jnp.eye(n, dtype=jnp.float32)[None, :, None, :],
                         (b, n, h, n))
    out = flash_attention(q, q, v, dropout_rate=rate, seed=seed,
                          batch_offset=batch_offset)
    scaled = np.asarray(out) * n * (1.0 - rate)  # (b, n, h, n)
    return np.transpose(scaled, (0, 2, 1, 3))  # (b, h, n, n)


@pytest.mark.parametrize("seed", [0, 5, 123456])
def test_kernel_mask_is_the_reference_mask(seed):
    got = _kernel_mask(seed, 16, 0.25)
    want = np.asarray(dropout_keep_mask(seed, 2, 2, 16, 0.25), np.float32)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_keep_rate(rate):
    keep = np.asarray(dropout_keep_mask(9, 4, 12, 128, rate))
    assert abs(keep.mean() - (1.0 - rate)) < 0.01


def test_seed_changes_the_mask():
    a = np.asarray(dropout_keep_mask(1, 2, 2, 32, 0.5))
    b = np.asarray(dropout_keep_mask(2, 2, 2, 32, 0.5))
    assert 0.3 < (a != b).mean() < 0.7


def test_batch_offset_selects_global_rows():
    """A batch split over devices draws the whole batch's mask: rows
    [2, 4) of a 4-row mask == a 2-row mask at offset 2."""
    whole = np.asarray(dropout_keep_mask(3, 4, 2, 16, 0.3))
    part = np.asarray(dropout_keep_mask(3, 2, 2, 16, 0.3, batch_offset=2))
    np.testing.assert_array_equal(whole[2:], part)
    got = _kernel_mask(3, 16, 0.3, batch_offset=2)
    np.testing.assert_allclose(got, whole[2:].astype(np.float32), atol=1e-5)


def test_dropout_preserves_expectation():
    """Inverted dropout: averaged over seeds, the output approaches the
    no-dropout output (1/(1-p) scaling)."""
    q, k, v = _qkv((1, 16, 1, 16), seed=5)
    clean = np.asarray(attention_reference(q, k, v))
    mean = np.mean([
        np.asarray(attention_reference(q, k, v, dropout_rate=0.5, seed=s))
        for s in range(200)
    ], axis=0)
    assert np.abs(mean - clean).max() < 0.1


@pytest.mark.parametrize("kwargs,match", [
    (dict(dropout_rate=1.0), "dropout_rate"),
    (dict(dropout_rate=-0.1), "dropout_rate"),
    (dict(interpret=False), "head_dim"),
])
def test_argument_errors(kwargs, match):
    q, k, v = _qkv((1, 8, 1, 12))
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, v, **kwargs)


def test_shape_mismatch_raises():
    q, k, _ = _qkv((1, 8, 1, 16))
    with pytest.raises(ValueError, match="shapes differ"):
        flash_attention(q, k[:, :4], k)


# -- models/layers.attention --------------------------------------------------


def test_dispatch_rejects_unknown_impl():
    from triad.models.layers import attention

    q, k, v = _qkv((1, 8, 1, 16))
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(q, k, v, None, jnp.float32, impl="bogus")


@pytest.mark.parametrize("kwargs,error,match", [
    # cuDNN draws dropout only from a static seed: refused, not ignored.
    (dict(dropout_rate=0.1, dropout_rng=jax.random.key(0)), ValueError,
     "cannot draw per-step dropout"),
    # No cuDNN on this machine: the call raises instead of falling back.
    (dict(), RuntimeError, "cuDNN"),
])
def test_dispatch_cudnn_raises_what_it_cannot_run(kwargs, error, match):
    from triad.models.layers import attention

    q, k, v = _qkv((1, 8, 1, 16))
    with pytest.raises(error, match=match):
        attention(q, k, v, None, jnp.float32, impl="cudnn", **kwargs)


@pytest.mark.parametrize("how", ["argument", "default"])
def test_compiled_kernel_refuses_a_cpu(how):
    """Off the interpreter the kernel compiles for a GPU only: on the CPU
    it raises rather than running anywhere else."""
    import triad.ops.flash_attention as fa

    q, k, v = _qkv((1, 8, 1, 16))
    kwargs = dict(interpret=False) if how == "argument" else {}
    fa.use_interpreter(how != "default")
    try:
        with pytest.raises(ValueError, match="interpret mode"):
            jax.jit(lambda q, k, v: flash_attention(q, k, v, **kwargs))(
                q, k, v)
    finally:
        fa.use_interpreter(True)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_dispatch_dropout_needs_an_rng(impl):
    """A rate without an rng is deterministic (eval); with one the
    output changes with the key."""
    from triad.models.layers import attention

    q, k, v = _qkv((2, 16, 2, 16))
    base = attention(q, k, v, None, jnp.float32, impl=impl)
    same = attention(q, k, v, None, jnp.float32, impl=impl, dropout_rate=0.5)
    np.testing.assert_array_equal(np.asarray(base), np.asarray(same))
    d1 = attention(q, k, v, None, jnp.float32, impl=impl, dropout_rate=0.5,
                   dropout_rng=jax.random.key(1))
    d2 = attention(q, k, v, None, jnp.float32, impl=impl, dropout_rate=0.5,
                   dropout_rng=jax.random.key(2))
    assert not np.allclose(np.asarray(d1), np.asarray(d2))


@pytest.mark.parametrize("masked", [False, True])
def test_flash_under_mesh_is_shard_mapped(masked):
    """Inside a 4-device mesh context the kernel runs under shard_map
    over the batch and gives the single-device values, dropout mask
    included (each shard draws its global rows)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from triad.models.layers import attention

    q, k, v = _qkv((4, 16, 2, 16))
    mask = (_key_mask(4, 16) > 0)[:, None, None, :] if masked else None
    rng = jax.random.key(0)

    def f(q, k, v):
        return attention(q, k, v, mask, jnp.float32, impl="flash",
                         dropout_rate=0.2, dropout_rng=rng)

    single = f(q, k, v)
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    put = lambda x: jax.device_put(x, NamedSharding(mesh, P("data")))
    with jax.sharding.use_abstract_mesh(mesh.abstract_mesh):
        lowered = jax.jit(f).lower(put(q), put(k), put(v))
    text = lowered.as_text()
    assert "shard_map" in text or "sdy.manual" in text
    sharded = lowered.compile()(put(q), put(k), put(v))
    np.testing.assert_allclose(
        np.asarray(sharded), np.asarray(single), atol=1e-6
    )
