"""Golden-value tests for the loss ops against an independent torch oracle.

Pins the exact reference numerics (SURVEY §7.2 step 1) before any model
exists: clip sims, regularizers, InfoNCE, stats, and agreement between the
dense and chunked implementations (values and gradients).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from triad.core.config import LossConfig
from triad.ops import (
    aggregate_crossbatch,
    av_loss,
    pairwise_similarity,
    similarity_stats,
    tv_loss,
)
from tests.torch_oracle import (
    oracle_av_loss,
    oracle_pairwise_similarity,
    oracle_stats,
    oracle_tv_loss,
)

B, NA, NT, NV, D = 6, 37, 16, 25, 32
TEMP = 1.5


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(42)
    audio = rng.normal(size=(B, NA, D)).astype(np.float32) * 0.5
    text = rng.normal(size=(B, NT, D)).astype(np.float32) * 0.5
    visual = rng.normal(size=(B, NV, D)).astype(np.float32) * 0.5
    # Variable-length text mask with padding (valid lengths 3..NT).
    lengths = rng.integers(3, NT + 1, size=B)
    mask = (np.arange(NT)[None, :] < lengths[:, None]).astype(np.float32)
    return audio, text, visual, mask


def _cfg(impl="dense", **kw):
    return LossConfig(implementation=impl, **kw)


class TestAVLoss:
    def test_matches_torch_oracle(self, feats):
        audio, _, visual, _ = feats
        out = av_loss(jnp.asarray(audio), jnp.asarray(visual), jnp.float32(TEMP), _cfg())
        ref = oracle_av_loss(
            torch.from_numpy(audio), torch.from_numpy(visual), torch.tensor(TEMP)
        )
        np.testing.assert_allclose(out.total, ref["total"].numpy(), rtol=2e-5)
        np.testing.assert_allclose(
            out.contrastive, ref["contrastive"].numpy(), rtol=2e-5
        )
        np.testing.assert_allclose(out.reg, ref["reg"].numpy(), rtol=2e-5)
        # The smooth term differences adjacent near-equal sims (catastrophic
        # cancellation) so fp32 contraction-order noise is amplified.
        np.testing.assert_allclose(out.smooth, ref["smooth"].numpy(), rtol=1e-4, atol=1e-7)

    def test_stats_match_torch(self, feats):
        audio, _, visual, _ = feats
        out = av_loss(jnp.asarray(audio), jnp.asarray(visual), jnp.float32(TEMP), _cfg())
        ref = oracle_av_loss(
            torch.from_numpy(audio), torch.from_numpy(visual), torch.tensor(TEMP)
        )
        ref_stats = oracle_stats(ref["clip_sims"], "av")
        for k, v in ref_stats.items():
            # std/separation amplify fp32 contraction-order noise in the sims
            np.testing.assert_allclose(out.stats[k], v, rtol=1e-4, atol=1e-6)

    def test_temperature_calibration_active_below_one(self, feats):
        audio, _, visual, _ = feats
        lo = av_loss(jnp.asarray(audio), jnp.asarray(visual), jnp.float32(0.5), _cfg())
        ref = oracle_av_loss(
            torch.from_numpy(audio), torch.from_numpy(visual), torch.tensor(0.5)
        )
        np.testing.assert_allclose(lo.reg, ref["reg"].numpy(), rtol=2e-5)
        # The >2.0 branch is dead in the reference (model.py:422-424): a
        # temperature of 3.0 incurs no calibration penalty.
        hi = av_loss(jnp.asarray(audio), jnp.asarray(visual), jnp.float32(3.0), _cfg())
        ref_hi = oracle_av_loss(
            torch.from_numpy(audio), torch.from_numpy(visual), torch.tensor(3.0)
        )
        np.testing.assert_allclose(hi.reg, ref_hi["reg"].numpy(), rtol=2e-5)


class TestTVLoss:
    def test_matches_torch_oracle(self, feats):
        _, text, visual, mask = feats
        out = tv_loss(
            jnp.asarray(text),
            jnp.asarray(visual),
            jnp.asarray(mask),
            jnp.float32(TEMP),
            _cfg(),
        )
        ref = oracle_tv_loss(
            torch.from_numpy(text),
            torch.from_numpy(visual),
            torch.from_numpy(mask),
            torch.tensor(TEMP),
            threshold=0.8,
            weight=0.01,
        )
        np.testing.assert_allclose(out.total, ref["total"].numpy(), rtol=2e-5)
        np.testing.assert_allclose(out.reg, ref["reg"].numpy(), rtol=2e-5)

    def test_padding_changes_nothing_when_masked_and_zero(self, feats):
        """Zero-embedded padded tokens + mask must give the same clip sims
        as the unpadded computation (mask-invariance of the masked mean)."""
        _, text, visual, mask = feats
        cfg = _cfg()
        out = tv_loss(
            jnp.asarray(text * mask[:, :, None]),
            jnp.asarray(visual),
            jnp.asarray(mask),
            jnp.float32(TEMP),
            cfg,
        )
        # extend padding by 5 more zero tokens
        pad = np.zeros((B, 5, D), np.float32)
        text_p = np.concatenate([text * mask[:, :, None], pad], axis=1)
        mask_p = np.concatenate([mask, np.zeros((B, 5), np.float32)], axis=1)
        agg = aggregate_crossbatch(
            jnp.asarray(text_p),
            jnp.asarray(visual),
            jnp.float32(TEMP),
            clamp_min=-20.0,
            query_mask=jnp.asarray(mask_p),
        )
        agg0 = aggregate_crossbatch(
            jnp.asarray(text * mask[:, :, None]),
            jnp.asarray(visual),
            jnp.float32(TEMP),
            clamp_min=-20.0,
            query_mask=jnp.asarray(mask),
        )
        np.testing.assert_allclose(agg.clip_sims, agg0.clip_sims, rtol=1e-5, atol=1e-6)


class TestChunkedImplementation:
    @pytest.mark.parametrize("chunk", [1, 2, 3, 6])
    def test_values_match_dense(self, feats, chunk):
        audio, _, visual, _ = feats
        dense = av_loss(
            jnp.asarray(audio), jnp.asarray(visual), jnp.float32(TEMP), _cfg("dense")
        )
        chunked = av_loss(
            jnp.asarray(audio),
            jnp.asarray(visual),
            jnp.float32(TEMP),
            _cfg("chunked", chunk_size=chunk),
        )
        np.testing.assert_allclose(chunked.total, dense.total, rtol=1e-6)
        np.testing.assert_allclose(
            chunked.stats["av_separation"], dense.stats["av_separation"], rtol=1e-5
        )

    def test_gradients_match_dense(self, feats):
        audio, _, visual, _ = feats

        def loss_fn(impl):
            def f(a, v, t):
                return av_loss(a, v, t, _cfg(impl, chunk_size=2)).total

            return f

        args = (jnp.asarray(audio), jnp.asarray(visual), jnp.float32(TEMP))
        gd = jax.grad(loss_fn("dense"), argnums=(0, 1, 2))(*args)
        gc = jax.grad(loss_fn("chunked"), argnums=(0, 1, 2))(*args)
        for a, b in zip(gd, gc):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)

    def test_gradients_match_torch(self, feats):
        audio, _, visual, _ = feats
        ta = torch.from_numpy(audio).requires_grad_(True)
        tv = torch.from_numpy(visual).requires_grad_(True)
        tt = torch.tensor(TEMP, requires_grad=True)
        oracle_av_loss(ta, tv, tt)["total"].backward()

        def f(a, v, t):
            return av_loss(a, v, t, _cfg("chunked", chunk_size=3)).total

        ga, gv, gt = jax.grad(f, argnums=(0, 1, 2))(
            jnp.asarray(audio), jnp.asarray(visual), jnp.float32(TEMP)
        )
        np.testing.assert_allclose(ga, ta.grad.numpy(), rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(gv, tv.grad.numpy(), rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(gt, tt.grad.numpy(), rtol=2e-4, atol=1e-6)


class TestPairwiseSimilarity:
    def test_matches_torch(self, feats):
        audio, _, visual, _ = feats
        ours = pairwise_similarity(
            jnp.asarray(audio), jnp.asarray(visual), jnp.float32(TEMP)
        )
        ref = oracle_pairwise_similarity(
            torch.from_numpy(audio), torch.from_numpy(visual), torch.tensor(TEMP)
        )
        np.testing.assert_allclose(ours, ref.numpy(), rtol=1e-5, atol=1e-6)


class TestBf16VolumeOperands:
    """bf16 features: the loss matmuls run as bf16 x bf16 with fp32
    accumulation (DEFAULT precision) — numerically equal to casting to
    fp32 and running HIGHEST (bf16 products are exact in the fp32
    accumulator), at a fraction of the matmul cost. This test pins the
    equality."""

    def test_chunked_bf16_equals_fp32_highest(self):
        import jax.numpy as jnp

        from triad.ops.similarity import aggregate_crossbatch

        rng = np.random.default_rng(0)
        q16 = jnp.asarray(
            rng.normal(size=(4, 12, 256)).astype(np.float32), jnp.bfloat16
        )
        k16 = jnp.asarray(
            rng.normal(size=(4, 8, 256)).astype(np.float32), jnp.bfloat16
        )
        t = jnp.float32(1.5)
        fast = aggregate_crossbatch(
            q16, k16, t, clamp_min=-60.0, implementation="chunked",
            chunk_size=2,
        )
        slow = aggregate_crossbatch(
            q16.astype(jnp.float32), k16.astype(jnp.float32), t,
            clamp_min=-60.0, implementation="chunked", chunk_size=2,
        )
        np.testing.assert_allclose(
            np.asarray(fast.clip_sims), np.asarray(slow.clip_sims),
            rtol=1e-6, atol=1e-5,
        )
        np.testing.assert_allclose(
            float(fast.nonneg_sq_sum), float(slow.nonneg_sq_sum),
            rtol=1e-5,
        )

    def test_dense_bf16_equals_fp32_highest(self):
        import jax.numpy as jnp

        from triad.ops.similarity import aggregate_crossbatch

        rng = np.random.default_rng(1)
        q16 = jnp.asarray(
            rng.normal(size=(3, 6, 128)).astype(np.float32), jnp.bfloat16
        )
        k16 = jnp.asarray(
            rng.normal(size=(3, 5, 128)).astype(np.float32), jnp.bfloat16
        )
        mask = jnp.asarray(
            (np.arange(6)[None] < np.array([6, 4, 2])[:, None]), jnp.float32
        )
        t = jnp.float32(2.0)
        fast = aggregate_crossbatch(
            q16, k16, t, clamp_min=-20.0, query_mask=mask,
            implementation="dense",
        )
        slow = aggregate_crossbatch(
            q16.astype(jnp.float32), k16.astype(jnp.float32), t,
            clamp_min=-20.0, query_mask=mask, implementation="dense",
        )
        np.testing.assert_allclose(
            np.asarray(fast.clip_sims), np.asarray(slow.clip_sims),
            rtol=1e-6, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(fast.diag_token_sims),
            np.asarray(slow.diag_token_sims), rtol=1e-6, atol=1e-5,
        )


class TestBf16Volume:
    """volume_dtype="bfloat16": the token-sim volume is rounded to bf16
    between the matmul (still f32-accumulated) and its
    max/clamp consumers — halves the loss path's dominant HBM traffic
    (the eval bench's perf knob). Values must stay within bf16 rounding
    of the f32-volume path, and the chunked_vjp backward must recompute
    at the SAME volume dtype so its argmax routing matches its forward."""

    def _qkt(self, seed=0, bq=4, bk=4, nq=12, nk=8, d=128):
        rng = np.random.default_rng(seed)
        q = jnp.asarray(
            rng.normal(size=(bq, nq, d)).astype(np.float32), jnp.bfloat16
        )
        k = jnp.asarray(
            rng.normal(size=(bk, nk, d)).astype(np.float32), jnp.bfloat16
        )
        return q, k, jnp.float32(1.5)

    @pytest.mark.parametrize(
        "impl", ["dense", "chunked", "chunked_unrolled", "chunked_vjp"]
    )
    def test_bf16_volume_within_bf16_rounding(self, impl):
        from triad.ops.similarity import aggregate_crossbatch

        q, k, t = self._qkt()
        f32 = aggregate_crossbatch(
            q, k, t, clamp_min=-60.0, implementation=impl, chunk_size=2,
            precision="default",
        )
        bf16 = aggregate_crossbatch(
            q, k, t, clamp_min=-60.0, implementation=impl, chunk_size=2,
            precision="default", volume_dtype="bfloat16",
        )
        # bf16 has ~8 mantissa bits: 2^-8 relative on the max entries.
        np.testing.assert_allclose(
            np.asarray(bf16.clip_sims), np.asarray(f32.clip_sims),
            rtol=2 ** -7, atol=0.15,
        )
        np.testing.assert_allclose(
            float(bf16.nonneg_sq_sum), float(f32.nonneg_sq_sum),
            rtol=2 ** -6,
        )

    def test_vjp_bf16_forward_matches_chunked_bf16(self):
        from triad.ops.similarity import aggregate_crossbatch

        q, k, t = self._qkt(seed=3)
        a = aggregate_crossbatch(
            q, k, t, clamp_min=-60.0, implementation="chunked",
            chunk_size=2, precision="default", volume_dtype="bfloat16",
        )
        b = aggregate_crossbatch(
            q, k, t, clamp_min=-60.0, implementation="chunked_vjp",
            chunk_size=2, precision="default", volume_dtype="bfloat16",
        )
        # Not bit-exact by contract: the chunked forward reduces as
        # mean(max_sims) while the VJP forward computes sum(max_sims *
        # (1/Nq)) — algebraically equal, last-bit different in general
        # Tight allclose pins the equivalence.
        np.testing.assert_allclose(
            np.asarray(a.clip_sims), np.asarray(b.clip_sims),
            rtol=1e-6, atol=1e-7,
        )

    def test_bf16_grads_all_implementations_match_dense(self):
        """Gradients at volume_dtype=bfloat16: dense autodiff is the
        oracle; chunked, chunked_unrolled and the hand-written VJP must
        all match it. Also the regression pin for a real JAX sharp
        edge this test originally caught: lax.scan's transpose
        mis-handles a bf16 dot output inside the scanned body (all-zero
        cotangents under jax.checkpoint, NaN without) — the chunked
        path force-unrolls at bf16 volume for exactly this reason
        (similarity.aggregate_crossbatch)."""
        from triad.ops.similarity import aggregate_crossbatch

        q, k, t = self._qkt(seed=7)

        def grads(impl):
            def f(q_, k_, t_):
                agg = aggregate_crossbatch(
                    q_, k_, t_, clamp_min=-60.0, implementation=impl,
                    chunk_size=2, precision="default",
                    volume_dtype="bfloat16", compute_diag=False,
                )
                return (
                    jnp.sum(agg.clip_sims * jnp.cos(agg.clip_sims))
                    + agg.nonneg_sq_sum / agg.volume_numel
                )

            return jax.grad(f, argnums=(0, 1, 2))(q, k, t)

        oracle = grads("dense")
        assert all(
            bool(jnp.any(jnp.asarray(x, jnp.float32) != 0.0))
            for x in oracle
        ), "degenerate oracle"
        for impl in ("chunked", "chunked_unrolled", "chunked_vjp"):
            for x, y in zip(oracle, grads(impl)):
                # atol covers bf16 cotangent rounding: autodiff rounds
                # each chunk's dts to bf16 before the transpose matmul,
                # so near-zero grad elements carry ~2^-5-scale noise.
                np.testing.assert_allclose(
                    np.asarray(x, np.float32), np.asarray(y, np.float32),
                    rtol=2e-2, atol=6e-2,
                    err_msg=f"impl={impl}",
                )


class TestChunkedCustomVJP:
    """implementation="chunked_vjp": same forward as "chunked", hand-
    written backward (bf16-operand recompute, no autodiff residual
    stash — ops/similarity._maxmean_chunked_vjp)."""

    @pytest.mark.parametrize("chunk", [2, 3])
    def test_av_unrolled_matches_chunked(self, feats, chunk):
        """implementation="chunked_unrolled" = the chunked math with the
        scan Python-unrolled (XLA schedules chunks freely). Values and
        grads must match exactly."""
        audio, _, visual, _ = feats
        a, v = jnp.asarray(audio), jnp.asarray(visual)
        t = jnp.float32(TEMP)

        def f(impl):
            return lambda a, v, t: av_loss(
                a, v, t, _cfg(impl, chunk_size=chunk)
            ).total

        # Unrolling lets XLA reassociate the chunk-join reductions:
        # values agree to float32 rounding, not bit-exactly.
        np.testing.assert_allclose(
            np.asarray(f("chunked")(a, v, t)),
            np.asarray(f("chunked_unrolled")(a, v, t)),
            rtol=1e-6,
        )
        ga = jax.grad(f("chunked"), argnums=(0, 1, 2))(a, v, t)
        gb = jax.grad(f("chunked_unrolled"), argnums=(0, 1, 2))(a, v, t)
        for x, y in zip(ga, gb):
            np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), rtol=1e-6, atol=1e-7
            )

    @pytest.mark.parametrize("chunk", [1, 2, 3, 6])
    def test_av_values_match_chunked(self, feats, chunk):
        audio, _, visual, _ = feats
        a = av_loss(
            jnp.asarray(audio), jnp.asarray(visual), jnp.float32(TEMP),
            _cfg("chunked", chunk_size=chunk),
        )
        b = av_loss(
            jnp.asarray(audio), jnp.asarray(visual), jnp.float32(TEMP),
            _cfg("chunked_vjp", chunk_size=chunk),
        )
        np.testing.assert_allclose(b.total, a.total, rtol=1e-6)
        np.testing.assert_allclose(b.contrastive, a.contrastive, rtol=1e-6)

    def test_av_gradients_match_chunked_fp32(self, feats):
        audio, _, visual, _ = feats

        def f(impl):
            return lambda a, v, t: av_loss(
                a, v, t, _cfg(impl, chunk_size=2)
            ).total

        args = (jnp.asarray(audio), jnp.asarray(visual), jnp.float32(TEMP))
        ga = jax.grad(f("chunked"), argnums=(0, 1, 2))(*args)
        gb = jax.grad(f("chunked_vjp"), argnums=(0, 1, 2))(*args)
        for x, y in zip(ga, gb):
            np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-7)

    def test_tv_masked_gradients_match_chunked(self, feats):
        _, text, visual, mask = feats

        def f(impl):
            return lambda t, v, temp: tv_loss(
                t, v, jnp.asarray(mask), temp, _cfg(impl, chunk_size=3)
            ).total

        args = (jnp.asarray(text), jnp.asarray(visual), jnp.float32(TEMP))
        ga = jax.grad(f("chunked"), argnums=(0, 1, 2))(*args)
        gb = jax.grad(f("chunked_vjp"), argnums=(0, 1, 2))(*args)
        for x, y in zip(ga, gb):
            np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-7)

    def test_bf16_operands_gradients_close(self, feats):
        """bf16 features: the custom backward casts dts to bf16 for the
        dQ/dK matmuls (vs autodiff's mixed f32xbf16) — within bf16
        rounding of each other."""
        audio, _, visual, _ = feats
        a16 = jnp.asarray(audio, jnp.bfloat16)
        v16 = jnp.asarray(visual, jnp.bfloat16)

        def f(impl):
            return lambda a, v, t: av_loss(
                a, v, t, _cfg(impl, chunk_size=2)
            ).total

        ga = jax.grad(f("chunked"), argnums=(0, 1, 2))(
            a16, v16, jnp.float32(TEMP)
        )
        gb = jax.grad(f("chunked_vjp"), argnums=(0, 1, 2))(
            a16, v16, jnp.float32(TEMP)
        )
        for x, y in zip(ga, gb):
            x = np.asarray(x, np.float32)
            y = np.asarray(y, np.float32)
            scale = max(np.abs(x).max(), 1e-6)
            np.testing.assert_allclose(y, x, atol=0.02 * scale)

    def test_temperature_grad_matches_torch(self, feats):
        audio, _, visual, _ = feats
        ta = torch.from_numpy(audio).requires_grad_(True)
        tv = torch.from_numpy(visual).requires_grad_(True)
        tt = torch.tensor(TEMP, requires_grad=True)
        oracle_av_loss(ta, tv, tt)["total"].backward()

        def f(a, v, t):
            return av_loss(a, v, t, _cfg("chunked_vjp", chunk_size=3)).total

        ga, gv, gt = jax.grad(f, argnums=(0, 1, 2))(
            jnp.asarray(audio), jnp.asarray(visual), jnp.float32(TEMP)
        )
        np.testing.assert_allclose(ga, ta.grad.numpy(), rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(gv, tv.grad.numpy(), rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(gt, tt.grad.numpy(), rtol=2e-4, atol=1e-6)
