"""Distributed-loss tests on the 8-device CPU mesh: the sharded
computation must equal the single-device global computation (values,
stats, and gradients) — SURVEY §2.6 / §4 multi-device test requirement."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from triad.core.config import LossConfig
from triad.ops import av_loss, tv_loss
from triad.parallel import distributed_av_loss, distributed_tv_loss, make_mesh

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)

B, NA, NT, NV, D = 16, 23, 12, 9, 16
TEMP = 1.5


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


@pytest.fixture(scope="module")
def feats(mesh):
    rng = np.random.default_rng(0)
    shard = lambda x: jax.device_put(
        jnp.asarray(x), NamedSharding(mesh, P("data"))
    )
    audio = rng.normal(size=(B, NA, D)).astype(np.float32) * 0.4
    text = rng.normal(size=(B, NT, D)).astype(np.float32) * 0.4
    visual = rng.normal(size=(B, NV, D)).astype(np.float32) * 0.4
    lengths = rng.integers(2, NT + 1, size=B)
    mask = (np.arange(NT)[None] < lengths[:, None]).astype(np.float32)
    return {
        "audio_np": audio, "text_np": text, "visual_np": visual, "mask_np": mask,
        "audio": shard(audio), "text": shard(text), "visual": shard(visual),
        "mask": shard(mask),
    }


class TestDistributedAV:
    def test_matches_single_device(self, mesh, feats):
        cfg = LossConfig(implementation="chunked", chunk_size=4)
        dist = jax.jit(
            lambda a, v, t: distributed_av_loss(a, v, t, cfg, mesh)
        )(feats["audio"], feats["visual"], jnp.float32(TEMP))
        ref = av_loss(
            jnp.asarray(feats["audio_np"]), jnp.asarray(feats["visual_np"]),
            jnp.float32(TEMP), LossConfig(implementation="dense"),
        )
        np.testing.assert_allclose(dist.total, ref.total, rtol=1e-5)
        np.testing.assert_allclose(dist.contrastive, ref.contrastive, rtol=1e-5)
        np.testing.assert_allclose(dist.reg, ref.reg, rtol=1e-5)
        np.testing.assert_allclose(dist.smooth, ref.smooth, rtol=1e-4, atol=1e-8)
        for k in ref.stats:
            np.testing.assert_allclose(
                dist.stats[k], ref.stats[k], rtol=1e-4, atol=1e-6,
                err_msg=k,
            )

    def test_gradients_match_single_device(self, mesh, feats):
        cfg = LossConfig(implementation="chunked", chunk_size=4)

        def dist_loss(a, v, t):
            return distributed_av_loss(a, v, t, cfg, mesh).total

        def ref_loss(a, v, t):
            return av_loss(a, v, t, LossConfig(implementation="dense")).total

        ga = jax.jit(jax.grad(dist_loss, argnums=(0, 1, 2)))(
            feats["audio"], feats["visual"], jnp.float32(TEMP)
        )
        gr = jax.grad(ref_loss, argnums=(0, 1, 2))(
            jnp.asarray(feats["audio_np"]), jnp.asarray(feats["visual_np"]),
            jnp.float32(TEMP),
        )
        for a, b in zip(ga, gr):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-7
            )


class TestDistributedTV:
    def test_matches_single_device(self, mesh, feats):
        cfg = LossConfig(implementation="chunked", chunk_size=4)
        dist = jax.jit(
            lambda te, v, m, t: distributed_tv_loss(te, v, m, t, cfg, mesh)
        )(feats["text"], feats["visual"], feats["mask"], jnp.float32(TEMP))
        ref = tv_loss(
            jnp.asarray(feats["text_np"]), jnp.asarray(feats["visual_np"]),
            jnp.asarray(feats["mask_np"]), jnp.float32(TEMP),
            LossConfig(implementation="dense"),
        )
        np.testing.assert_allclose(dist.total, ref.total, rtol=1e-5)
        np.testing.assert_allclose(dist.reg, ref.reg, rtol=1e-5)
        for k in ref.stats:
            np.testing.assert_allclose(
                dist.stats[k], ref.stats[k], rtol=1e-4, atol=1e-6, err_msg=k
            )


class TestZero1:
    @pytest.mark.slow
    def test_zero1_matches_replicated_and_shards_moments(self, mesh):
        """ZeRO-1 sharded optimizer state: same training trajectory as
        the replicated state (up to collective reduction order), with
        moment leaves actually partitioned over the data axis."""
        import dataclasses

        from triad.core.config import OptimConfig
        from triad.parallel.zero import apply_zero1, zero1_state_shardings
        from triad.train import (
            OptimizerBank,
            ParamPartition,
            StepFactory,
            init_train_state,
        )
        from tests.test_multimodal import small_model_config

        cfg = small_model_config()
        optim_cfg = OptimConfig(
            gradient_accumulation_steps=1,
            unfreeze_audio_step=0, unfreeze_text_step=0, unfreeze_vit_step=0,
        )
        from triad.models import init_triad_model

        params = init_triad_model(cfg, jax.random.key(0))
        part = ParamPartition(params)
        bank = OptimizerBank(optim_cfg, part, total_updates=100)
        factory = StepFactory(cfg, LossConfig(), optim_cfg, bank, mesh=mesh)
        step = jax.jit(factory.make_step("joint"))

        B = 8
        rng = np.random.default_rng(0)
        data_shard = NamedSharding(mesh, P("data"))
        av = {
            "images": jax.device_put(
                jnp.asarray(rng.normal(size=(B, 28, 28, 3)).astype(np.float32)),
                data_shard,
            ),
            "audio": jax.device_put(
                jnp.asarray((rng.normal(size=(B, 1600)) * 0.1).astype(np.float32)),
                data_shard,
            ),
        }
        tv = {
            "images": jax.device_put(
                jnp.asarray(rng.normal(size=(B, 28, 28, 3)).astype(np.float32)),
                data_shard,
            ),
            "token_ids": jax.device_put(
                jnp.asarray(rng.integers(1, 90, size=(B, 12)).astype(np.int32)),
                data_shard,
            ),
            "text_mask": jax.device_put(
                jnp.ones((B, 12), jnp.float32), data_shard
            ),
        }
        one = jnp.float32(1.0)

        def run(state):
            for _ in range(3):
                state, m = step(state, av, tv, one, one)
            return state, m

        base = init_train_state(params, bank, jax.random.key(1))
        s_rep, m_rep = run(jax.device_put(base, NamedSharding(mesh, P())))
        s_z, m_z = run(apply_zero1(base, mesh))

        # identical trajectories
        diffs = jax.tree.map(
            lambda a, b: float(jnp.max(jnp.abs(
                a.astype(jnp.float32) - b.astype(jnp.float32)
            ))),
            s_rep.params, s_z.params,
        )
        # Not bitwise: XLA may lower the cross-chip grad reduction as
        # reduce-scatter (+ gather) instead of all-reduce when the
        # consumer is sharded — a different summation order. Tiny fp
        # noise after 3 steps is the expected signature.
        assert max(jax.tree.leaves(diffs)) < 1e-4
        assert abs(float(m_rep["train_loss"]) - float(m_z["train_loss"])) < 1e-4

        # moments actually sharded: find a large mu leaf and check it is
        # partitioned (not fully replicated) across the mesh.
        shardings = zero1_state_shardings(base, mesh)
        mu_leaves = jax.tree.leaves(s_z.opt.adam["others"][0].mu)
        big = [x for x in mu_leaves if x.ndim >= 2 and x.shape[0] % 8 == 0]
        assert big, "expected at least one shardable moment leaf"
        for x in big:
            assert not x.sharding.is_fully_replicated
        del shardings


class TestMultiSlice:
    def test_multislice_av_loss_matches_single_device(self):
        """(2 x 4) replica/data mesh: distributed AV loss over the tuple
        axis equals the single-device loss on the concatenated batch."""
        import numpy as np

        from triad.parallel.dp import (
            distributed_av_loss,
            make_multislice_mesh,
        )

        mesh = make_multislice_mesh(2, 4)
        B, Na, Nv, D = 8, 6, 5, 16
        rng = np.random.default_rng(2)
        a = jnp.asarray(rng.normal(size=(B, Na, D)).astype(np.float32) * 0.3)
        v = jnp.asarray(rng.normal(size=(B, Nv, D)).astype(np.float32) * 0.3)
        temp = jnp.float32(1.5)
        cfg = LossConfig(implementation="dense")

        ref = av_loss(a, v, temp, cfg)
        sharded = NamedSharding(mesh, P(("replica", "data")))
        out = jax.jit(
            lambda a, v: distributed_av_loss(
                a, v, temp, cfg, mesh, axis=("replica", "data")
            )
        )(jax.device_put(a, sharded), jax.device_put(v, sharded))
        np.testing.assert_allclose(
            float(out.total), float(ref.total), rtol=1e-5
        )
        np.testing.assert_allclose(
            float(out.contrastive), float(ref.contrastive), rtol=1e-5
        )
        for k in ref.stats:
            np.testing.assert_allclose(
                float(out.stats[k]), float(ref.stats[k]), rtol=1e-4,
                err_msg=k,
            )


    def test_multislice_chunked_vjp_grads_match(self):
        """Tuple-axis (check_vma=False) mesh with the custom-VJP loss:
        gradients equal the single-device dense path."""
        import numpy as np

        from triad.parallel.dp import (
            distributed_av_loss,
            make_multislice_mesh,
        )

        mesh = make_multislice_mesh(2, 4)
        B, Na, Nv, D = 8, 6, 5, 16
        rng = np.random.default_rng(3)
        a = jnp.asarray(rng.normal(size=(B, Na, D)).astype(np.float32) * 0.3)
        v = jnp.asarray(rng.normal(size=(B, Nv, D)).astype(np.float32) * 0.3)
        temp = jnp.float32(1.5)
        cfg = LossConfig(implementation="chunked_vjp", chunk_size=2)
        sharded = NamedSharding(mesh, P(("replica", "data")))

        def dist(a, v, t):
            return distributed_av_loss(
                a, v, t, cfg, mesh, axis=("replica", "data")
            ).total

        ga = jax.jit(jax.grad(dist, argnums=(0, 1, 2)))(
            jax.device_put(a, sharded), jax.device_put(v, sharded), temp
        )
        gr = jax.grad(
            lambda a, v, t: av_loss(
                a, v, t, LossConfig(implementation="dense")
            ).total,
            argnums=(0, 1, 2),
        )(a, v, temp)
        for x, y in zip(ga, gr):
            np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), rtol=1e-4, atol=1e-7
            )


class TestDistributedChunkedVJP:
    def test_av_gradients_match_single_device(self, mesh, feats):
        """implementation="chunked_vjp" (hand-written loss backward)
        under shard_map: distributed gradients == single-device dense."""
        cfg = LossConfig(implementation="chunked_vjp", chunk_size=4)

        def dist_loss(a, v, t):
            return distributed_av_loss(a, v, t, cfg, mesh).total

        def ref_loss(a, v, t):
            return av_loss(a, v, t, LossConfig(implementation="dense")).total

        ga = jax.jit(jax.grad(dist_loss, argnums=(0, 1, 2)))(
            feats["audio"], feats["visual"], jnp.float32(TEMP)
        )
        gr = jax.grad(ref_loss, argnums=(0, 1, 2))(
            jnp.asarray(feats["audio_np"]), jnp.asarray(feats["visual_np"]),
            jnp.float32(TEMP),
        )
        for a, b in zip(ga, gr):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-7
            )

    def test_tv_values_match_single_device(self, mesh, feats):
        cfg = LossConfig(implementation="chunked_vjp", chunk_size=4)
        dist = jax.jit(
            lambda te, v, m, t: distributed_tv_loss(te, v, m, t, cfg, mesh)
        )(feats["text"], feats["visual"], feats["mask"], jnp.float32(TEMP))
        ref = tv_loss(
            jnp.asarray(feats["text_np"]), jnp.asarray(feats["visual_np"]),
            jnp.asarray(feats["mask_np"]), jnp.float32(TEMP),
            LossConfig(implementation="dense"),
        )
        np.testing.assert_allclose(dist.total, ref.total, rtol=1e-5)


class TestRingNegatives:
    """negatives="ring" (ppermuted key shards) must equal the
    all-gather path — values and gradients — at any global batch."""

    def test_av_values_and_grads_match_all_gather(self, mesh, feats):
        ring = LossConfig(
            implementation="chunked", chunk_size=4, negatives="ring"
        )
        ag = LossConfig(implementation="chunked", chunk_size=4)

        def loss(cfg):
            return lambda a, v, t: distributed_av_loss(
                a, v, t, cfg, mesh
            ).total

        args = (feats["audio"], feats["visual"], jnp.float32(TEMP))
        out_r = jax.jit(loss(ring))(*args)
        out_a = jax.jit(loss(ag))(*args)
        np.testing.assert_allclose(float(out_r), float(out_a), rtol=1e-6)
        gr = jax.jit(jax.grad(loss(ring), argnums=(0, 1, 2)))(*args)
        ga = jax.jit(jax.grad(loss(ag), argnums=(0, 1, 2)))(*args)
        for x, y in zip(gr, ga):
            np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), rtol=1e-5, atol=1e-7
            )

    def test_tv_masked_values_match(self, mesh, feats):
        ring = LossConfig(
            implementation="chunked_vjp", chunk_size=4, negatives="ring"
        )
        dist = jax.jit(
            lambda te, v, m, t: distributed_tv_loss(te, v, m, t, ring, mesh)
        )(feats["text"], feats["visual"], feats["mask"], jnp.float32(TEMP))
        ref = tv_loss(
            jnp.asarray(feats["text_np"]), jnp.asarray(feats["visual_np"]),
            jnp.asarray(feats["mask_np"]), jnp.float32(TEMP),
            LossConfig(implementation="dense"),
        )
        np.testing.assert_allclose(
            float(dist.total), float(ref.total), rtol=1e-5
        )
        np.testing.assert_allclose(
            float(dist.reg), float(ref.reg), rtol=1e-5
        )

    def test_av_grads_ring_chunked_vjp_match_dense(self, mesh, feats):
        """The production combination — ring negatives + the custom-VJP
        loss backward (ppermute transpose through the custom bwd scan):
        gradients equal single-device dense."""
        cfg = LossConfig(
            implementation="chunked_vjp", chunk_size=4, negatives="ring"
        )

        def dist_loss(a, v, t):
            return distributed_av_loss(a, v, t, cfg, mesh).total

        ga = jax.jit(jax.grad(dist_loss, argnums=(0, 1, 2)))(
            feats["audio"], feats["visual"], jnp.float32(TEMP)
        )
        gr = jax.grad(
            lambda a, v, t: av_loss(
                a, v, t, LossConfig(implementation="dense")
            ).total,
            argnums=(0, 1, 2),
        )(
            jnp.asarray(feats["audio_np"]), jnp.asarray(feats["visual_np"]),
            jnp.float32(TEMP),
        )
        for x, y in zip(ga, gr):
            np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), rtol=1e-4, atol=1e-7
            )

    @pytest.mark.parametrize("negatives", ["all_gather", "ring"])
    def test_av_bf16_volume_grads_match_dense_bf16(
        self, mesh, feats, negatives
    ):
        """volume_dtype=bfloat16 through the DISTRIBUTED losses — the
        combination the codified perf config ships (notably the ring
        path nests the bf16-volume einsum inside the ring lax.scan body).
        Values and gradients must match the
        single-device dense bf16-volume oracle."""
        cfg = LossConfig(
            implementation="chunked", chunk_size=4, negatives=negatives,
            volume_dtype="bfloat16",
        )
        ref_cfg = LossConfig(
            implementation="dense", volume_dtype="bfloat16"
        )

        def dist_loss(a, v, t):
            return distributed_av_loss(a, v, t, cfg, mesh).total

        def ref_loss(a, v, t):
            return av_loss(a, v, t, ref_cfg).total

        args = (feats["audio"], feats["visual"], jnp.float32(TEMP))
        ref_args = (
            jnp.asarray(feats["audio_np"]), jnp.asarray(feats["visual_np"]),
            jnp.float32(TEMP),
        )
        np.testing.assert_allclose(
            float(jax.jit(dist_loss)(*args)), float(ref_loss(*ref_args)),
            rtol=1e-5,
        )
        gd = jax.jit(jax.grad(dist_loss, argnums=(0, 1, 2)))(*args)
        gr = jax.grad(ref_loss, argnums=(0, 1, 2))(*ref_args)
        # atol floor 1e-4: rounding the volume to bf16 creates EXACT
        # ties in the per-query max, and dense vs shard-chunked route
        # tied subgradients differently (measured max |Δ| ≈ 3e-5; a
        # real backward bug — e.g. the scan-transpose zero-cotangent
        # sharp edge — is 1e-3-scale and still trips this).
        for x, y in zip(gd, gr):
            np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), rtol=1e-4, atol=1e-4
            )

    def test_ring_rejects_tuple_axis(self, feats):
        from triad.parallel.dp import make_multislice_mesh

        mesh2 = make_multislice_mesh(2, 4)
        cfg = LossConfig(implementation="chunked", negatives="ring")
        sharded = NamedSharding(mesh2, P(("replica", "data")))
        a = jax.device_put(feats["audio_np"], sharded)
        v = jax.device_put(feats["visual_np"], sharded)
        with pytest.raises(ValueError, match="single mesh axis"):
            jax.jit(
                lambda a, v: distributed_av_loss(
                    a, v, jnp.float32(TEMP), cfg, mesh2,
                    axis=("replica", "data"),
                )
            )(a, v)


@pytest.mark.slow
def test_multiprocess_dp_matches_single_process():
    """Multi-host enablement end to end: 2 coordinated CPU processes x 4
    virtual devices each == the single-process 8-device mesh, final
    params bitwise-matching (scripts/multiproc_smoke.py: the loaders'
    process_shard row slicing + Trainer._put's
    make_array_from_process_local_data + put_global_tree state init)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "scripts", "multiproc_smoke.py")],
        # Generous: each gloo cold-cache retry re-runs a phase, and a
        # loaded 1-core machine (concurrent compiles) measured the smoke
        # exceeding 25 min while PASSING every phase it finished
        # (checksums matching) — the old 1500 s timeout failed the test
        # on wall clock, not correctness.
        env=env, cwd=repo, capture_output=True, text=True, timeout=3300,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "MULTIPROCESS SMOKE PASSED" in proc.stdout
