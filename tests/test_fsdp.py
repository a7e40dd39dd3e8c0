"""FSDP / ZeRO-3 parameter sharding (parallel/fsdp.py): params stored
sharded over 'data', GSPMD gathers at use — the numbers must not move
vs the single-device step (same oracle discipline as test_tp.py)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)


def _small_cfg():
    from tests.test_multimodal import small_model_config

    return small_model_config()


@pytest.fixture(scope="module")
def params():
    from triad.models import init_triad_model

    return init_triad_model(_small_cfg(), jax.random.key(0))


class TestSpecs:
    def test_large_leaves_shard_small_replicate(self, params):
        from triad.parallel.dp import make_mesh
        from triad.parallel.fsdp import fsdp_param_specs

        mesh = make_mesh(8)
        specs = fsdp_param_specs(params, mesh)
        au = specs["audio_backbone"]["layer_0"]
        # (32, 64) kernel: largest dim 64 sharded over data
        assert au["intermediate_dense"]["kernel"] == P(None, "data")
        # (32,) bias: numel < min_size -> replicated
        assert au["intermediate_dense"]["bias"] == P()
        # (100, 32) embeddings: vocab 100 % 8 != 0 -> falls back to the
        # hidden dim (any divisible dim keeps the leaf sharded)
        assert specs["text_backbone"]["word_embeddings"] == P(None, "data")
        assert specs["temperature"] == P()

    def test_extends_tp_base_specs(self, params):
        from triad.parallel.fsdp import fsdp_param_specs
        from triad.parallel.tp import make_dp_tp_mesh, tp_param_specs

        mesh = make_dp_tp_mesh(8, 2)  # data=4, model=2
        base = tp_param_specs(params, 2)
        specs = fsdp_param_specs(params, mesh, base_specs=base)
        au = specs["audio_backbone"]["layer_0"]
        # column-parallel kernel (32, 32): model on dim 1 + data on dim 0
        assert au["attention"]["q_proj"]["kernel"] == P("data", "model")
        # row-parallel kernel (64, 32): model on dim 0 + data on dim 1
        assert au["output_dense"]["kernel"] == P("model", "data")
        # already data-free small leaves keep their base spec
        assert au["attention"]["out_proj"]["bias"] == P()


class TestStepEquivalence:
    def _batch(self):
        B = 8
        rng = np.random.default_rng(5)
        return {
            "images": rng.normal(size=(B, 28, 28, 3)).astype(np.float32),
            "audio": (rng.normal(size=(B, 800)) * 0.1).astype(np.float32),
        }

    def _single_device(self, params, av):
        from triad.core.config import LossConfig, OptimConfig
        from triad.train import (
            OptimizerBank,
            ParamPartition,
            StepFactory,
            init_train_state,
        )

        model_cfg = _small_cfg()
        loss_cfg = LossConfig(implementation="chunked", chunk_size=2)
        optim_cfg = OptimConfig(
            gradient_accumulation_steps=1, unfreeze_audio_step=0,
            unfreeze_text_step=0, unfreeze_vit_step=0,
        )
        partition = ParamPartition(params)
        bank = OptimizerBank(optim_cfg, partition, total_updates=100)
        f0 = StepFactory(model_cfg, loss_cfg, optim_cfg, bank, mesh=None)
        s0 = init_train_state(params, bank, jax.random.key(1))
        one = jnp.float32(1.0)
        return jax.jit(f0.make_step("av"))(
            s0, {k: jnp.asarray(v) for k, v in av.items()}, None, one, one
        ), (model_cfg, loss_cfg, optim_cfg, partition, bank)

    @pytest.mark.parametrize("tp", [1, 2])
    def test_fsdp_step_matches_single_device(self, params, tp):
        from triad.parallel.dp import make_mesh
        from triad.parallel.fsdp import fsdp_param_specs
        from triad.parallel.tp import make_dp_tp_mesh, tp_param_specs
        from triad.parallel.zero import apply_zero1
        from triad.train import StepFactory, init_train_state

        av = self._batch()
        (ns0, m0), (model_cfg, loss_cfg, optim_cfg, partition, bank) = (
            self._single_device(params, av)
        )

        mesh = make_dp_tp_mesh(8, 2) if tp == 2 else make_mesh(8)
        base = (
            tp_param_specs(params, 2) if tp == 2
            else jax.tree.map(lambda _: P(), params)
        )
        specs = fsdp_param_specs(params, mesh, base_specs=base)
        f1 = StepFactory(
            model_cfg, loss_cfg, optim_cfg, bank, mesh=mesh, mesh_axis="data"
        )
        s1 = init_train_state(params, bank, jax.random.key(1))
        s1 = apply_zero1(
            s1, mesh, "data", param_specs=specs, partition=partition
        )
        sh = NamedSharding(mesh, P("data"))
        one = jnp.float32(1.0)
        ns1, m1 = jax.jit(f1.make_step("av"))(
            s1, {k: jax.device_put(jnp.asarray(v), sh) for k, v in av.items()},
            None, one, one,
        )
        np.testing.assert_allclose(
            float(m0["train_loss"]), float(m1["train_loss"]), rtol=2e-5
        )
        ref = dict(jax.tree_util.tree_leaves_with_path(ns0.params))
        for path, leaf in jax.tree_util.tree_leaves_with_path(ns1.params):
            np.testing.assert_allclose(
                np.asarray(leaf), np.asarray(ref[path]),
                rtol=5e-5, atol=1e-5, err_msg=jax.tree_util.keystr(path),
            )
        # params stayed FSDP-sharded through the update
        k = ns1.params["audio_backbone"]["layer_0"]["intermediate_dense"][
            "kernel"]
        assert "data" in jax.tree.leaves(tuple(k.sharding.spec)), k.sharding


@pytest.mark.slow
def test_trainer_fsdp_matches_dp(tmp_path):
    """Production Trainer with MeshConfig(num_devices=8, fsdp=True):
    final params match the plain-DP run."""
    from tests.test_trainer import tiny_config
    from triad.core.config import MeshConfig
    from triad.train.trainer import Trainer

    def run(mesh_cfg, out):
        cfg = tiny_config(out)
        cfg = dataclasses.replace(
            cfg,
            mesh=mesh_cfg,
            data=dataclasses.replace(
                cfg.data, batch_size_av=8, batch_size_tv=8,
                synthetic_av_size=16, synthetic_tv_size=16,
            ),
        )
        t = Trainer(cfg, force_new_training=True)
        t.train()
        return t.state.params

    p_dp = run(MeshConfig(num_devices=8), tmp_path / "dp")
    p_fsdp = run(
        MeshConfig(num_devices=8, fsdp=True), tmp_path / "fsdp"
    )
    ref = dict(jax.tree_util.tree_leaves_with_path(p_dp))
    for path, leaf in jax.tree_util.tree_leaves_with_path(p_fsdp):
        np.testing.assert_allclose(
            np.asarray(leaf), np.asarray(ref[path]),
            rtol=1e-4, atol=1e-5, err_msg=jax.tree_util.keystr(path),
        )


def test_fsdp_accumulation_step_matches_single_device(params):
    """Gradient accumulation (accum=2, grad_accum buffer sharded like
    the params) under FSDP: two micro steps == the single-device pair."""
    from triad.core.config import LossConfig, OptimConfig
    from triad.parallel.dp import make_mesh
    from triad.parallel.fsdp import fsdp_param_specs
    from triad.parallel.zero import apply_zero1
    from triad.train import (
        OptimizerBank,
        ParamPartition,
        StepFactory,
        init_train_state,
    )

    model_cfg = _small_cfg()
    loss_cfg = LossConfig(implementation="chunked", chunk_size=2)
    optim_cfg = OptimConfig(
        gradient_accumulation_steps=2, unfreeze_audio_step=0,
        unfreeze_text_step=0, unfreeze_vit_step=0,
    )
    partition = ParamPartition(params)
    bank = OptimizerBank(optim_cfg, partition, total_updates=100)
    B = 8
    rng = np.random.default_rng(11)
    batches = [
        {
            "images": rng.normal(size=(B, 28, 28, 3)).astype(np.float32),
            "audio": (rng.normal(size=(B, 800)) * 0.1).astype(np.float32),
        }
        for _ in range(2)
    ]
    one = jnp.float32(1.0)

    f0 = StepFactory(model_cfg, loss_cfg, optim_cfg, bank, mesh=None)
    s0 = init_train_state(params, bank, jax.random.key(1))
    step0 = jax.jit(f0.make_step("av"))
    for av in batches:
        s0, m0 = step0(
            s0, {k: jnp.asarray(v) for k, v in av.items()}, None, one, one
        )

    mesh = make_mesh(8)
    specs = fsdp_param_specs(params, mesh)
    f1 = StepFactory(
        model_cfg, loss_cfg, optim_cfg, bank, mesh=mesh, mesh_axis="data"
    )
    s1 = init_train_state(params, bank, jax.random.key(1))
    s1 = apply_zero1(s1, mesh, "data", param_specs=specs, partition=partition)
    sh = NamedSharding(mesh, P("data"))
    step1 = jax.jit(f1.make_step("av"))
    for av in batches:
        s1, m1 = step1(
            s1, {k: jax.device_put(jnp.asarray(v), sh) for k, v in av.items()},
            None, one, one,
        )

    np.testing.assert_allclose(
        float(m0["train_loss"]), float(m1["train_loss"]), rtol=2e-5
    )
    ref = dict(jax.tree_util.tree_leaves_with_path(s0.params))
    for path, leaf in jax.tree_util.tree_leaves_with_path(s1.params):
        np.testing.assert_allclose(
            np.asarray(leaf), np.asarray(ref[path]),
            rtol=5e-5, atol=1e-5, err_msg=jax.tree_util.keystr(path),
        )


class TestMultisliceFSDP:
    """FSDP composed with the multi-slice layout: FSDP shards live over
    'data' ONLY (intra-slice gathers), params replicate across
    'replica', batch + loss ride the (replica, data) tuple. 2x4 on the
    8-device CPU mesh must reproduce the single-device step."""

    def test_step_matches_single_device(self, params):
        from triad.parallel.dp import make_multislice_mesh
        from triad.parallel.fsdp import fsdp_param_specs
        from triad.parallel.zero import apply_zero1
        from triad.train import StepFactory, init_train_state

        helper = TestStepEquivalence()
        av = helper._batch()
        (ns0, m0), (model_cfg, loss_cfg, optim_cfg, partition, bank) = (
            helper._single_device(params, av)
        )

        mesh = make_multislice_mesh(2, 4)
        axis = ("replica", "data")
        specs = fsdp_param_specs(params, mesh, data_axis="data")
        f1 = StepFactory(
            model_cfg, loss_cfg, optim_cfg, bank, mesh=mesh, mesh_axis=axis
        )
        s1 = init_train_state(params, bank, jax.random.key(1))
        s1 = apply_zero1(
            s1, mesh, axis, param_specs=specs, partition=partition
        )
        sh = NamedSharding(mesh, P(axis))
        one = jnp.float32(1.0)
        ns1, m1 = jax.jit(f1.make_step("av"))(
            s1,
            {k: jax.device_put(jnp.asarray(v), sh) for k, v in av.items()},
            None, one, one,
        )
        np.testing.assert_allclose(
            float(m0["train_loss"]), float(m1["train_loss"]), rtol=2e-5
        )
        ref = dict(jax.tree_util.tree_leaves_with_path(ns0.params))
        for path, leaf in jax.tree_util.tree_leaves_with_path(ns1.params):
            np.testing.assert_allclose(
                np.asarray(leaf), np.asarray(ref[path]),
                rtol=5e-5, atol=1e-5, err_msg=jax.tree_util.keystr(path),
            )
        # sharded over 'data' (intra-slice), replicated over 'replica'
        k = ns1.params["audio_backbone"]["layer_0"]["intermediate_dense"][
            "kernel"]
        leaves = jax.tree.leaves(tuple(k.sharding.spec))
        assert "data" in leaves and "replica" not in leaves, k.sharding

    def test_trainer_level(self, tmp_path):
        """Production Trainer at mesh(fsdp=True, num_slices=2)."""
        import dataclasses as dc
        import math

        from tests.test_trainer import tiny_config
        from triad.core.config import MeshConfig
        from triad.parallel.distributed import fetch
        from triad.train.trainer import Trainer

        cfg = tiny_config(tmp_path)
        cfg = dc.replace(
            cfg,
            mesh=MeshConfig(num_devices=8, fsdp=True, num_slices=2),
            data=dc.replace(
                cfg.data, batch_size_av=8, batch_size_tv=8,
                synthetic_av_size=16, synthetic_tv_size=16,
            ),
        )
        tr = Trainer(cfg, force_new_training=True)
        assert tr.mesh.shape == {"replica": 2, "data": 4}
        assert tr.mesh_axis == ("replica", "data")
        t0 = float(fetch(tr.state.params["temperature"]))
        tr.train()
        t1 = float(fetch(tr.state.params["temperature"]))
        assert t0 != t1 and math.isfinite(t1)
