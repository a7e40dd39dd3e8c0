"""Tensor parallelism (parallel/tp.py): Megatron column/row param specs
over a ('data', 'model') mesh must leave the training semantics exactly
DP's — GSPMD inserts the collectives, the numbers don't move.

The reference has no model parallelism (single GPU, SURVEY §2.6); the
oracle is therefore our own single-device step, which test_parallel.py
already pins against the torch formulas.
"""

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
    def test_megatron_rules(self, params):
        from triad.parallel.tp import tp_param_specs

        specs = tp_param_specs(params, 2)
        au = specs["audio_backbone"]["layer_0"]
        # column-parallel: out dim sharded, bias sharded
        assert au["attention"]["q_proj"]["kernel"] == P(None, "model")
        assert au["attention"]["q_proj"]["bias"] == P("model")
        assert au["intermediate_dense"]["kernel"] == P(None, "model")
        # row-parallel: in dim sharded, bias replicated
        assert au["attention"]["out_proj"]["kernel"] == P("model", None)
        assert au["attention"]["out_proj"]["bias"] == P()
        assert au["output_dense"]["kernel"] == P("model", None)
        # DistilBERT names
        tx = specs["text_backbone"]["layer_0"]
        assert tx["attention"]["k_lin"]["kernel"] == P(None, "model")
        assert tx["ffn"]["fc2"]["kernel"] == P("model", None)
        # vocab-sharded embeddings
        assert specs["text_backbone"]["word_embeddings"] == P("model", None)
        # ViT fused qkv stays replicated; ViT MLP shards
        vb = specs["visual_backbone"]["block_0"]
        assert vb["attn"]["qkv"]["kernel"] == P()
        assert vb["attn"]["qkv"]["lora_a"] == P()
        assert vb["mlp"]["fc1"]["kernel"] == P(None, "model")
        assert vb["mlp"]["fc2"]["kernel"] == P("model", None)
        # norms / scalars replicated
        assert au["layer_norm"]["scale"] == P()
        assert specs["temperature"] == P()

    def test_indivisible_dims_replicate(self, params):
        from triad.parallel.tp import tp_param_specs

        specs = tp_param_specs(params, 7)  # nothing divides by 7
        leaves = jax.tree.leaves(
            specs, is_leaf=lambda s: isinstance(s, P)
        )
        assert all(s == P() for s in leaves)

    def test_resolve_xla_impls(self):
        from triad.parallel.tp import resolve_xla_impls

        cfg = _small_cfg()
        assert resolve_xla_impls(cfg) is cfg
        bad = dataclasses.replace(
            cfg, hubert=dataclasses.replace(cfg.hubert, attention_impl="flash")
        )
        with pytest.raises(ValueError, match="hubert.attention_impl"):
            resolve_xla_impls(bad)


class TestStepEquivalence:
    """dp4 x tp2 joint train step == single-device, params bit-close."""

    def test_joint_step_matches_single_device(self, params):
        from triad.core.config import LossConfig, OptimConfig
        from triad.parallel.distributed import put_global_tree
        from triad.parallel.tp import (
            make_dp_tp_mesh,
            tp_param_specs,
            tp_state_shardings,
        )
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

        B = 8
        rng = np.random.default_rng(0)
        av = {
            "images": rng.normal(size=(B, 28, 28, 3)).astype(np.float32),
            "audio": (rng.normal(size=(B, 800)) * 0.1).astype(np.float32),
        }
        tv = {
            "images": rng.normal(size=(B, 28, 28, 3)).astype(np.float32),
            "token_ids": rng.integers(1, 100, size=(B, 8)).astype(np.int32),
            "text_mask": np.ones((B, 8), np.float32),
        }
        one = jnp.float32(1.0)

        f0 = StepFactory(model_cfg, loss_cfg, optim_cfg, bank, mesh=None)
        s0 = init_train_state(params, bank, jax.random.key(1))
        ns0, m0 = jax.jit(f0.make_step("joint"))(
            s0,
            {k: jnp.asarray(v) for k, v in av.items()},
            {k: jnp.asarray(v) for k, v in tv.items()},
            one, one,
        )

        mesh = make_dp_tp_mesh(8, 2)
        f1 = StepFactory(
            model_cfg, loss_cfg, optim_cfg, bank, mesh=mesh, mesh_axis="data"
        )
        s1 = init_train_state(params, bank, jax.random.key(1))
        specs = tp_param_specs(params, 2)
        s1 = put_global_tree(s1, tp_state_shardings(s1, mesh, specs))
        sh = NamedSharding(mesh, P("data"))
        ns1, m1 = jax.jit(f1.make_step("joint"))(
            s1,
            {k: jax.device_put(jnp.asarray(v), sh) for k, v in av.items()},
            {k: jax.device_put(jnp.asarray(v), sh) for k, v in tv.items()},
            one, one,
        )

        np.testing.assert_allclose(
            float(m0["train_loss"]), float(m1["train_loss"]), rtol=2e-5
        )
        ref = dict(jax.tree_util.tree_leaves_with_path(ns0.params))
        for path, leaf in jax.tree_util.tree_leaves_with_path(ns1.params):
            np.testing.assert_allclose(
                np.asarray(leaf), np.asarray(ref[path]),
                rtol=5e-5, atol=1e-5,
                err_msg=jax.tree_util.keystr(path),
            )

        # updated params KEPT their TP sharding (GSPMD propagated it
        # through the whole fwd/bwd/update; no silent re-replication)
        q = ns1.params["audio_backbone"]["layer_0"]["attention"]["q_proj"]
        assert q["kernel"].sharding.is_equivalent_to(
            NamedSharding(mesh, P(None, "model")), 2
        )
        fc2 = ns1.params["visual_backbone"]["block_0"]["mlp"]["fc2"]
        assert fc2["kernel"].sharding.is_equivalent_to(
            NamedSharding(mesh, P("model", None)), 2
        )


@pytest.mark.slow
def test_trainer_tp_matches_dp(tmp_path):
    """Production Trainer with MeshConfig(num_devices=8, tp=2): final
    params match the tp=1 (pure DP) run."""
    from tests.test_trainer import tiny_config
    from triad.core.config import MeshConfig
    from triad.train.trainer import Trainer

    def run(tp: int, out):
        cfg = tiny_config(out)
        cfg = dataclasses.replace(
            cfg,
            mesh=MeshConfig(num_devices=8, tp=tp),
            data=dataclasses.replace(
                cfg.data, batch_size_av=8, batch_size_tv=8,
                synthetic_av_size=16, synthetic_tv_size=16,
            ),
        )
        t = Trainer(cfg, force_new_training=True)
        t.train()
        return t.state.params

    p_dp = run(1, tmp_path / "dp")
    p_tp = run(2, tmp_path / "tp")
    ref = dict(jax.tree_util.tree_leaves_with_path(p_dp))
    for path, leaf in jax.tree_util.tree_leaves_with_path(p_tp):
        np.testing.assert_allclose(
            np.asarray(leaf), np.asarray(ref[path]),
            rtol=1e-4, atol=1e-5, err_msg=jax.tree_util.keystr(path),
        )


class TestZero1TpComposition:
    """ZeRO-1 x TP (parallel/zero.py param_specs path): moments inherit
    their param's Megatron spec AND shard over 'data' on a free dim;
    the step's numbers must not move."""

    def test_moment_shardings_combine_axes(self, params):
        from triad.core.config import OptimConfig
        from triad.parallel.tp import make_dp_tp_mesh, tp_param_specs
        from triad.parallel.zero import zero1_state_shardings
        from triad.train import (
            OptimizerBank,
            ParamPartition,
            init_train_state,
        )

        optim_cfg = OptimConfig(gradient_accumulation_steps=2)
        partition = ParamPartition(params)
        bank = OptimizerBank(optim_cfg, partition, total_updates=100)
        state = init_train_state(params, bank, jax.random.key(1))
        mesh = make_dp_tp_mesh(8, 2)
        specs = tp_param_specs(params, 2)
        sh = zero1_state_shardings(
            state, mesh, "data", param_specs=specs, partition=partition
        )
        # params keep the pure TP spec (replicated over 'data')
        assert sh.params["audio_backbone"]["layer_0"]["attention"][
            "q_proj"]["kernel"].spec == P(None, "model")
        # find the q_proj.kernel moment in the 'audio' group's mu list:
        # its spec must use BOTH axes (kernel (32, 32): tp=2 on dim 1,
        # data=4 on dim 0)
        flat, _ = jax.tree_util.tree_flatten_with_path(sh.opt)
        combined = [
            s for p, s in flat
            if hasattr(s, "spec")
            and set(jax.tree.leaves(tuple(s.spec))) >= {"data", "model"}
        ]
        assert combined, "no moment sharded over both axes"
        # grad accumulator follows the same rule
        acc = sh.grad_accum["audio_backbone"]["layer_0"]["attention"][
            "q_proj"]["kernel"]
        assert acc.spec == P("data", "model")

    def test_step_matches_single_device(self, params):
        from triad.core.config import LossConfig, OptimConfig
        from triad.parallel.tp import make_dp_tp_mesh, tp_param_specs
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
            gradient_accumulation_steps=1, unfreeze_audio_step=0,
            unfreeze_text_step=0, unfreeze_vit_step=0,
        )
        partition = ParamPartition(params)
        bank = OptimizerBank(optim_cfg, partition, total_updates=100)

        B = 8
        rng = np.random.default_rng(3)
        av = {
            "images": rng.normal(size=(B, 28, 28, 3)).astype(np.float32),
            "audio": (rng.normal(size=(B, 800)) * 0.1).astype(np.float32),
        }
        one = jnp.float32(1.0)

        f0 = StepFactory(model_cfg, loss_cfg, optim_cfg, bank, mesh=None)
        s0 = init_train_state(params, bank, jax.random.key(1))
        ns0, m0 = jax.jit(f0.make_step("av"))(
            s0, {k: jnp.asarray(v) for k, v in av.items()}, None, one, one
        )

        mesh = make_dp_tp_mesh(8, 2)
        f1 = StepFactory(
            model_cfg, loss_cfg, optim_cfg, bank, mesh=mesh, mesh_axis="data"
        )
        s1 = init_train_state(params, bank, jax.random.key(1))
        s1 = apply_zero1(
            s1, mesh, "data",
            param_specs=tp_param_specs(params, 2), partition=partition,
        )
        sh = NamedSharding(mesh, P("data"))
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


class TestMultisliceTP:
    """TP composed with the multi-slice layout: a 3-D (replica, data,
    model) mesh — batch + loss collectives over the (replica, data)
    tuple, Megatron params over 'model', optional ZeRO-1 moments over
    the tuple on top. 2x2x2 on the 8-device CPU mesh must reproduce the
    single-device step exactly (values + updated params)."""

    def test_step_matches_single_device(self, params):
        from triad.core.config import LossConfig, OptimConfig
        from triad.parallel.tp import (
            make_multislice_tp_mesh,
            tp_param_specs,
        )
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
            gradient_accumulation_steps=1, unfreeze_audio_step=0,
            unfreeze_text_step=0, unfreeze_vit_step=0,
        )
        partition = ParamPartition(params)
        bank = OptimizerBank(optim_cfg, partition, total_updates=100)

        B = 8
        rng = np.random.default_rng(7)
        av = {
            "images": rng.normal(size=(B, 28, 28, 3)).astype(np.float32),
            "audio": (rng.normal(size=(B, 800)) * 0.1).astype(np.float32),
        }
        one = jnp.float32(1.0)

        f0 = StepFactory(model_cfg, loss_cfg, optim_cfg, bank, mesh=None)
        s0 = init_train_state(params, bank, jax.random.key(1))
        ns0, m0 = jax.jit(f0.make_step("av"))(
            s0, {k: jnp.asarray(v) for k, v in av.items()}, None, one, one
        )

        mesh = make_multislice_tp_mesh(2, 2, 2)
        axis = ("replica", "data")
        f1 = StepFactory(
            model_cfg, loss_cfg, optim_cfg, bank, mesh=mesh, mesh_axis=axis
        )
        s1 = init_train_state(params, bank, jax.random.key(1))
        s1 = apply_zero1(
            s1, mesh, axis,
            param_specs=tp_param_specs(params, 2), partition=partition,
        )
        sh = NamedSharding(mesh, P(axis))
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

    def test_trainer_level(self, tmp_path):
        """The production Trainer at mesh(tp=2, num_slices=2): one
        epoch of synthetic training runs, params move, loss finite."""
        import dataclasses as dc

        from tests.test_trainer import tiny_config
        from triad.core.config import MeshConfig
        from triad.train.trainer import Trainer

        cfg = tiny_config(tmp_path)
        cfg = dc.replace(
            cfg,
            mesh=MeshConfig(num_devices=8, tp=2, num_slices=2),
            data=dc.replace(
                cfg.data, batch_size_av=8, batch_size_tv=8,
                synthetic_av_size=16, synthetic_tv_size=16,
            ),
        )
        tr = Trainer(cfg, force_new_training=True)
        assert tr.mesh.shape == {"replica": 2, "data": 2, "model": 2}
        assert tr.mesh_axis == ("replica", "data")
        t0 = float(tr.state.params["temperature"])
        tr.train()
        import math

        from triad.parallel.distributed import fetch

        t1 = float(fetch(tr.state.params["temperature"]))
        assert t0 != t1
        losses = [
            float(x) for x in jax.tree.leaves(tr.last_epoch_losses)
        ] if hasattr(tr, "last_epoch_losses") else []
        assert all(math.isfinite(v) for v in losses)
