"""End-to-end trainer integration on synthetic data: a short run trains,
checkpoints mid-epoch, resumes exactly (step/params), validates, runs
retrieval, and writes viz artifacts + JSONL metrics (SURVEY §4
'synthetic-data integration tests')."""

import json
from pathlib import Path

import numpy as np
import pytest
import jax

from triad.core.config import (
    Config,
    DataConfig,
    LossConfig,
    OptimConfig,
    TrainConfig,
)
from tests.test_multimodal import small_model_config


def tiny_config(tmp_path, **train_kw):
    return Config(
        model=small_model_config(),
        loss=LossConfig(),
        data=DataConfig(
            audio_num_samples=1600,
            image_size=28,
            max_text_tokens=12,
            batch_size_av=2,
            batch_size_tv=2,
            num_workers=1,
            synthetic_av_size=8,
            synthetic_tv_size=8,
        ),
        train=TrainConfig(
            num_epochs=1,
            steps_per_epoch=3,
            av_focus_epochs=0,
            tv_warmup_epochs=0,
            weighted_joint_epochs=0,
            vis_every=10**9,
            save_every_steps=10**9,
            validation_frequency=10**9,
            retrieval_subset_size=4,
            num_vis_samples_av=2,
            num_vis_samples_tv=2,
            output_dir=str(tmp_path / "run"),
            optim=OptimConfig(
                gradient_accumulation_steps=1,
                unfreeze_audio_step=1,
                unfreeze_text_step=1,
                unfreeze_vit_step=1,
            ),
            **train_kw,
        ),
    )


# The tiny synthetic datasets use 28x28 images; SyntheticAVDataset and
# SyntheticTVDataset take image_size from DataConfig via the Trainer.


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("trainer")


@pytest.mark.slow
def test_trainer_end_to_end(run_dir):
    from triad.train.trainer import Trainer

    cfg = tiny_config(run_dir)
    # patch synthetic dataset image size through the config path
    trainer = Trainer(cfg, force_new_training=True)
    trainer.train()

    # metrics JSONL written with expected keys
    lines = [
        json.loads(l)
        for l in (Path(cfg.train.output_dir) / "metrics.jsonl").read_text().splitlines()
    ]
    assert any("train_loss" in l for l in lines)
    assert any(k.startswith("retrieval_") for l in lines for k in l)
    assert any(k.startswith("val_") for l in lines for k in l)

    # checkpoint exists and reports the final step
    assert trainer.ckpt.latest_step() == 3


@pytest.mark.slow
def test_device_augment_matches_host_augment(tmp_path):
    """data.device_augment=True (wire-dtype uint8/int16 batches, augment
    math on-device) trains through the production Trainer over a packed
    shard and matches the host-augment run's per-step losses (same
    (seed, epoch, batch, idx) draws; identical math within float32
    noise — tests/test_device_aug.py pins the op-level equality)."""
    import dataclasses

    from triad.data.datasets import SyntheticAVDataset
    from triad.data.packed import pack_dataset
    from triad.train.trainer import Trainer

    src = SyntheticAVDataset(size=8, image_size=28, audio_seconds=0.1)
    shard = str(tmp_path / "tiny.tpack")
    pack_dataset(src, shard, image_size=28, audio_samples=1600)

    losses = {}
    for devaug in (False, True):
        cfg = tiny_config(tmp_path / f"devaug_{devaug}")
        cfg = dataclasses.replace(
            cfg,
            data=dataclasses.replace(
                cfg.data,
                audio_visual_data_root=shard,
                device_augment=devaug,
            ),
        )
        trainer = Trainer(cfg, force_new_training=True)
        trainer.train()
        lines = [
            json.loads(l)
            for l in (
                Path(cfg.train.output_dir) / "metrics.jsonl"
            ).read_text().splitlines()
        ]
        losses[devaug] = [
            l["train_loss"] for l in lines if "train_loss" in l and "val_train_loss" not in l
        ]
    assert losses[True], "device-augment run logged no train steps"
    np.testing.assert_allclose(
        losses[True], losses[False], rtol=2e-4,
        err_msg="device-augment loss trajectory diverged from host path",
    )


@pytest.mark.slow
def test_resume_restores_state(run_dir):
    from triad.train.trainer import Trainer

    cfg = tiny_config(run_dir)
    resumed = Trainer(cfg, force_new_training=False)
    assert int(resumed.progress.global_step) == 3
    assert int(resumed.progress.epoch) == 1
    # resuming past num_epochs: train() is a no-op
    resumed.train()
    assert int(resumed.progress.global_step) == 3


def test_trainer_writes_viz(run_dir):
    from triad.train.trainer import Trainer

    cfg = tiny_config(run_dir)
    trainer = Trainer(cfg, force_new_training=False)
    trainer.visualize_samples(epoch=0, max_samples=1)
    viz_dir = Path(cfg.train.output_dir) / "viz" / "epoch_0"
    pngs = list(viz_dir.glob("*.png"))
    assert pngs, "no visualization artifacts written"


def test_phase_schedule():
    from triad.train.trainer import Trainer

    cfg = tiny_config(Path("/tmp/unused_phase_test")).train
    # emulate the reference curriculum values (train.py:1176-1180)
    import dataclasses

    tc = dataclasses.replace(
        cfg, av_focus_epochs=1, tv_warmup_epochs=1, weighted_joint_epochs=2,
        av_weight_start=0.8, av_weight_end=0.5, num_epochs=10,
    )
    full_cfg = dataclasses.replace(tiny_config(Path("/tmp/unused_phase_test")), train=tc)
    # phase_for_epoch is pure — call it unbound with a stub carrying config
    class Stub:
        config = full_cfg

    f = Trainer.phase_for_epoch
    assert f(Stub, 0)[0] == "av_focus"
    assert f(Stub, 1)[0] == "tv_warmup"
    phase, w_av, _ = f(Stub, 2)
    assert phase == "weighted_joint" and w_av == pytest.approx(0.8)
    phase, w_av, _ = f(Stub, 3)
    assert phase == "weighted_joint" and w_av == pytest.approx(0.65)
    assert f(Stub, 4)[0] == "full_joint"


@pytest.mark.slow
def test_retrieval_encoders_compile_once(run_dir):
    """eval_1000_way_retrieval must reuse the trainer's jitted encoders
    (fresh @jax.jit closures per call used to recompile the
    encoders on every periodic eval)."""
    from triad.train.trainer import Trainer

    cfg = tiny_config(run_dir)
    trainer = Trainer(cfg, force_new_training=False)
    trainer.eval_1000_way_retrieval()
    av_compiles = trainer._enc_av._cache_size()
    tv_compiles = trainer._enc_tv._cache_size()
    assert av_compiles == 1 and tv_compiles == 1
    trainer.eval_1000_way_retrieval()
    assert trainer._enc_av._cache_size() == av_compiles
    assert trainer._enc_tv._cache_size() == tv_compiles


@pytest.mark.slow
def test_validation_exhausts_unequal_loaders(tmp_path):
    """Round-2 weak #5: lockstep AV/TV validation ended at the SHORTER
    loader, silently dropping the longer val set's tail. The reference
    iterates each val loader fully and independently
    (train.py:710-832); with val AV = 6 batches and val TV = 4, every
    batch of both must be evaluated."""
    import dataclasses

    from triad.train.trainer import Trainer

    cfg = tiny_config(tmp_path)
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(
            cfg.data, synthetic_av_size=48, synthetic_tv_size=8
        ),
    )
    trainer = Trainer(cfg, force_new_training=True)
    # val sets are synthetic: max(8, size // 4) -> av 12, tv 8 items.
    assert len(trainer.val_av_dataset) == 12
    assert len(trainer.val_tv_dataset) == 8

    calls = {"av": 0, "tv": 0}
    real = dict(trainer._eval_steps)

    def counted(mode):
        def fn(*a, **kw):
            calls[mode] += 1
            return real[mode](*a, **kw)

        return fn

    trainer._eval_steps = {m: counted(m) for m in real}
    val = trainer.validate("full_joint")
    assert calls["av"] == 6, calls  # 12 items / batch_size_av 2
    assert calls["tv"] == 4, calls  # 8 items / batch_size_tv 2
    assert val is not None and np.isfinite(val)

    # max_batches caps each leg independently.
    calls["av"] = calls["tv"] = 0
    trainer.validate("full_joint", max_batches=2)
    assert calls == {"av": 2, "tv": 2}
