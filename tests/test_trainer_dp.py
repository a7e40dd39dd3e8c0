"""Trainer on an 8-device DP mesh (synthetic data): trains end-to-end
with the all-gathered-negatives losses — BASELINE config 5's structure
on the virtual CPU mesh."""

import dataclasses

import numpy as np
import pytest
import jax

from triad.core.config import MeshConfig
from tests.test_trainer import tiny_config

pytestmark = [pytest.mark.slow, pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)]


def test_dp_trainer_end_to_end(tmp_path):
    from triad.train.trainer import Trainer

    cfg = tiny_config(tmp_path)
    cfg = dataclasses.replace(
        cfg,
        mesh=MeshConfig(num_devices=8),
        data=dataclasses.replace(
            cfg.data, batch_size_av=8, batch_size_tv=8,
            synthetic_av_size=16, synthetic_tv_size=16,
        ),
    )
    trainer = Trainer(cfg, force_new_training=True)
    assert trainer.mesh is not None
    trainer.train()
    assert trainer.ckpt.latest_step() == 3
    assert np.isfinite(float(trainer.state.params["temperature"]))


def test_dp_rejects_indivisible_batch(tmp_path):
    from triad.train.trainer import Trainer

    cfg = tiny_config(tmp_path / "bad")
    cfg = dataclasses.replace(
        cfg,
        mesh=MeshConfig(num_devices=8),
        data=dataclasses.replace(cfg.data, batch_size_av=6),
    )
    with pytest.raises(ValueError, match="not divisible"):
        Trainer(cfg, force_new_training=True)


def test_multislice_dp_trainer(tmp_path):
    """2 slices x 4 chips (virtual): batch shards over (replica, data),
    negatives gather across both axes — trains end-to-end."""
    from triad.train.trainer import Trainer

    cfg = tiny_config(tmp_path)
    cfg = dataclasses.replace(
        cfg,
        mesh=MeshConfig(num_devices=8, num_slices=2),
        data=dataclasses.replace(
            cfg.data, batch_size_av=8, batch_size_tv=8,
            synthetic_av_size=16, synthetic_tv_size=16,
        ),
    )
    trainer = Trainer(cfg, force_new_training=True)
    assert trainer.mesh is not None and trainer.mesh.shape["replica"] == 2
    trainer.train()
    assert np.isfinite(float(trainer.state.params["temperature"]))


def test_dp_sharded_retrieval_matches_single_device(tmp_path):
    """The retrieval embedding shards its batches over the mesh
    (Trainer._shard_eval_input); metrics must equal the single-device
    trainer's on the same params + subset."""
    import json

    from triad.train.trainer import Trainer

    def build(mesh_cfg, out):
        cfg = tiny_config(out)
        cfg = dataclasses.replace(
            cfg,
            mesh=mesh_cfg,
            data=dataclasses.replace(
                cfg.data, batch_size_av=8, batch_size_tv=8,
                synthetic_av_size=16, synthetic_tv_size=16,
            ),
            train=dataclasses.replace(
                cfg.train, retrieval_subset_size=16,
                output_dir=str(out / "run"),
            ),
        )
        t = Trainer(cfg, force_new_training=True)
        # identical persisted subsets (selection is random otherwise)
        for name in ("retrieval_subset_av.json", "retrieval_subset_tv.json"):
            (t.output_dir / name).write_text(json.dumps(list(range(16))))
        return t

    ref = build(MeshConfig(), tmp_path / "single")
    m_ref = ref.eval_1000_way_retrieval()
    dp = build(MeshConfig(num_devices=8), tmp_path / "dp")
    m_dp = dp.eval_1000_way_retrieval()
    assert m_ref.keys() == m_dp.keys() and len(m_ref) > 0
    for k in m_ref:
        np.testing.assert_allclose(m_dp[k], m_ref[k], atol=1e-6, err_msg=k)
