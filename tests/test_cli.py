"""CLI config-building tests: YAML + dotted overrides + deep merge."""

import argparse
import json

import pytest

from triad.cli.train import apply_overrides, build_config


def _ns(**kw):
    base = dict(config=None, set=None, output_dir=None, steps=None)
    base.update(kw)
    return argparse.Namespace(**base)


def test_defaults():
    cfg = build_config(_ns())
    assert cfg.data.batch_size_av == 22
    assert cfg.loss.matmul_precision == "highest"


def test_dotted_overrides():
    cfg = build_config(_ns(set=[
        "train.num_epochs=3",
        "data.batch_size_av=16",
        "loss.matmul_precision=\"default\"",
        "model.hubert.conv_dim=[16,16]",
    ]))
    assert cfg.train.num_epochs == 3
    assert cfg.data.batch_size_av == 16
    assert cfg.loss.matmul_precision == "default"
    assert cfg.model.hubert.conv_dim == (16, 16)


def test_yaml_config(tmp_path):
    f = tmp_path / "c.yaml"
    f.write_text("train:\n  num_epochs: 7\nmesh:\n  num_devices: 4\n")
    cfg = build_config(_ns(config=str(f)))
    assert cfg.train.num_epochs == 7
    assert cfg.mesh.num_devices == 4


def test_override_beats_file(tmp_path):
    f = tmp_path / "c.yaml"
    f.write_text("train:\n  num_epochs: 7\n")
    cfg = build_config(_ns(config=str(f), set=["train.num_epochs=2"]))
    assert cfg.train.num_epochs == 2


def test_bad_override_rejected():
    with pytest.raises(ValueError):
        apply_overrides({}, ["no_equals_sign"])


def test_unknown_key_rejected():
    with pytest.raises(KeyError):
        build_config(_ns(set=["train.not_a_field=1"]))


@pytest.mark.slow
def test_infer_cli_trimodal(tmp_path):
    """cli.infer: the reference's generic forward surface
    (model.py:610-637) from the command line — all three modalities,
    all pairwise sim matrices incl. text<->audio, npz features."""
    import json

    import numpy as np

    from tests.test_multimodal import small_model_config
    from triad.cli.infer import main as infer_main
    from triad.core.config import Config, DataConfig
    import dataclasses

    cfg = Config(
        model=small_model_config(),
        data=DataConfig(image_size=28, audio_num_samples=1600,
                        max_text_tokens=8),
    )
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    import cv2

    rng = np.random.default_rng(0)
    img_path = tmp_path / "img.jpg"
    cv2.imwrite(
        str(img_path),
        rng.integers(0, 255, size=(32, 32, 3)).astype(np.uint8),
    )
    out_json = tmp_path / "out.json"
    npz = tmp_path / "feats.npz"
    infer_main([
        "--random-init", "--config", str(cfg_path),
        "--image", str(img_path), "--text", "a dog",
        "--out", str(out_json), "--features-npz", str(npz),
    ])
    summary = json.loads(out_json.read_text())
    assert "vis_text_sim_matrix" in summary
    feats = np.load(npz)
    assert feats["visual_feats"].shape[-1] == 32
    # int8 serving mode end to end
    infer_main([
        "--random-init", "--config", str(cfg_path),
        "--image", str(img_path), "--text", "a dog", "--int8",
        "--out", str(out_json),
    ])
    assert "vis_text_sim_matrix" in json.loads(out_json.read_text())
