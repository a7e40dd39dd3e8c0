"""Config helpers: the perf presets, the shipped scale YAML, and the
loader's handling of retired and unknown fields."""

import dataclasses
from pathlib import Path

import pytest

from triad.core.config import ModelConfig, h100_model_config

REPO = Path(__file__).resolve().parent.parent


def test_perf_train_config_is_the_measured_knob_set():
    # The choice on the H100: the flash kernel with in-kernel dropout in
    # the ViT and HuBERT, XLA for the 32 text tokens, parity defaults
    # elsewhere (PERF.md).
    base = ModelConfig()
    expected = dataclasses.replace(
        base,
        vit=dataclasses.replace(base.vit, attention_impl="flash"),
        hubert=dataclasses.replace(base.hubert, attention_impl="flash"),
    )
    assert h100_model_config() == expected


def test_perf_eval_config_uses_flash_attention():
    cfg = h100_model_config()
    assert (cfg.vit.attention_impl, cfg.hubert.attention_impl,
            cfg.text.attention_impl) == ("flash", "flash", "xla")
    from triad.core.config import perf_eval_loss_config

    assert perf_eval_loss_config().implementation == "chunked_unrolled"
    assert perf_eval_loss_config().chunk_size == 32
    assert perf_eval_loss_config().volume_dtype == "bfloat16"


def test_perf_presets_keep_parity_defaults_elsewhere():
    # The preset may only touch kernel-dispatch / numerics-contract
    # knobs — architecture fields must match the parity defaults.
    base, preset = ModelConfig(), h100_model_config()
    assert preset.hubert.num_layers == base.hubert.num_layers
    assert preset.vit.num_layers == base.vit.num_layers
    assert preset.hubert.conv_dim == base.hubert.conv_dim
    assert preset.embedding_dim == base.embedding_dim
    assert preset.compute_dtype == base.compute_dtype
    assert preset.param_dtype == base.param_dtype


def _scale_config():
    from triad.cli.train import _deep_update, load_config_file
    from triad.core.config import Config

    cfg_dict = load_config_file(str(REPO / "configs" / "h100_scale.yaml"))
    base = Config().to_dict()
    _deep_update(base, cfg_dict)
    return Config.from_dict(base)


def test_scale_yaml_resolves_to_tuned_train_kernels():
    cfg = _scale_config()
    assert cfg.model == h100_model_config()
    assert cfg.mesh.num_devices == 4
    assert cfg.data.batch_size_av == 256


@pytest.mark.parametrize("section,field", [
    ("hubert", "mlp_impl"), ("hubert", "posconv_impl"),
    ("hubert", "frontend_wave_layout"), ("vit", "attention_pad"),
    ("vit", "mlp_block_rows"),
])
def test_retired_fields_are_dropped_on_load(section, field):
    """A config saved with a field that selected a removed kernel loads
    with that field dropped (old checkpoints carry them)."""
    from triad.core.config import Config

    d = Config().to_dict()
    d["model"][section][field] = "anything"
    assert Config.from_dict(d) == Config()


def test_unknown_field_still_raises():
    from triad.core.config import Config

    d = Config().to_dict()
    d["model"]["hubert"]["not_a_field"] = 1
    with pytest.raises(KeyError, match="not_a_field"):
        Config.from_dict(d)


def test_perf_train_loss_config_matches_yaml():
    """perf_train_loss_config() and configs/h100_scale.yaml must agree —
    one source of truth for the codified training loss path."""
    from triad.core.config import perf_train_loss_config

    cfg = _scale_config()
    helper = perf_train_loss_config()
    assert cfg.loss.implementation == helper.implementation
    assert cfg.loss.chunk_size == helper.chunk_size
    assert cfg.loss.matmul_precision == helper.matmul_precision
    assert cfg.loss.volume_dtype == helper.volume_dtype
