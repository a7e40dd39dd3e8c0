"""HF-snapshot weight import: per-backbone HF
snapshot directories (config.json + safetensors / sharded safetensors /
pytorch_model.bin) and the torch.hub DINOv2 .pth file all load through
models/hf_import.py into trees identical to the direct HF->Flax ports —
so on a machine with the real pretrained weights
(hubert-base-ls960 / distilbert-base-uncased / dinov2_vitb14_reg,
reference model.py:29-30, 79-80, 218) zero new code is needed."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tests.test_encoders import SMALL_HUBERT, SMALL_TEXT, SMALL_VIT
from tests.test_multimodal import small_model_config
from triad.models.hf_import import (
    init_params_from_pretrained,
    load_dinov2_snapshot,
    load_distilbert_snapshot,
    load_hubert_snapshot,
)
from triad.models.weights import (
    port_distilbert,
    port_dinov2,
    port_hubert,
)


def _small_cfg():
    return dataclasses.replace(
        small_model_config(),
        text=dataclasses.replace(small_model_config().text, vocab_size=120),
    )


@pytest.fixture(scope="module")
def hf_models():
    from transformers import (
        DistilBertConfig as HFDBConfig,
        DistilBertModel as HFDBModel,
        Dinov2WithRegistersConfig,
        Dinov2WithRegistersModel,
        HubertConfig as HFHuConfig,
        HubertModel as HFHuModel,
    )

    torch.manual_seed(0)
    hub = HFHuModel(
        HFHuConfig(
            hidden_size=SMALL_HUBERT["hidden_size"],
            num_hidden_layers=SMALL_HUBERT["num_layers"],
            num_attention_heads=SMALL_HUBERT["num_heads"],
            intermediate_size=SMALL_HUBERT["intermediate_size"],
            conv_dim=list(SMALL_HUBERT["conv_dim"])[:2],
            conv_kernel=list(SMALL_HUBERT["conv_kernel"])[:2],
            conv_stride=list(SMALL_HUBERT["conv_stride"])[:2],
            num_feat_extract_layers=2,
            num_conv_pos_embeddings=SMALL_HUBERT["num_conv_pos_embeddings"],
            num_conv_pos_embedding_groups=SMALL_HUBERT[
                "num_conv_pos_embedding_groups"
            ],
            do_stable_layer_norm=False,
            feat_extract_norm="group",
            conv_bias=False,
        )
    ).eval()
    db = HFDBModel(
        HFDBConfig(
            vocab_size=SMALL_TEXT["vocab_size"],
            dim=SMALL_TEXT["hidden_size"],
            n_layers=SMALL_TEXT["num_layers"],
            n_heads=SMALL_TEXT["num_heads"],
            hidden_dim=SMALL_TEXT["intermediate_size"],
            max_position_embeddings=SMALL_TEXT["max_position_embeddings"],
        )
    ).eval()
    vit = Dinov2WithRegistersModel(
        Dinov2WithRegistersConfig(
            image_size=SMALL_VIT["image_size"],
            patch_size=SMALL_VIT["patch_size"],
            hidden_size=SMALL_VIT["hidden_size"],
            num_hidden_layers=SMALL_VIT["num_layers"],
            num_attention_heads=SMALL_VIT["num_heads"],
            num_register_tokens=SMALL_VIT["num_register_tokens"],
            mlp_ratio=4,
            layerscale_value=1.0,
        )
    ).eval()
    return hub, db, vit


def _assert_trees_equal(got, want):
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = dict(
        ("/".join(map(str, p)), l)
        for p, l in jax.tree_util.tree_leaves_with_path(want)
    )
    assert len(gl) == len(wl)
    for p, leaf in gl:
        np.testing.assert_array_equal(
            np.asarray(leaf), np.asarray(wl["/".join(map(str, p))])
        )


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
def test_hubert_snapshot_roundtrip(hf_models, tmp_path, safe):
    hub, _, _ = hf_models
    d = tmp_path / "hubert"
    hub.save_pretrained(d, safe_serialization=safe)
    cfg = _small_cfg()
    got = load_hubert_snapshot(str(d), cfg)
    _assert_trees_equal(got, port_hubert(hub))


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
def test_distilbert_snapshot_roundtrip(hf_models, tmp_path, safe):
    _, db, _ = hf_models
    d = tmp_path / "distilbert"
    db.save_pretrained(d, safe_serialization=safe)
    got = load_distilbert_snapshot(str(d), _small_cfg())
    _assert_trees_equal(got, port_distilbert(db))


def test_sharded_safetensors_snapshot(hf_models, tmp_path):
    """HF hub snapshots of large models ship sharded (an index json +
    N shard files) — from_pretrained must reassemble them."""
    _, db, _ = hf_models
    d = tmp_path / "distilbert_sharded"
    db.save_pretrained(d, safe_serialization=True, max_shard_size="50KB")
    assert os.path.exists(d / "model.safetensors.index.json")
    got = load_distilbert_snapshot(str(d), _small_cfg())
    _assert_trees_equal(got, port_distilbert(db))


def test_dinov2_hf_snapshot(hf_models, tmp_path):
    _, _, vit = hf_models
    d = tmp_path / "dinov2"
    vit.save_pretrained(d, safe_serialization=True)
    cfg = _small_cfg()
    got = load_dinov2_snapshot(str(d), cfg)
    _assert_trees_equal(got, port_dinov2(vit, lora_rank=cfg.vit.lora_rank))


def _hub_pth_state(vit):
    """The torch.hub dinov2_vitb14_reg checkpoint layout: plain
    DinoVisionTransformer names, qkv fused, plus a mask_token we must
    ignore."""
    emb = vit.embeddings
    s = {
        "cls_token": emb.cls_token,
        "register_tokens": emb.register_tokens,
        "pos_embed": emb.position_embeddings,
        "mask_token": torch.zeros(1, emb.cls_token.shape[-1]),
        "patch_embed.proj.weight": emb.patch_embeddings.projection.weight,
        "patch_embed.proj.bias": emb.patch_embeddings.projection.bias,
        "norm.weight": vit.layernorm.weight,
        "norm.bias": vit.layernorm.bias,
    }
    for i, layer in enumerate(vit.encoder.layer):
        a = layer.attention.attention
        p = f"blocks.{i}."
        s[p + "attn.qkv.weight"] = torch.cat(
            [a.query.weight, a.key.weight, a.value.weight], dim=0
        )
        s[p + "attn.qkv.bias"] = torch.cat(
            [a.query.bias, a.key.bias, a.value.bias], dim=0
        )
        s[p + "attn.proj.weight"] = layer.attention.output.dense.weight
        s[p + "attn.proj.bias"] = layer.attention.output.dense.bias
        s[p + "norm1.weight"] = layer.norm1.weight
        s[p + "norm1.bias"] = layer.norm1.bias
        s[p + "ls1.gamma"] = layer.layer_scale1.lambda1
        s[p + "norm2.weight"] = layer.norm2.weight
        s[p + "norm2.bias"] = layer.norm2.bias
        s[p + "ls2.gamma"] = layer.layer_scale2.lambda1
        s[p + "mlp.fc1.weight"] = layer.mlp.fc1.weight
        s[p + "mlp.fc1.bias"] = layer.mlp.fc1.bias
        s[p + "mlp.fc2.weight"] = layer.mlp.fc2.weight
        s[p + "mlp.fc2.bias"] = layer.mlp.fc2.bias
    return {k: v.detach().clone() for k, v in s.items()}


@pytest.mark.parametrize(
    "wrap", [None, "model", "teacher+backbone"],
    ids=["plain", "model-wrapped", "teacher-backbone"],
)
def test_dinov2_hub_pth(hf_models, tmp_path, wrap):
    _, _, vit = hf_models
    state = _hub_pth_state(vit)
    if wrap == "model":
        state = {"model": state}
    elif wrap == "teacher+backbone":
        state = {"teacher": {f"backbone.{k}": v for k, v in state.items()}}
    path = tmp_path / "dinov2_vitb14_reg_pretrain.pth"
    torch.save(state, path)
    cfg = _small_cfg()
    got = load_dinov2_snapshot(str(path), cfg)
    want = port_dinov2(vit, lora_rank=cfg.vit.lora_rank)
    # Base weights identical; LoRA A is a fresh draw on both sides with
    # the same seeds/shape conventions, B exactly zero.
    for i in range(cfg.vit.num_layers):
        g, w = got[f"block_{i}"], want[f"block_{i}"]
        np.testing.assert_array_equal(
            g["attn"]["qkv"]["kernel"], w["attn"]["qkv"]["kernel"]
        )
        np.testing.assert_array_equal(
            g["attn"]["proj"]["kernel"], w["attn"]["proj"]["kernel"]
        )
        np.testing.assert_array_equal(g["attn"]["qkv"]["lora_b"], 0.0)
        assert (
            g["attn"]["qkv"]["lora_a"].shape
            == w["attn"]["qkv"]["lora_a"].shape
        )
        np.testing.assert_array_equal(g["ls1"]["gamma"], w["ls1"]["gamma"])
    np.testing.assert_array_equal(got["pos_embed"], want["pos_embed"])
    np.testing.assert_array_equal(
        got["norm"]["scale"], want["norm"]["scale"]
    )


def test_init_params_from_pretrained_full_tree(hf_models, tmp_path):
    """One call builds the full TriadModel tree: pretrained backbones,
    fresh heads/temperature — and it runs."""
    import jax.numpy as jnp

    hub, db, vit = hf_models
    hub.save_pretrained(tmp_path / "h", safe_serialization=True)
    db.save_pretrained(tmp_path / "t", safe_serialization=True)
    torch.save(_hub_pth_state(vit), tmp_path / "v.pth")
    cfg = _small_cfg()
    params = init_params_from_pretrained(
        cfg, jax.random.key(0),
        hubert_path=str(tmp_path / "h"),
        text_path=str(tmp_path / "t"),
        vit_path=str(tmp_path / "v.pth"),
    )
    _assert_trees_equal(params["audio_backbone"], port_hubert(hub))
    _assert_trees_equal(params["text_backbone"], port_distilbert(db))
    assert "temperature" in params and "audio_projection" in params

    from triad.models import TriadModel

    model = TriadModel(cfg)
    rng = np.random.default_rng(1)
    out = model.apply(
        {"params": jax.tree.map(jnp.asarray, params)},
        jnp.asarray(rng.normal(size=(1, 28, 28, 3)).astype(np.float32)),
        jnp.asarray(rng.normal(size=(1, 1600)).astype(np.float32)),
        jnp.asarray(rng.integers(1, 100, size=(1, 6))),
        jnp.ones((1, 6), jnp.float32),
    )
    for k, v in out.items():
        assert np.isfinite(np.asarray(v)).all(), k


def test_forward_parity_through_snapshot(hf_models, tmp_path):
    """The snapshot round-trip preserves function, not just bytes: the
    Flax HuBERT loaded from the saved snapshot reproduces the HF torch
    forward."""
    import jax.numpy as jnp

    from triad.models.hubert import HubertModel as FlaxHubert

    hub, _, _ = hf_models
    d = tmp_path / "hubert"
    hub.save_pretrained(d, safe_serialization=True)
    cfg = _small_cfg()
    params = load_hubert_snapshot(str(d), cfg)
    audio = np.random.default_rng(2).normal(size=(2, 1600)).astype(np.float32)
    with torch.no_grad():
        ref = hub(torch.from_numpy(audio)).last_hidden_state.numpy()
    ours = FlaxHubert(cfg.hubert).apply(
        {"params": params}, jnp.asarray(audio)
    )
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-3, atol=5e-5)


def test_mismatch_raises(hf_models, tmp_path):
    """A wrong-architecture snapshot fails loudly at load time."""
    hub, db, _ = hf_models
    d = tmp_path / "distilbert"
    db.save_pretrained(d, safe_serialization=True)
    cfg = _small_cfg()
    wrong = dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_layers=3)
    )
    with pytest.raises(ValueError, match="mismatch"):
        load_distilbert_snapshot(str(d), wrong)
    # backbone dirs mixed up: hubert dir handed to the text loader
    d2 = tmp_path / "hubert"
    hub.save_pretrained(d2, safe_serialization=True)
    with pytest.raises(ValueError, match="expected DistilBertModel"):
        load_distilbert_snapshot(str(d2), cfg)
