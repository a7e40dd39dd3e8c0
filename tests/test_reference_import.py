"""Reference-checkpoint import tests: a synthetic reference-style
MultiModalModel state dict (HF HuBERT + HF DistilBERT + peft-wrapped
hub-layout DINOv2 + projections + temperature, behind _orig_mod.) ports
onto TriadModel params that (a) run, and (b) agree with the direct
HF->Flax ports used by the encoder parity tests."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.test_encoders import SMALL_HUBERT, SMALL_TEXT, SMALL_VIT
from tests.test_multimodal import small_model_config
from triad.models import TriadModel
from triad.models.reference_import import port_reference_state_dict
from triad.models.weights import port_dinov2


def _hub_style_dinov2_state(hf_vit, lora_rank=8):
    """Convert an HF Dinov2WithRegistersModel into the torch.hub DINOv2
    state-dict layout the reference checkpoints use (peft-wrapped)."""
    emb = hf_vit.embeddings
    s = {
        "cls_token": emb.cls_token,
        "register_tokens": emb.register_tokens,
        "pos_embed": emb.position_embeddings,
        "patch_embed.proj.weight": emb.patch_embeddings.projection.weight,
        "patch_embed.proj.bias": emb.patch_embeddings.projection.bias,
        "norm.weight": hf_vit.layernorm.weight,
        "norm.bias": hf_vit.layernorm.bias,
    }
    wrap = "base_model.model."
    out = {}
    for i, layer in enumerate(hf_vit.encoder.layer):
        a = layer.attention.attention
        qkv_w = torch.cat([a.query.weight, a.key.weight, a.value.weight], dim=0)
        qkv_b = torch.cat([a.query.bias, a.key.bias, a.value.bias], dim=0)
        p = f"blocks.{i}."
        s[p + "attn.qkv.base_layer.weight"] = qkv_w
        s[p + "attn.qkv.base_layer.bias"] = qkv_b
        s[p + "attn.qkv.lora_A.default.weight"] = torch.randn(
            lora_rank, qkv_w.shape[1]
        ) * 0.01
        s[p + "attn.qkv.lora_B.default.weight"] = torch.zeros(
            qkv_w.shape[0], lora_rank
        )
        s[p + "attn.proj.base_layer.weight"] = layer.attention.output.dense.weight
        s[p + "attn.proj.base_layer.bias"] = layer.attention.output.dense.bias
        s[p + "attn.proj.lora_A.default.weight"] = torch.randn(
            lora_rank, qkv_w.shape[1]
        ) * 0.01
        s[p + "attn.proj.lora_B.default.weight"] = torch.zeros(
            qkv_w.shape[1], lora_rank
        )
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
    return {wrap + k: v for k, v in s.items()}


def _projection_state(prefix, hidden, dim, rng):
    g = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32) * 0.05
    )
    return {
        f"{prefix}projection1.weight": g(dim, hidden),
        f"{prefix}projection1.bias": g(dim),
        f"{prefix}layer_norm.weight": torch.ones(dim),
        f"{prefix}layer_norm.bias": torch.zeros(dim),
        f"{prefix}projection2.weight": g(dim, dim),
        f"{prefix}projection2.bias": g(dim),
    }


@pytest.fixture(scope="module")
def reference_checkpoint():
    from transformers import (
        DistilBertConfig as HFDBConfig, DistilBertModel as HFDBModel,
        Dinov2WithRegistersConfig, Dinov2WithRegistersModel,
        HubertConfig as HFHuConfig, HubertModel as HFHuModel,
    )

    torch.manual_seed(0)
    rng = np.random.default_rng(0)
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
            do_stable_layer_norm=False, feat_extract_norm="group",
            conv_bias=False,
        )
    ).eval()
    db = HFDBModel(
        HFDBConfig(
            vocab_size=100, dim=SMALL_TEXT["hidden_size"],
            n_layers=SMALL_TEXT["num_layers"], n_heads=SMALL_TEXT["num_heads"],
            hidden_dim=SMALL_TEXT["intermediate_size"],
            max_position_embeddings=SMALL_TEXT["max_position_embeddings"],
        )
    ).eval()
    vit = Dinov2WithRegistersModel(
        Dinov2WithRegistersConfig(
            image_size=SMALL_VIT["image_size"], patch_size=SMALL_VIT["patch_size"],
            hidden_size=SMALL_VIT["hidden_size"],
            num_hidden_layers=SMALL_VIT["num_layers"],
            num_attention_heads=SMALL_VIT["num_heads"],
            num_register_tokens=SMALL_VIT["num_register_tokens"],
            mlp_ratio=4, layerscale_value=1.0,
        )
    ).eval()

    state = {}
    state.update(
        {f"audio_embedder.hubert.{k}": v for k, v in hub.state_dict().items()}
    )
    state.update(_projection_state("audio_embedder.", 32, 32, rng))
    state.update(
        {f"text_embedder.encoder.{k}": v for k, v in db.state_dict().items()}
    )
    state.update(_projection_state("text_embedder.", 32, 32, rng))
    state.update(
        {
            f"visual_embedder.model.{k}": v
            for k, v in _hub_style_dinov2_state(vit).items()
        }
    )
    state.update(_projection_state("visual_embedder.", 32, 32, rng))
    state["temperature"] = torch.tensor(1.7)
    # reference checkpoints may carry the torch.compile prefix
    state = {f"_orig_mod.{k}": v for k, v in state.items()}
    return state, vit


@pytest.mark.slow
def test_port_runs_and_matches_direct_vit_port(reference_checkpoint):
    state, hf_vit = reference_checkpoint
    cfg = small_model_config()
    # align the tiny hubert conv stack with the checkpoint (2 layers)
    import dataclasses

    cfg = dataclasses.replace(
        cfg,
        hubert=dataclasses.replace(
            cfg.hubert, conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2)
        ),
        text=dataclasses.replace(cfg.text, vocab_size=100),
    )
    params = port_reference_state_dict(state, cfg)
    assert float(params["temperature"]) == pytest.approx(1.7)

    # The visual subtree must agree with the HF-direct port (modulo the
    # freshly-initialized LoRA A in both — compare base weights).
    direct = port_dinov2(hf_vit, lora_rank=8)
    got = params["visual_backbone"]
    for i in range(2):
        np.testing.assert_allclose(
            got[f"block_{i}"]["attn"]["qkv"]["kernel"],
            direct[f"block_{i}"]["attn"]["qkv"]["kernel"], rtol=1e-6,
        )
        np.testing.assert_array_equal(
            got[f"block_{i}"]["attn"]["qkv"]["lora_b"], 0.0
        )
    np.testing.assert_allclose(got["pos_embed"], direct["pos_embed"], rtol=1e-6)

    # End-to-end: the ported model runs the tri-modal forward.
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


def test_audio_text_subtrees_match_hf_forward(reference_checkpoint):
    """The ported HuBERT/DistilBERT weights reproduce the torch modules
    the checkpoint was built from."""
    state, _ = reference_checkpoint
    import dataclasses
    from triad.models.hubert import HubertModel as FlaxHubert
    from triad.core.config import HubertConfig

    cfg = small_model_config()
    cfg = dataclasses.replace(
        cfg,
        hubert=dataclasses.replace(
            cfg.hubert, conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2)
        ),
        text=dataclasses.replace(cfg.text, vocab_size=100),
    )
    params = port_reference_state_dict(state, cfg)

    # rebuild the torch hubert from the checkpoint sub-state
    from transformers import HubertConfig as HFHuConfig, HubertModel as HFHuModel
    import torch as th

    sub = {
        k[len("_orig_mod.audio_embedder.hubert."):]: v
        for k, v in state.items()
        if k.startswith("_orig_mod.audio_embedder.hubert.")
    }
    hf = HFHuModel(
        HFHuConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, conv_dim=[16, 16], conv_kernel=[10, 3],
            conv_stride=[5, 2], num_feat_extract_layers=2,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            do_stable_layer_norm=False, feat_extract_norm="group",
            conv_bias=False,
        )
    ).eval()
    hf.load_state_dict(sub, strict=False)
    audio = np.random.default_rng(2).normal(size=(2, 1600)).astype(np.float32)
    with th.no_grad():
        ref = hf(th.from_numpy(audio)).last_hidden_state.numpy()
    flax_h = FlaxHubert(cfg.hubert)
    ours = flax_h.apply({"params": params["audio_backbone"]}, jnp.asarray(audio))
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-3, atol=5e-5)
