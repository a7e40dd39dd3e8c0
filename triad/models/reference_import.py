"""Import a trained reference checkpoint into triad params.

The reference saves monolithic torch dicts (train.py:398-437) whose
``model_state_dict`` contains the full MultiModalModel: HF HuBERT under
``audio_embedder.hubert.*``, HF DistilBERT under
``text_embedder.encoder.*``, a peft-wrapped torch.hub DINOv2 under
``visual_embedder.model.*`` (fused qkv + LoRA factors), the three
projection heads, and the ``temperature`` scalar — possibly all behind a
``_orig_mod.`` prefix from torch.compile (train.py:443-454).

``port_reference_state_dict`` maps that tree onto TriadModel params so a
reference user can load their trained weights and keep going here.
The HF submodules reuse triad.models.weights via HF model objects
(which also materializes weight-norm parametrizations); the DINOv2 part
is mapped name-by-name (hub layout: blocks.N.{norm1,attn.qkv,attn.proj,
ls1,norm2,mlp.fc1,mlp.fc2,ls2}, cls_token/pos_embed/register_tokens/
patch_embed/norm), accepting both peft-wrapped (``base_model.model.`` +
``.base_layer`` + ``lora_A/lora_B.default``) and plain names.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from triad.core.config import ModelConfig


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def strip_compile_prefix(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Remove torch.compile's ``_orig_mod.`` prefix (train.py:443-454)."""
    return {
        (k[len("_orig_mod."):] if k.startswith("_orig_mod.") else k): v
        for k, v in state_dict.items()
    }


def _subdict(state: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {
        k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)
    }


def _projection_head(state: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """projection1 -> LayerNorm -> projection2 (model.py:32-34 pattern)."""
    return {
        "projection1": {
            "kernel": _np(state[f"{prefix}projection1.weight"]).T,
            "bias": _np(state[f"{prefix}projection1.bias"]),
        },
        "layer_norm": {
            "scale": _np(state[f"{prefix}layer_norm.weight"]),
            "bias": _np(state[f"{prefix}layer_norm.bias"]),
        },
        "projection2": {
            "kernel": _np(state[f"{prefix}projection2.weight"]).T,
            "bias": _np(state[f"{prefix}projection2.bias"]),
        },
    }


def _port_hf_submodule(sub_state: Dict[str, Any], build_hf, port_fn):
    """Load a raw sub-state-dict into a fresh HF torch model (from
    config), then reuse the standard HF port. Materializes any
    parametrizations (e.g. HuBERT pos-conv weight norm)."""
    import torch

    hf = build_hf()
    tensors = {k: torch.as_tensor(np.asarray(_np(v))) for k, v in sub_state.items()}
    missing, unexpected = hf.load_state_dict(tensors, strict=False)
    real_missing = [m for m in missing if "parametrizations" not in m]
    if real_missing:
        raise ValueError(f"missing keys in reference sub-state: {real_missing[:5]}")
    return port_fn(hf.eval())


def _dinov2_from_reference(
    vstate: Dict[str, Any], cfg: ModelConfig
) -> Dict[str, Any]:
    """torch.hub DINOv2 (optionally peft-wrapped) -> DinoViT params."""
    # Unwrap peft prefixes.
    s: Dict[str, Any] = {}
    for k, v in vstate.items():
        k = k.replace("base_model.model.", "")
        k = k.replace(".base_layer", "")
        s[k] = v

    def t(name):
        return _np(s[name])

    vit = cfg.vit
    params: Dict[str, Any] = {
        "cls_token": t("cls_token"),
        "register_tokens": t("register_tokens"),
        "pos_embed": t("pos_embed"),
        "patch_embed": {
            "kernel": t("patch_embed.proj.weight").transpose(2, 3, 1, 0),
            "bias": t("patch_embed.proj.bias"),
        },
        "norm": {"scale": t("norm.weight"), "bias": t("norm.bias")},
    }
    # DINOv2 hub pos_embed covers CLS+patches; with registers the
    # register tokens carry no positional embedding — same as ours.
    for i in range(vit.num_layers):
        p = f"blocks.{i}."
        qkv: Dict[str, Any] = {
            "kernel": t(p + "attn.qkv.weight").T,
            "bias": t(p + "attn.qkv.bias"),
        }
        proj: Dict[str, Any] = {
            "kernel": t(p + "attn.proj.weight").T,
            "bias": t(p + "attn.proj.bias"),
        }
        if p + "attn.qkv.lora_A.default.weight" in s:
            qkv["lora_a"] = t(p + "attn.qkv.lora_A.default.weight").T
            qkv["lora_b"] = t(p + "attn.qkv.lora_B.default.weight").T
        if p + "attn.proj.lora_A.default.weight" in s:
            proj["lora_a"] = t(p + "attn.proj.lora_A.default.weight").T
            proj["lora_b"] = t(p + "attn.proj.lora_B.default.weight").T
        params[f"block_{i}"] = {
            "norm1": {"scale": t(p + "norm1.weight"), "bias": t(p + "norm1.bias")},
            "attn": {"qkv": qkv, "proj": proj},
            "ls1": {"gamma": t(p + "ls1.gamma")},
            "norm2": {"scale": t(p + "norm2.weight"), "bias": t(p + "norm2.bias")},
            "mlp": {
                "fc1": {
                    "kernel": t(p + "mlp.fc1.weight").T,
                    "bias": t(p + "mlp.fc1.bias"),
                },
                "fc2": {
                    "kernel": t(p + "mlp.fc2.weight").T,
                    "bias": t(p + "mlp.fc2.bias"),
                },
            },
            "ls2": {"gamma": t(p + "ls2.gamma")},
        }
    return params


def port_reference_state_dict(
    state_dict: Dict[str, Any], cfg: ModelConfig
) -> Dict[str, Any]:
    """Reference MultiModalModel state dict -> TriadModel param tree."""
    from transformers import (
        DistilBertConfig as HFDBConfig,
        DistilBertModel as HFDBModel,
        HubertConfig as HFHuConfig,
        HubertModel as HFHuModel,
    )

    from triad.models.weights import port_distilbert, port_hubert

    state = strip_compile_prefix(state_dict)
    h = cfg.hubert
    t = cfg.text

    def build_hubert():
        return HFHuModel(
            HFHuConfig(
                hidden_size=h.hidden_size,
                num_hidden_layers=h.num_layers,
                num_attention_heads=h.num_heads,
                intermediate_size=h.intermediate_size,
                conv_dim=list(h.conv_dim),
                conv_kernel=list(h.conv_kernel),
                conv_stride=list(h.conv_stride),
                num_feat_extract_layers=len(h.conv_dim),
                num_conv_pos_embeddings=h.num_conv_pos_embeddings,
                num_conv_pos_embedding_groups=h.num_conv_pos_embedding_groups,
                do_stable_layer_norm=False,
                feat_extract_norm="group",
                conv_bias=h.conv_bias,
            )
        )

    def build_distilbert():
        return HFDBModel(
            HFDBConfig(
                vocab_size=t.vocab_size,
                dim=t.hidden_size,
                n_layers=t.num_layers,
                n_heads=t.num_heads,
                hidden_dim=t.intermediate_size,
                max_position_embeddings=t.max_position_embeddings,
            )
        )

    params: Dict[str, Any] = {
        "audio_backbone": _port_hf_submodule(
            _subdict(state, "audio_embedder.hubert."), build_hubert, port_hubert
        ),
        "audio_projection": _projection_head(state, "audio_embedder."),
        "text_backbone": _port_hf_submodule(
            _subdict(state, "text_embedder.encoder."),
            build_distilbert,
            port_distilbert,
        ),
        "text_projection": _projection_head(state, "text_embedder."),
        "visual_backbone": _dinov2_from_reference(
            _subdict(state, "visual_embedder.model."), cfg
        ),
        "visual_projection": _projection_head(state, "visual_embedder."),
        "temperature": _np(state["temperature"]).reshape(()),
    }
    return params


def load_reference_checkpoint(path: str, cfg: ModelConfig) -> Dict[str, Any]:
    """Load a reference ``checkpoint_epoch{E}_step{S}.pt`` file and port
    its model weights."""
    import torch

    payload = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = payload.get("model_state_dict", payload)
    return port_reference_state_dict(state_dict, cfg)
