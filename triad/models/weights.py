"""Port pretrained HF (torch) weights into triad param trees.

The reference pulls its backbones from HF / torch.hub at runtime
(model.py:29-30, 79-80, 218). Here the porting is explicit: given an HF
torch module (loaded from local files — or instantiated from config for
parity tests), produce the exact param pytree of the corresponding
triad module (models/nn.py, linen layout). Conventions:

  torch Linear weight (out, in)        -> Dense kernel (in, out)
  torch Conv1d weight (out, in/g, k)   -> Conv kernel (k, in/g, out)
  torch Conv2d weight (out, in, kh,kw) -> Conv kernel (kh, kw, in, out)
  torch LayerNorm/GroupNorm weight     -> scale

Weight-normed convs (HuBERT pos-conv) are read through the module
attribute (materialized weight), not the raw parametrization tensors.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _t(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _dense(mod) -> Dict[str, np.ndarray]:
    return {"kernel": _t(mod.weight).T, "bias": _t(mod.bias)}


def _norm(mod) -> Dict[str, np.ndarray]:
    return {"scale": _t(mod.weight), "bias": _t(mod.bias)}


# ---------------------------------------------------------------------------
# DistilBERT
# ---------------------------------------------------------------------------


def port_distilbert(hf_model) -> Dict[str, Any]:
    """HF ``DistilBertModel`` -> triad DistilBertModel params."""
    emb = hf_model.embeddings
    params: Dict[str, Any] = {
        "word_embeddings": _t(emb.word_embeddings.weight),
        "position_embeddings": _t(emb.position_embeddings.weight),
        "emb_layer_norm": _norm(emb.LayerNorm),
    }
    for i, layer in enumerate(hf_model.transformer.layer):
        params[f"layer_{i}"] = {
            "attention": {
                "q_lin": _dense(layer.attention.q_lin),
                "k_lin": _dense(layer.attention.k_lin),
                "v_lin": _dense(layer.attention.v_lin),
                "out_lin": _dense(layer.attention.out_lin),
            },
            "sa_layer_norm": _norm(layer.sa_layer_norm),
            "ffn": {
                "fc1": _dense(layer.ffn.lin1),
                "fc2": _dense(layer.ffn.lin2),
            },
            "output_layer_norm": _norm(layer.output_layer_norm),
        }
    return params


# ---------------------------------------------------------------------------
# DINOv2 with registers
# ---------------------------------------------------------------------------


def _fused_qkv(attn, lora_rank: int) -> Dict[str, np.ndarray]:
    """Fuse HF's separate q/k/v Linears into one (in, 3*out) kernel, with
    zero-initialized LoRA factors so the ported model starts at the
    pretrained function (peft init: B = 0)."""
    wq, wk, wv = (_t(m.weight).T for m in (attn.query, attn.key, attn.value))
    bq, bk, bv = (_t(m.bias) for m in (attn.query, attn.key, attn.value))
    out = {
        "kernel": np.concatenate([wq, wk, wv], axis=1),
        "bias": np.concatenate([bq, bk, bv]),
    }
    if lora_rank > 0:
        d_in = wq.shape[0]
        out["lora_a"] = _he_uniform((d_in, lora_rank), seed=0)
        out["lora_b"] = np.zeros((lora_rank, 3 * wq.shape[1]), np.float32)
    return out


def _he_uniform(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    fan_in = shape[0]
    limit = np.sqrt(6.0 / fan_in)
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def _lora_dense(mod, lora_rank: int, seed: int) -> Dict[str, np.ndarray]:
    out = _dense(mod)
    if lora_rank > 0:
        d_in, d_out = out["kernel"].shape
        out["lora_a"] = _he_uniform((d_in, lora_rank), seed=seed)
        out["lora_b"] = np.zeros((lora_rank, d_out), np.float32)
    return out


def port_dinov2(hf_model, lora_rank: int = 0) -> Dict[str, Any]:
    """HF ``Dinov2WithRegistersModel`` -> triad DinoViT params.

    Pass ``lora_rank > 0`` to also create freshly-initialized LoRA
    factors (adapter starts as a no-op; peft-equivalent init).
    """
    emb = hf_model.embeddings
    params: Dict[str, Any] = {
        "cls_token": _t(emb.cls_token),
        "register_tokens": _t(emb.register_tokens),
        "pos_embed": _t(emb.position_embeddings),
        "patch_embed": {
            "kernel": _t(emb.patch_embeddings.projection.weight).transpose(2, 3, 1, 0),
            "bias": _t(emb.patch_embeddings.projection.bias),
        },
    }
    for i, layer in enumerate(hf_model.encoder.layer):
        attn = layer.attention.attention
        params[f"block_{i}"] = {
            "norm1": _norm(layer.norm1),
            "attn": {
                "qkv": _fused_qkv(attn, lora_rank),
                "proj": _lora_dense(
                    layer.attention.output.dense, lora_rank, seed=1000 + i
                ),
            },
            "ls1": {"gamma": _t(layer.layer_scale1.lambda1)},
            "norm2": _norm(layer.norm2),
            "mlp": {"fc1": _dense(layer.mlp.fc1), "fc2": _dense(layer.mlp.fc2)},
            "ls2": {"gamma": _t(layer.layer_scale2.lambda1)},
        }
    params["norm"] = _norm(hf_model.layernorm)
    return params


# ---------------------------------------------------------------------------
# HuBERT
# ---------------------------------------------------------------------------


def port_hubert(hf_model) -> Dict[str, Any]:
    """HF ``HubertModel`` (base config) -> triad HubertModel params."""
    fe = hf_model.feature_extractor
    fe_params: Dict[str, Any] = {}
    for i, conv_layer in enumerate(fe.conv_layers):
        w = _t(conv_layer.conv.weight).transpose(2, 1, 0)
        entry: Dict[str, np.ndarray] = {"kernel": w}
        if conv_layer.conv.bias is not None:
            entry["bias"] = _t(conv_layer.conv.bias)
        fe_params[f"conv_{i}"] = entry
        if i == 0:
            fe_params["group_norm"] = _norm(conv_layer.layer_norm)

    enc = hf_model.encoder
    pos_conv = enc.pos_conv_embed.conv
    params: Dict[str, Any] = {
        "feature_extractor": fe_params,
        "feature_projection_norm": _norm(hf_model.feature_projection.layer_norm),
        "feature_projection": _dense(hf_model.feature_projection.projection),
        "pos_conv_embed": {
            "conv": {
                # .weight materializes the weight-norm parametrization.
                "kernel": _t(pos_conv.weight).transpose(2, 1, 0),
                "bias": _t(pos_conv.bias),
            }
        },
        "encoder_layer_norm": _norm(enc.layer_norm),
    }
    # Present iff mask_time_prob > 0 (HF creation rule; our HubertModel
    # declares the param under the same condition).
    if hasattr(hf_model, "masked_spec_embed"):
        params["masked_spec_embed"] = _t(hf_model.masked_spec_embed)
    for i, layer in enumerate(enc.layers):
        params[f"layer_{i}"] = {
            "attention": {
                "q_proj": _dense(layer.attention.q_proj),
                "k_proj": _dense(layer.attention.k_proj),
                "v_proj": _dense(layer.attention.v_proj),
                "out_proj": _dense(layer.attention.out_proj),
            },
            "layer_norm": _norm(layer.layer_norm),
            "intermediate_dense": _dense(layer.feed_forward.intermediate_dense),
            "output_dense": _dense(layer.feed_forward.output_dense),
            "final_layer_norm": _norm(layer.final_layer_norm),
        }
    return params
