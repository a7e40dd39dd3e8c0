"""Pretrained-backbone import from on-disk HF snapshots / hub files.

The reference fetches its backbones at startup: HF ``hubert-base-ls960``
(reference model.py:29-30), HF DistilBERT (model.py:79-80), and
torch.hub ``dinov2_vitb14_reg`` (model.py:218). Those fetches leave
standard artifacts on disk:

- an **HF snapshot directory** per hub backbone — ``config.json`` plus
  weights as ``model.safetensors`` (possibly sharded with a
  ``model.safetensors.index.json``) or legacy ``pytorch_model.bin``;
- a **torch.hub ``.pth`` state-dict file** for DINOv2 (plain
  DinoVisionTransformer names: ``cls_token``, ``blocks.N.attn.qkv`` with
  fused qkv, ``register_tokens``, ...).

This module consumes all of those, so on a machine where the real
weights exist, ``init_params_from_pretrained`` is the only call needed —
no new code on download day. Offline loading goes through
``transformers``' own ``from_pretrained(..., local_files_only=True)``
(which resolves safetensors vs bin vs shards) and then the established
HF ports in :mod:`triad.models.weights`; the reference's own
trained checkpoints keep going through
:mod:`triad.models.reference_import`.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from triad.core.config import ModelConfig


def _load_hf_dir(path: str, expect_class: str):
    """Instantiate the snapshot's own architecture, offline."""
    from transformers import AutoModel

    if not os.path.isdir(path):
        raise FileNotFoundError(f"HF snapshot directory not found: {path}")
    if not os.path.exists(os.path.join(path, "config.json")):
        raise FileNotFoundError(
            f"{path} has no config.json — not an HF snapshot directory"
        )
    hf = AutoModel.from_pretrained(path, local_files_only=True)
    got = type(hf).__name__
    if got != expect_class:
        raise ValueError(
            f"{path} resolved to {got}, expected {expect_class} — "
            f"backbone directories mixed up?"
        )
    return hf.eval()


def load_hubert_snapshot(path: str, cfg: ModelConfig) -> Dict[str, Any]:
    """HF snapshot dir (e.g. facebook/hubert-base-ls960) -> HubertModel
    params."""
    from triad.models.weights import port_hubert

    hf = _load_hf_dir(path, "HubertModel")
    h = cfg.hubert
    for ours, theirs in (
        (h.hidden_size, hf.config.hidden_size),
        (h.num_layers, hf.config.num_hidden_layers),
        (tuple(h.conv_dim), tuple(hf.config.conv_dim)),
    ):
        if ours != theirs:
            raise ValueError(
                f"HuBERT snapshot {path} architecture mismatch: "
                f"config says {theirs}, model config says {ours}"
            )
    return port_hubert(hf)


def load_distilbert_snapshot(path: str, cfg: ModelConfig) -> Dict[str, Any]:
    """HF snapshot dir (e.g. distilbert-base-uncased) -> DistilBertModel
    params."""
    from triad.models.weights import port_distilbert

    hf = _load_hf_dir(path, "DistilBertModel")
    t = cfg.text
    for ours, theirs in (
        (t.hidden_size, hf.config.dim),
        (t.num_layers, hf.config.n_layers),
        (t.vocab_size, hf.config.vocab_size),
    ):
        if ours != theirs:
            raise ValueError(
                f"DistilBERT snapshot {path} architecture mismatch: "
                f"config says {theirs}, model config says {ours}"
            )
    return port_distilbert(hf)


def _unwrap_hub_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """Accept the wrappers torch.hub / dinov2-release checkpoints use:
    a plain state dict, or one nested under ``model``/``state_dict``/
    ``teacher``, with an optional ``backbone.`` key prefix."""
    for wrapper in ("model", "state_dict", "teacher"):
        inner = state.get(wrapper)
        if isinstance(inner, dict) and inner:
            state = inner
            break
    if any(k.startswith("backbone.") for k in state):
        state = {
            k[len("backbone."):]: v
            for k, v in state.items()
            if k.startswith("backbone.")
        }
    return state


def load_dinov2_snapshot(path: str, cfg: ModelConfig) -> Dict[str, Any]:
    """DINOv2 weights -> DinoViT params, from either source layout:

    - a torch.hub ``.pth`` **file** (the reference's actual source,
      model.py:218): plain DinoVisionTransformer names with fused qkv;
    - an HF snapshot **directory** (facebook/dinov2-with-registers-base
      layout: separate q/k/v, ``Dinov2WithRegistersModel``).

    When ``cfg.vit.lora_rank > 0`` and the source carries no LoRA
    factors (pretrained backbones never do), fresh peft-equivalent
    factors are created (A he-uniform, B zero => adapter starts as a
    no-op), matching :func:`triad.models.weights.port_dinov2`.
    """
    from triad.models.weights import _he_uniform, port_dinov2

    rank = cfg.vit.lora_rank
    if os.path.isfile(path):
        import torch

        from triad.models.reference_import import _dinov2_from_reference

        state = torch.load(path, map_location="cpu", weights_only=True)
        state = _unwrap_hub_state(dict(state))
        if "cls_token" not in state:
            raise ValueError(
                f"{path} does not look like a DINOv2 state dict "
                f"(no cls_token key; first keys: {sorted(state)[:5]})"
            )
        params = _dinov2_from_reference(state, cfg)
        if rank > 0:
            for i in range(cfg.vit.num_layers):
                attn = params[f"block_{i}"]["attn"]
                qkv, proj = attn["qkv"], attn["proj"]
                if "lora_a" not in qkv:
                    d_in = qkv["kernel"].shape[0]
                    qkv["lora_a"] = _he_uniform((d_in, rank), seed=0)
                    qkv["lora_b"] = np.zeros(
                        (rank, qkv["kernel"].shape[1]), np.float32
                    )
                if "lora_a" not in proj:
                    d_in, d_out = proj["kernel"].shape
                    proj["lora_a"] = _he_uniform((d_in, rank), seed=1000 + i)
                    proj["lora_b"] = np.zeros((rank, d_out), np.float32)
        return params

    hf = _load_hf_dir(path, "Dinov2WithRegistersModel")
    v = cfg.vit
    for ours, theirs in (
        (v.hidden_size, hf.config.hidden_size),
        (v.num_layers, hf.config.num_hidden_layers),
        (v.patch_size, hf.config.patch_size),
    ):
        if ours != theirs:
            raise ValueError(
                f"DINOv2 snapshot {path} architecture mismatch: "
                f"config says {theirs}, model config says {ours}"
            )
    return port_dinov2(hf, lora_rank=rank)


def _check_subtree(name: str, got, want) -> None:
    """The ported subtree must have exactly the init tree's structure and
    shapes — a config/snapshot mismatch must fail loudly at load time,
    not as a shape error deep inside the first jitted step."""
    import jax

    g = {"/".join(map(str, p)): np.shape(l)
         for p, l in jax.tree_util.tree_flatten_with_path(got)[0]}
    w = {"/".join(map(str, p)): np.shape(l)
         for p, l in jax.tree_util.tree_flatten_with_path(want)[0]}
    if g.keys() != w.keys():
        missing = sorted(w.keys() - g.keys())[:3]
        extra = sorted(g.keys() - w.keys())[:3]
        raise ValueError(
            f"{name}: ported tree structure mismatch "
            f"(missing {missing}, unexpected {extra})"
        )
    bad = [k for k in w if g[k] != w[k]]
    if bad:
        k = bad[0]
        raise ValueError(
            f"{name}: shape mismatch at {k}: ported {g[k]}, model wants "
            f"{w[k]} (+{len(bad) - 1} more)"
        )


def init_params_from_pretrained(
    cfg: ModelConfig,
    rng: "Any",
    hubert_path: Optional[str] = None,
    text_path: Optional[str] = None,
    vit_path: Optional[str] = None,
    reference_checkpoint: Optional[str] = None,
) -> Dict[str, Any]:
    """Full TriadModel param tree with pretrained backbones.

    Mirrors the reference's startup: pretrained backbones, freshly
    initialized projection heads and temperature (model.py:331-353).
    ``reference_checkpoint`` (a trained reference ``.pt``) overrides the
    per-backbone paths — it carries the heads and temperature too.
    """
    if reference_checkpoint is not None:
        from triad.models.reference_import import (
            load_reference_checkpoint,
        )

        return load_reference_checkpoint(reference_checkpoint, cfg)

    from triad.models.multimodal import init_triad_model

    params = init_triad_model(cfg, rng)
    for key, path, loader in (
        ("audio_backbone", hubert_path, load_hubert_snapshot),
        ("text_backbone", text_path, load_distilbert_snapshot),
        ("visual_backbone", vit_path, load_dinov2_snapshot),
    ):
        if path is None:
            continue
        ported = loader(path, cfg)
        _check_subtree(key, ported, params[key])
        params[key] = ported
    return params
