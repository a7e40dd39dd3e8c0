"""Faithful torch (CPU) clone of the reference MultiModalModel pipeline.

The end-to-end parity oracle (VERDICT round 1, item 3): the full
reference model — HF HuBERT + HF DistilBERT + a torch.hub-layout DINOv2
with peft LoRA — wired exactly as reference src/model.py does,
with the reference's loss code path (tests/torch_oracle.py, which cites
model.py:370-608 line by line). Test/harness-only — never imported by
the framework.

Why a hand-built DINOv2: the reference loads ``dinov2_vitb14_reg`` via
torch.hub (model.py:218), which needs network. ``HubDinoV2`` below
reimplements that exact module *in the hub state-dict layout*
(blocks.N.{norm1,attn.qkv,attn.proj,ls1,norm2,mlp.fc1,mlp.fc2,ls2},
cls_token/pos_embed/register_tokens/patch_embed.proj/norm) so that
(a) peft targets "attn.qkv"/"attn.proj" exactly as the reference's
LoraConfig does (model.py:227-248), and (b) ``state_dict()`` round-trips
through ``triad.models.reference_import.port_reference_state_dict``
— proving the real checkpoint-import path end-to-end.

Audio normalize quirk reproduced: the reference runs the HF processor on
the already-collate-padded batch (model.py:56-62), i.e. zero-mean/
unit-var per padded row (eps 1e-7). Text tokenization happens outside
(the harness feeds identical ids/mask to both frameworks).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tests.torch_oracle import (
    oracle_av_loss,
    oracle_pairwise_similarity,
    oracle_tv_loss,
)


# ---------------------------------------------------------------------------
# torch.hub-layout DINOv2 with registers (facebookresearch/dinov2
# vision_transformer.py semantics at fixed 224x224 input)
# ---------------------------------------------------------------------------


class _HubAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim, bias=True)

    def forward(self, x):
        B, N, D = x.shape
        h = self.num_heads
        qkv = self.qkv(x)
        q = qkv[..., 0 * D : 1 * D].reshape(B, N, h, D // h).transpose(1, 2)
        k = qkv[..., 1 * D : 2 * D].reshape(B, N, h, D // h).transpose(1, 2)
        v = qkv[..., 2 * D : 3 * D].reshape(B, N, h, D // h).transpose(1, 2)
        attn = (q @ k.transpose(-2, -1)) / math.sqrt(D // h)
        out = attn.softmax(dim=-1) @ v
        return self.proj(out.transpose(1, 2).reshape(B, N, D))


class _LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x):
        return x * self.gamma


class _HubMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))  # exact (erf) gelu


class _HubBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _HubAttention(dim, num_heads)
        self.ls1 = _LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _HubMlp(dim, int(dim * mlp_ratio))
        self.ls2 = _LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, kernel_size=patch_size, stride=patch_size)

    def forward(self, x):
        x = self.proj(x)  # (B, D, H/p, W/p)
        return x.flatten(2).transpose(1, 2)  # (B, P, D) row-major


class HubDinoV2(nn.Module):
    """dinov2_vit*_reg in torch.hub naming, fixed-resolution."""

    def __init__(
        self,
        image_size: int = 224,
        patch_size: int = 14,
        dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        num_register_tokens: int = 4,
    ):
        super().__init__()
        self.embed_dim = dim
        self.num_register_tokens = num_register_tokens
        num_patches = (image_size // patch_size) ** 2
        self.patch_embed = _PatchEmbed(dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.register_tokens = nn.Parameter(
            torch.zeros(1, num_register_tokens, dim)
        )
        self.pos_embed = nn.Parameter(torch.randn(1, 1 + num_patches, dim) * 0.02)
        self.blocks = nn.ModuleList(
            _HubBlock(dim, num_heads, mlp_ratio) for _ in range(depth)
        )
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def _tokens(self, x):
        B = x.shape[0]
        p = self.patch_embed(x)
        cls = self.cls_token.expand(B, -1, -1)
        x = torch.cat([cls, p], dim=1) + self.pos_embed
        regs = self.register_tokens.expand(B, -1, -1)
        # registers between CLS and patches, no positional embedding
        x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return x

    def get_intermediate_layers(self, x, n: int = 1):
        """Hub semantics (vision_transformer.py, norm=True default):
        final-norm'd last-block output, patch tokens only."""
        assert n == 1
        tokens = self.norm(self._tokens(x))
        return [tokens[:, 1 + self.num_register_tokens :]]


# ---------------------------------------------------------------------------
# Reference embedders (model.py:22-118, 207-329) on fixed-shape inputs
# ---------------------------------------------------------------------------


class TorchAudioEmbedder(nn.Module):
    """model.py:22-70 with the processor quirk inlined: zero-mean/
    unit-var over each padded row (eps 1e-7), then HF HuBERT + the
    projection head."""

    def __init__(self, hubert: nn.Module, embedding_dim: int = 512):
        super().__init__()
        # reference model.py:32-34 hard-codes the 512 inner width; with
        # the flagship embedding_dim=512 this is identical — kept
        # parametric so the tiny-config parity harness ports cleanly.
        self.hubert = hubert
        self.projection1 = nn.Linear(hubert.config.hidden_size, embedding_dim)
        self.layer_norm = nn.LayerNorm(embedding_dim)
        self.projection2 = nn.Linear(embedding_dim, embedding_dim)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        mean = audio.mean(dim=-1, keepdim=True)
        var = audio.var(dim=-1, keepdim=True, unbiased=False)
        audio = (audio - mean) / torch.sqrt(var + 1e-7)
        hidden = self.hubert(audio).last_hidden_state
        return self.projection2(self.layer_norm(self.projection1(hidden)))


class TorchTextEmbedder(nn.Module):
    """model.py:72-118 with tokenization hoisted out (the harness feeds
    identical ids/mask to both frameworks)."""

    def __init__(self, encoder: nn.Module, embedding_dim: int = 512):
        super().__init__()
        self.encoder = encoder
        self.projection1 = nn.Linear(encoder.config.dim, embedding_dim)
        self.layer_norm = nn.LayerNorm(embedding_dim)
        self.projection2 = nn.Linear(embedding_dim, embedding_dim)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor):
        hidden = self.encoder(
            input_ids=ids, attention_mask=mask
        ).last_hidden_state
        return self.projection2(self.layer_norm(self.projection1(hidden))), mask


class TorchViTLoRAEmbedder(nn.Module):
    """model.py:207-329: frozen hub DINOv2 + peft LoRA r=8 α=16 on
    attn.qkv/attn.proj + projection head. Patch dropout is eval-off
    (model.py:271) — the harness runs deterministic (eval or p=0)."""

    def __init__(self, vit: HubDinoV2, embedding_dim: int = 512,
                 lora_rank: int = 8, lora_alpha: int = 16):
        super().__init__()
        from peft import LoraConfig, TaskType, get_peft_model

        for p in vit.parameters():
            p.requires_grad = False
        cfg = LoraConfig(
            task_type=TaskType.FEATURE_EXTRACTION,
            inference_mode=False,
            r=lora_rank,
            lora_alpha=lora_alpha,
            target_modules=["attn.qkv", "attn.proj"],
            lora_dropout=0.0,
            bias="none",
        )
        self.model = get_peft_model(vit, cfg)
        self.projection1 = nn.Linear(vit.embed_dim, embedding_dim)
        self.layer_norm = nn.LayerNorm(embedding_dim)
        self.projection2 = nn.Linear(embedding_dim, embedding_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        patches = self.model.get_intermediate_layers(x, n=1)[0]
        return self.projection2(self.layer_norm(self.projection1(patches)))


class TorchReferenceModel(nn.Module):
    """The reference MultiModalModel (model.py:331-353) over fixed-shape
    inputs, with loss methods delegating to the torch oracle."""

    def __init__(self, hubert, distilbert, vit: HubDinoV2,
                 embedding_dim: int = 512, temperature: float = 1.5,
                 patch_sparsity_threshold: float = 0.8,
                 patch_sparsity_weight: float = 0.01):
        super().__init__()
        self.audio_embedder = TorchAudioEmbedder(hubert, embedding_dim)
        self.text_embedder = TorchTextEmbedder(distilbert, embedding_dim)
        self.visual_embedder = TorchViTLoRAEmbedder(vit, embedding_dim)
        self.temperature = nn.Parameter(torch.tensor(float(temperature)))
        self.patch_sparsity_threshold = patch_sparsity_threshold
        self.patch_sparsity_weight = patch_sparsity_weight

    # model.py:474-488
    def forward_audio_visual(self, frames, audio):
        visual = self.visual_embedder(frames)
        audio_f = self.audio_embedder(audio)
        return oracle_av_loss(audio_f, visual, self.temperature)

    # model.py:595-608
    def forward_text_visual(self, frames, ids, mask):
        visual = self.visual_embedder(frames)
        text, mask = self.text_embedder(ids, mask)
        return oracle_tv_loss(
            text, visual, mask, self.temperature,
            threshold=self.patch_sparsity_threshold,
            weight=self.patch_sparsity_weight,
        )

    # model.py:610-637 (path-loading dropped; tensors in)
    def forward(self, frames=None, audio=None, ids=None, mask=None):
        out = {}
        if frames is not None:
            out["visual_feats"] = self.visual_embedder(frames)
        if audio is not None:
            out["audio_feats"] = self.audio_embedder(audio)
        if ids is not None:
            out["text_feats"], _ = self.text_embedder(ids, mask)
        t = self.temperature
        if "visual_feats" in out and "text_feats" in out:
            out["vis_text_sim_matrix"] = oracle_pairwise_similarity(
                out["text_feats"], out["visual_feats"], t
            )
        if "visual_feats" in out and "audio_feats" in out:
            out["vis_audio_sim_matrix"] = oracle_pairwise_similarity(
                out["audio_feats"], out["visual_feats"], t
            )
        if "audio_feats" in out and "text_feats" in out:
            out["text_audio_sim_matrix"] = oracle_pairwise_similarity(
                out["text_feats"], out["audio_feats"], t
            )
        return out


def build_reference_model(model_cfg, seed: int = 0,
                          randomize_lora: bool = True) -> TorchReferenceModel:
    """Full torch reference model from a triad ModelConfig (HF
    modules from config — no network), seeded.

    ``randomize_lora``: peft inits lora_B to zeros (adapter = no-op);
    setting it to random values makes the parity run exercise the LoRA
    path with nonzero contribution, as a trained checkpoint would.
    """
    from transformers import (
        DistilBertConfig as HFDBConfig,
        DistilBertModel as HFDBModel,
        HubertConfig as HFHuConfig,
        HubertModel as HFHuModel,
    )

    torch.manual_seed(seed)
    h, t, v = model_cfg.hubert, model_cfg.text, model_cfg.vit
    hubert = HFHuModel(
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
            # Mirror the triad config's stochastic-regularizer settings
            # so deterministic parity runs (all zeroed) stay
            # deterministic on BOTH sides in train mode.
            hidden_dropout=h.hidden_dropout,
            activation_dropout=h.activation_dropout,
            attention_dropout=h.attention_dropout,
            feat_proj_dropout=h.feat_proj_dropout,
            layerdrop=h.layerdrop,
            apply_spec_augment=h.apply_spec_augment,
            mask_time_prob=h.mask_time_prob,
            mask_time_length=h.mask_time_length,
            mask_time_min_masks=h.mask_time_min_masks,
        )
    )
    distilbert = HFDBModel(
        HFDBConfig(
            vocab_size=t.vocab_size,
            dim=t.hidden_size,
            n_layers=t.num_layers,
            n_heads=t.num_heads,
            hidden_dim=t.intermediate_size,
            max_position_embeddings=t.max_position_embeddings,
            dropout=t.dropout,
            attention_dropout=t.attention_dropout,
        )
    )
    vit = HubDinoV2(
        image_size=v.image_size,
        patch_size=v.patch_size,
        dim=v.hidden_size,
        depth=v.num_layers,
        num_heads=v.num_heads,
        mlp_ratio=v.mlp_ratio,
        num_register_tokens=v.num_register_tokens,
    )
    model = TorchReferenceModel(
        hubert, distilbert, vit,
        embedding_dim=model_cfg.embedding_dim,
        temperature=model_cfg.temperature_init,
    )
    if randomize_lora:
        with torch.no_grad():
            for name, p in model.visual_embedder.model.named_parameters():
                if "lora_B" in name:
                    p.normal_(std=0.02)
    return model.eval()


def port_to_triad(model: TorchReferenceModel, model_cfg):
    """state_dict -> TriadModel params via the production import path."""
    from triad.models.reference_import import port_reference_state_dict

    return port_reference_state_dict(model.state_dict(), model_cfg)
