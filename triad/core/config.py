"""Typed configuration for the triad framework.

The reference has no config system (hard-coded kwargs at
reference src/train.py:1148-1183 with ctor defaults at train.py:56-89, and
hard-coded model hyperparameters at train.py:235-244 / model.py:331-353).
Here every knob is a frozen dataclass; the full config travels inside
checkpoints (mirroring the reference's ``self.config`` dict persisted at
train.py:126-143, 427) and is serializable to/from plain dicts (JSON/YAML).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


# ---------------------------------------------------------------------------
# Encoder configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ViTConfig:
    """DINOv2 ViT-B/14 with register tokens (reference model.py:346:
    ``ViTLoRAEmbedder(arch='dinov2_vitb14_reg', embedding_dim=512, ...)``).

    Matches the HF ``Dinov2WithRegistersModel`` / facebookresearch DINOv2
    architecture so pretrained weights port 1:1.
    """

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    layerscale_init: float = 1.0
    ffn_bias: bool = True
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-6
    # LoRA on attention qkv + output proj (reference model.py:227-248:
    # r=8, alpha=16, targets ["attn.qkv", "attn.proj"], dropout 0.0).
    lora_rank: int = 8
    lora_alpha: float = 16.0
    # "folded": y = x @ (W + s·A@B) — one matmul pass over the
    # activation, but re-materializes the merged (768, 2304) qkv weight
    # every apply (forward AND remat recompute).
    # "separate": peft-shaped x@W + s·(x@A)@B — no weight assembly,
    # two extra skinny matmuls on the activation.
    lora_compute: str = "folded"
    # Softmax precision of the "xla" attention path: "float32" =
    # torch-parity softmax; "bfloat16" = half the score traffic.
    attention_scores_dtype: str = "float32"
    # Attention implementation (models/layers.attention): "xla" (parity
    # reference), "flash" (the Pallas kernel) or "cudnn" (cuDNN's fused
    # attention; forward only at this sequence length). DINOv2 has no
    # attention dropout.
    attention_impl: str = "xla"

    @property
    def num_patches(self) -> int:
        side = self.image_size // self.patch_size
        return side * side

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class HubertConfig:
    """HuBERT-base (reference model.py:27-30: facebook/hubert-base-ls960).

    Matches HF ``HubertModel`` base config: 7-layer conv feature encoder
    with group norm on layer 0, conv positional embedding, 12-layer
    post-LN transformer.
    """

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    feat_proj_layer_norm: bool = True
    layer_norm_eps: float = 1e-5
    # HF processor quirk (reference model.py:56-62): zero-mean/unit-var
    # normalization applied per padded batch row before the conv stack.
    normalize_waveform: bool = True
    # Softmax precision of the "xla" attention path (see ViTConfig).
    attention_scores_dtype: str = "float32"
    # Attention implementation (models/layers.attention): "xla" (parity
    # reference), "flash" (Pallas kernel with in-kernel dropout) or
    # "cudnn" (forward only, no dropout).
    attention_impl: str = "xla"
    # Waveform frontend: "conv" = XLA's conv lowering (cuDNN on a GPU);
    # "matmul" = im2col + one matmul; "block_matmul" = contiguous-slice
    # block matmuls; "phase" = phase-split matmuls (eval only — no
    # chunked remat). Same parameters, same numerics up to summation
    # order.
    frontend_impl: str = "conv"
    # Rematerialization for the backward pass: "none", "conv" (remat the
    # whole waveform frontend), "chunked_conv" (default: evaluate the
    # frontend in independent token blocks, each rematted — its
    # activations dominate device memory, ~9 GB at B=64/10 s, and VALID convs are
    # temporally local so chunks are exact), or "full" (also remat each
    # transformer layer; measured worse — fights XLA's own scheduler).
    remat: str = "chunked_conv"
    frontend_chunk_tokens: int = 128
    # Training dropouts (HF HubertConfig defaults — active in the
    # reference because model.train() leaves HF dropouts on).
    hidden_dropout: float = 0.1
    activation_dropout: float = 0.1
    attention_dropout: float = 0.1
    feat_proj_dropout: float = 0.0
    layerdrop: float = 0.1
    # SpecAugment time masking (HF HubertConfig defaults — ACTIVE in the
    # reference's training forwards: model.train() leaves HF's
    # apply_spec_augment on, so ~5% of audio tokens are masked with the
    # learned masked_spec_embed vector each step;
    # modeling_hubert._mask_hidden_states). The masked_spec_embed param
    # exists iff mask_time_prob > 0 (HF's creation rule).
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2

    def num_audio_tokens(self, num_samples: int) -> int:
        """Output sequence length of the conv feature encoder."""
        t = num_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            t = (t - k) // s + 1
        return t


@dataclass(frozen=True)
class DistilBertConfig:
    """DistilBERT-base-uncased (reference model.py:335, 345; train.py:238)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    pad_token_id: int = 0
    layer_norm_eps: float = 1e-12
    # Softmax precision of the "xla" attention path (see ViTConfig).
    attention_scores_dtype: str = "float32"
    # Attention implementation (see HubertConfig.attention_impl).
    attention_impl: str = "xla"
    # Training dropouts (HF DistilBertConfig defaults).
    dropout: float = 0.1
    attention_dropout: float = 0.1
    # Tokenization inside the reference forward (model.py:102-109):
    # padding, truncation, add_special_tokens=False, max_length=128.
    max_text_tokens: int = 128


# ---------------------------------------------------------------------------
# Model / loss configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """The combined tri-modal model (reference MultiModalModel,
    model.py:331-353)."""

    embedding_dim: int = 512
    temperature_init: float = 1.5  # trainer value, train.py:239
    visual_dropout_prob: float = 0.25  # train.py:242
    vit: ViTConfig = field(default_factory=ViTConfig)
    hubert: HubertConfig = field(default_factory=HubertConfig)
    text: DistilBertConfig = field(default_factory=DistilBertConfig)
    # bf16 compute for the encoders, fp32 for the loss path
    # (reference autocast split, model.py:483-487, 603-607).
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"


@dataclass(frozen=True)
class LossConfig:
    """Loss hyperparameters (reference model.py:331-353, 394-428, 516-542)."""

    # AV regularizers (model.py:410-428)
    av_nonneg_clamp_min: float = -60.0
    av_nonneg_weight: float = 0.15
    temp_cal_weight: float = 20.0
    temp_cal_low: float = 1.0
    temp_cal_high: float = 2.0  # computed but unused in reference (model.py:422-424)
    smooth_weight: float = 0.01
    # TV regularizers (model.py:516-542; values from train.py:240-241)
    tv_nonneg_clamp_min: float = -20.0
    tv_nonneg_weight: float = 0.15
    patch_sparsity_threshold: float = 0.80
    patch_sparsity_weight: float = 0.01
    # Aggregation implementation: "dense" materializes the (B,B,Nq,Nk)
    # volume (small batches / tests), "chunked" scans j-blocks with
    # remat (autodiff backward), "chunked_unrolled" unrolls that scan,
    # "chunked_vjp" adds a hand-written backward (bf16 recompute, no
    # residual stash).
    implementation: str = "dense"
    # Distributed in-batch negatives (parallel/dp.py): "all_gather"
    # materializes the global key tokens on every device (0.4 GB at
    # global 512); "ring" ppermutes one key shard around the data axis
    # — peak key memory 2 shards at any global batch, identical
    # semantics (single mesh axis only).
    negatives: str = "all_gather"
    chunk_size: int = 8
    # Matmul precision of the aggregation einsums: "highest" reproduces
    # the reference's fp32 loss math bit-closely (parity tests);
    # "default" lets bf16 features use the tensor cores natively (the
    # production path).
    matmul_precision: str = "highest"
    # Storage dtype of the (Bq, chunk, Nq, Nk) token-sim volume between
    # the matmul and its max/clamp consumers: "float32" (parity
    # default) or "bfloat16" — the matmul still accumulates in f32,
    # only the device-memory round-trip of the volume is rounded to
    # bf16, halving the loss path's dominant memory traffic (the same
    # contract as attention_scores_dtype="bfloat16": bf16-or-better
    # numerics; the max/mean/clamp^2 reductions stay f32).
    volume_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Data / train configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DataConfig:
    # Fixed shapes (XLA requirement). The reference pads audio to the batch
    # max (dataset.py:264-276) and tokenizes to the batch max (model.py:102-109);
    # we pad to these static lengths instead.
    audio_num_samples: int = 160_000  # 10 s @ 16 kHz
    sample_rate: int = 16_000
    image_size: int = 224
    max_text_tokens: int = 128
    batch_size_av: int = 22  # train.py:1157
    batch_size_tv: int = 22  # train.py:1158
    num_workers: int = 4
    # "thread" (in-process pool) or "process" (spawned decode workers;
    # true CPU parallelism for python-heavy decode — the analog of the
    # reference's 10 DataLoader worker processes, train.py:161).
    worker_mode: str = "thread"
    prefetch: int = 2
    # Ship raw uint8 frames + int16 audio + per-sample draw params and
    # run the augmentation math on the accelerator (data/device_aug.py):
    # host cost per clip drops to one memcpy and the host->device image
    # bytes drop 4x. Draws stay keyed on (seed, epoch, batch, idx) —
    # exact-resume semantics unchanged; math identical to the host path
    # (tests/test_device_aug.py). Needs a dataset exposing raw_item
    # (TriadPack shards); silently falls back to host augmentation
    # otherwise (AVLoader semantics).
    device_augment: bool = False
    # Paths (None => synthetic data)
    audio_visual_data_root: Optional[str] = None
    text_dataset_path: Optional[str] = None
    audio_visual_val_data_root: Optional[str] = None
    text_dataset_val_path: Optional[str] = None
    tokenizer_vocab: Optional[str] = None  # path to a WordPiece vocab.txt
    # Synthetic dataset sizes when no real data is configured.
    synthetic_av_size: int = 256
    synthetic_tv_size: int = 256
    # Grounded synthetic data: class-keyed square/tone/word
    # correspondences (a LEARNABLE dense-grounding task) instead of
    # noise pairs — lets a from-scratch run demonstrate real learning
    # without media (see tests/test_learning.py). Classes <= 8.
    synthetic_grounded: bool = False
    synthetic_grounded_classes: int = 4
    # Draw AV batches with unique source-video ids (no same-video false
    # negatives in a contrastive batch — the reference's
    # VideoBatchSampler intent, dataset.py:137-164, defined there but
    # never wired). Ids derive from filenames: a trailing _<digits>
    # clip-index is stripped, so "ytid_30_40.mp4" and "ytid_40_50.mp4"
    # share an id.
    unique_videos: bool = False


@dataclass(frozen=True)
class OptimConfig:
    """4-group optimizer setup (reference train.py:246-348, 527-548)."""

    learning_rate: float = 1e-4
    # Per-group peak-LR scaling (train.py:302-343).
    lr_scale_others: float = 1.0
    lr_scale_audio: float = 0.25
    lr_scale_text: float = 0.75
    lr_scale_vit_lora: float = 0.5
    # OneCycle shape (train.py:302-343).
    pct_start: float = 0.1
    div_factor: float = 10.0
    final_div_factor: float = 1e4
    # Unfreeze steps (train.py:1169-1171).
    unfreeze_audio_step: int = 5000
    unfreeze_text_step: int = 5000
    unfreeze_vit_step: int = 5000
    # Grad clip: reference clips audio_embedder.* and text_embedder.*
    # subtrees to global-norm 10.0 (train.py:1004-1006).
    clip_norm: float = 10.0
    gradient_accumulation_steps: int = 4  # train.py:1168
    weight_decay: float = 0.01  # torch AdamW default
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # torch OneCycleLR cycles beta1 by default (cycle_momentum=True) —
    # the reference's 4 schedulers inherit this (train.py:302-343), so
    # beta1 anneals 0.95 -> 0.85 -> 0.95 along each group's cycle.
    cycle_momentum: bool = True
    base_momentum: float = 0.85
    max_momentum: float = 0.95
    # Adam moment storage dtype (a memory knob, not a reference
    # feature — the reference keeps fp32 moments). "bfloat16" halves
    # optimizer state (~2 GB -> ~1 GB for the tri-modal model), buying
    # device-memory headroom for bigger per-device batches / less remat.
    # Moment *updates* always compute in fp32 and round on store.
    mu_dtype: str = "float32"
    nu_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    num_epochs: int = 10  # train.py:1159
    steps_per_epoch: Optional[int] = None  # None => derived from data size
    # Curriculum phases (train.py:880-905; values train.py:1176-1180).
    av_focus_epochs: int = 1
    tv_warmup_epochs: int = 1
    weighted_joint_epochs: int = 2
    av_weight_start: float = 0.8
    av_weight_end: float = 0.5
    # Periodic hooks (train.py:1162-1175).
    vis_every: int = 20000
    save_every_steps: int = 10000
    # Async checkpointing: save() returns once arrays are snapshotted
    # to host; the filesystem write overlaps the next train steps
    # (train/checkpoint.py — read paths drain in-flight saves first).
    async_checkpointing: bool = False
    validation_frequency: int = 20000
    retrieval_subset_size: int = 1000
    num_vis_samples_av: int = 24
    num_vis_samples_tv: int = 24
    # jax.profiler trace of the first N steps (0 = off); trace lands in
    # <output_dir>/profile for TensorBoard.
    profile_steps: int = 0
    output_dir: str = "./outputs_triad"
    use_wandb: bool = False
    project_name: str = "triad"
    seed: int = 0
    optim: OptimConfig = field(default_factory=OptimConfig)


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh. Parity needs pure DP (SURVEY §2.6); the axis is kept
    named so that model/sequence axes can be added later."""

    data_axis: str = "data"
    num_devices: Optional[int] = None  # None => all visible devices
    # Multi-slice scale-out: with num_slices > 1 the mesh is 2-D
    # (num_slices, num_devices/num_slices); ``replica_axis`` spans the
    # slices (hosts, joined by the slower inter-node network),
    # ``data_axis`` the devices within a slice. The batch shards over
    # BOTH axes and in-batch negatives gather globally (parallel/dp.py
    # multi-axis collectives).
    num_slices: int = 1
    replica_axis: str = "replica"
    # Tensor (model) parallelism: with tp > 1 the mesh is 2-D
    # (num_devices/tp, tp) and parameters shard Megatron-style over
    # ``model_axis`` (parallel/tp.py); the batch shards over
    # ``data_axis`` only and the distributed loss is unchanged.
    # Rejects the "flash" attention kernel (a pallas_call is opaque to
    # the GSPMD partitioner). Composes with zero1 (moments shard
    # over 'data' on top of their param's TP spec) AND with
    # num_slices > 1 (3-D (replica, data, model) mesh — each TP group
    # stays inside one slice so no Megatron psum crosses slices;
    # parallel/tp.py make_multislice_tp_mesh).
    tp: int = 1
    model_axis: str = "model"
    # FSDP / ZeRO-3: store every large parameter sharded over the data
    # axis; GSPMD all-gathers each layer's weights at use and
    # reduce-scatters their grads (parallel/fsdp.py). Same per-step
    # wire bytes as DP's grad all-reduce. Composes with tp (extends the
    # Megatron specs), zero1 (moments inherit the sharded specs), and
    # num_slices > 1 (shards stay over the intra-slice 'data' axis —
    # per-use gathers stay inside a slice, params replicate across
    # 'replica'). Like tp, rejects the "flash" kernel.
    fsdp: bool = False
    # ZeRO-1: shard Adam moments (+ grad accumulator) over the data axis
    # instead of replicating them (parallel/zero.py). Bitwise-identical
    # math; frees ~(1 - 1/N) of the moment memory per device.
    zero1: bool = True


@dataclass(frozen=True)
class PretrainedConfig:
    """Where to find pretrained weights at startup. The reference fetches
    HuBERT/DistilBERT from the HF hub and DINOv2 from torch.hub
    (model.py:29-30, 79-80, 218); here the on-disk artifacts are named
    explicitly and loaded offline (models/hf_import.py). All optional —
    None means fresh initialization for that backbone."""

    # HF snapshot directory (config.json + model.safetensors [sharded ok]
    # or pytorch_model.bin), e.g. a local facebook/hubert-base-ls960.
    hubert: Optional[str] = None
    # HF snapshot directory, e.g. a local distilbert-base-uncased.
    text: Optional[str] = None
    # HF snapshot directory (dinov2-with-registers-base layout) OR a
    # torch.hub .pth state-dict file (dinov2_vitb14_reg_pretrain.pth).
    vit: Optional[str] = None
    # A trained reference checkpoint_epoch{E}_step{S}.pt — overrides the
    # per-backbone paths (it carries heads + temperature too).
    reference_checkpoint: Optional[str] = None

    def any(self) -> bool:
        return any(
            (self.hubert, self.text, self.vit, self.reference_checkpoint)
        )


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    pretrained: PretrainedConfig = field(default_factory=PretrainedConfig)

    # -- serialization -------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))


# Fields of older configs (and the checkpoints that carry them) that
# selected kernels this program no longer has. Loading drops them.
RETIRED_FIELDS = {
    "ViTConfig": frozenset({
        "mlp_impl", "mlp_gelu", "mlp_block_rows", "attention_pad",
    }),
    "HubertConfig": frozenset({
        "mlp_impl", "mlp_gelu", "mlp_block_rows", "attention_pad",
        "ln_impl", "ln_block_rows", "frontend_gelu", "frontend_wave_layout",
        "frontend_tb", "posconv_impl",
    }),
}


def _from_dict(cls, d):
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    resolved = {f.name: f for f in dataclasses.fields(cls)}
    retired = RETIRED_FIELDS.get(cls.__name__, frozenset())
    for key, value in d.items():
        if key in retired:
            continue
        if key not in resolved:
            raise KeyError(f"Unknown config field {key!r} for {cls.__name__}")
        f = resolved[key]
        # Resolve nested dataclasses by inspecting the default factory.
        default = (
            f.default_factory() if f.default_factory is not dataclasses.MISSING else None
        )
        if dataclasses.is_dataclass(default) and isinstance(value, dict):
            kwargs[key] = _from_dict(type(default), value)
        elif isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def h100_model_config() -> ModelConfig:
    """The model configuration for the H100, in training (the Trainer,
    configs/h100_scale.yaml) and in evaluation (bench.py): the parity
    default except for attention. The ViT (N=261)
    and HuBERT (N=499) use the Pallas flash kernel, which draws HuBERT's
    attention dropout in-kernel where XLA writes a (B, H, N, N) mask to
    memory in both directions; DistilBERT's 32 text tokens stay on XLA,
    which matched the kernel there. cuDNN's fused attention refuses the
    training pass (forward with backward) at the odd lengths 499 and 261;
    for the forward alone it is an option ("cudnn"). The choice rests on
    per-call kernel times and is provisional until
    scripts/attention_ab.py has compared it end to end (PERF.md)."""
    cfg = ModelConfig()
    return dataclasses.replace(
        cfg,
        vit=dataclasses.replace(cfg.vit, attention_impl="flash"),
        hubert=dataclasses.replace(cfg.hubert, attention_impl="flash"),
    )


def perf_train_loss_config() -> LossConfig:
    """The production training loss path, shared by
    configs/h100_scale.yaml and chip_smoke.py:

    - chunked_vjp: hand-written bf16 chunk-recompute backward;
    - chunk_size 32;
    - matmul_precision "default": bf16-operand / f32-accum aggregation;
    - volume_dtype "bfloat16": the per-chunk sim volumes stay bf16
      between the matmul and its max/clamp consumers, forward and in
      the recompute backward. Grad equivalence pinned by
      tests/test_losses.py::TestBf16Volume."""
    return LossConfig(
        implementation="chunked_vjp", chunk_size=32,
        matmul_precision="default", volume_dtype="bfloat16",
    )


def perf_eval_loss_config() -> LossConfig:
    """Production loss path for the eval bench: the chunked aggregation
    with its scan unrolled, bf16 operands and fp32 accumulation
    (bit-equal to the fp32-HIGHEST volume for bf16-valued features —
    tests/test_losses.py), bf16 volume storage."""
    return LossConfig(
        implementation="chunked_unrolled", chunk_size=32,
        matmul_precision="default", volume_dtype="bfloat16",
    )
