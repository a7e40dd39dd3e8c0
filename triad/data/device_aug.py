"""On-device augmentation: host ships raw uint8 frames + per-sample
draw parameters; the augment math runs as one tiny jitted program on
the accelerator.

Host-side numpy augmentation costs ~8 full-image passes at
single-thread memory bandwidth per batch — the wall of the
packed-ingest pipeline. On the accelerator the same math is
microseconds, and shipping uint8 instead of normalized float32 cuts the
host->device image bytes 4x. Parameters are drawn on the host with the
same (seed, epoch, batch, idx) discipline as every other augmentation
path (exact resume), math is identical to images.augment_av_frame /
apply_av_batch (reference recipe, dataset.py:104-126).
"""

from __future__ import annotations

from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from triad.data.images import IMAGENET_MEAN, IMAGENET_STD


def av_param_arrays(params: List[dict]) -> Dict[str, np.ndarray]:
    """draw_av_params dicts -> plain arrays for device transfer."""
    return {
        "aug_flip": np.array([p["flip"] for p in params], np.bool_),
        "aug_brightness": np.array(
            [p["brightness"] for p in params], np.float32
        ),
        "aug_contrast": np.array([p["contrast"] for p in params], np.float32),
        "aug_saturation": np.array(
            [p["saturation"] for p in params], np.float32
        ),
    }


@jax.jit
def device_augment_av(frames_u8, flip, brightness, contrast, saturation):
    """(B, H, W, 3) uint8 + per-sample params -> normalized float32.

    Identity factors (1.0 / flip=False) make every op a no-op, so one
    traced program covers all draw combinations.
    """
    x = frames_u8.astype(jnp.float32) / 255.0
    x = jnp.where(flip[:, None, None, None], x[:, :, ::-1, :], x)
    x = x * brightness[:, None, None, None]
    mean = jnp.mean(x, axis=(1, 2), keepdims=True)
    x = (x - mean) * contrast[:, None, None, None] + mean
    gray = jnp.mean(x, axis=3, keepdims=True)
    s = saturation[:, None, None, None]
    x = x * s + gray * (1.0 - s)
    x = jnp.clip(x, 0.0, 1.0)
    return (x - jnp.asarray(IMAGENET_MEAN)) / jnp.asarray(IMAGENET_STD)


@jax.jit
def audio_i16_to_f32(a16):
    return a16.astype(jnp.float32) / 32767.0


_audio_i16_to_f32 = audio_i16_to_f32  # back-compat alias


def tv_param_arrays(params: List[dict]) -> Dict[str, np.ndarray]:
    """draw_tv_params dicts -> plain arrays for device transfer."""
    return {
        "aug_flip": np.array([p["flip"] for p in params], np.bool_),
        "aug_dx": np.array([p["dx"] for p in params], np.int32),
        "aug_dy": np.array([p["dy"] for p in params], np.int32),
        "aug_perm": np.array([p["perm"] for p in params], np.int32),
        "aug_factors": np.array(
            [p["factors"] for p in params], np.float32
        ),
    }


_TV_MAX_SHIFT = 32  # >= round(0.1 * image_size) for 224-class inputs


@jax.jit
def device_augment_tv(frames_u8, flip, dx, dy, perm, factors):
    """(B, H, W, 3) uint8 + draw_tv_params arrays -> normalized float32.

    Same math as images.apply_tv_image (reference LocalCaptionDataset
    transform, dataset.py:32-44): hflip, integer translate with zero
    fill, the three jitter ops applied in the drawn ORDER (perm[k] = op
    applied k-th with factors[k]), ImageNet normalize. The translate is
    a per-sample dynamic_slice of a zero-padded copy; the ordered
    jitter evaluates all three candidate ops per stage and selects —
    elementwise work is microseconds on the accelerator.
    """
    x = frames_u8.astype(jnp.float32) / 255.0
    x = jnp.where(flip[:, None, None, None], x[:, :, ::-1, :], x)

    h, w = x.shape[1], x.shape[2]
    pad = _TV_MAX_SHIFT
    xp = jnp.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))

    def shift_one(img, dy1, dx1):
        # out[y, x] = img[y - dy, x - dx], zero outside (images._translate)
        return jax.lax.dynamic_slice(
            img, (pad - dy1, pad - dx1, 0), (h, w, 3)
        )

    x = jax.vmap(shift_one)(xp, dy, dx)

    lw = jnp.asarray([0.299, 0.587, 0.114], jnp.float32)
    for k in range(3):
        f = factors[:, k][:, None, None, None]
        sel = perm[:, k][:, None, None, None]
        bright = jnp.clip(x * f, 0.0, 1.0)
        gray = jnp.sum(x * lw, axis=3, keepdims=True)
        gmean = jnp.mean(gray, axis=(1, 2), keepdims=True)
        contr = jnp.clip(f * x + (1.0 - f) * gmean, 0.0, 1.0)
        sat = jnp.clip(f * x + (1.0 - f) * gray, 0.0, 1.0)
        x = jnp.where(sel == 0, bright, jnp.where(sel == 1, contr, sat))
    return (x - jnp.asarray(IMAGENET_MEAN)) / jnp.asarray(IMAGENET_STD)


def device_ingest_tv(batch: Dict) -> Dict:
    """Prefetcher ``device_put`` callable for raw TV batches: uint8
    frames + draw params + pre-tokenized ids at wire width; augment
    math on device. Passes through host-augmented batches untouched."""
    if "frames_u8" not in batch:
        return {
            k: jax.device_put(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()
        }
    frames, flip, dx, dy, perm, factors, ids, mask = jax.device_put((
        batch["frames_u8"], batch["aug_flip"], batch["aug_dx"],
        batch["aug_dy"], batch["aug_perm"], batch["aug_factors"],
        batch["token_ids"], batch["text_mask"],
    ))
    out = {
        "images": device_augment_tv(frames, flip, dx, dy, perm, factors),
        "token_ids": ids,
        "text_mask": mask,
    }
    if "captions" in batch:
        out["captions"] = batch["captions"]
    return out


def device_ingest_av(batch: Dict) -> Dict:
    """Prefetcher ``device_put`` callable for raw AV batches: transfers
    uint8 frames + int16 audio + params at wire width (4x / 2x fewer
    host->device bytes than fp32) and augments/converts on device.
    Passes through already-augmented batches untouched (mixed
    pipelines)."""
    if "frames_u8" not in batch:
        return {
            k: jax.device_put(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()
        }
    # ONE device_put of the whole pytree: the four O(B) param vectors
    # ride the frame transfer instead of paying per-call dispatch.
    frames, flip, bright, contr, sat = jax.device_put((
        batch["frames_u8"], batch["aug_flip"], batch["aug_brightness"],
        batch["aug_contrast"], batch["aug_saturation"],
    ))
    images = device_augment_av(frames, flip, bright, contr, sat)
    if "audio_i16" in batch:
        audio = _audio_i16_to_f32(jax.device_put(batch["audio_i16"]))
    else:
        audio = jax.device_put(batch["audio"])
    out = {"images": images, "audio": audio}
    if "video_paths" in batch:
        out["video_paths"] = batch["video_paths"]
    return out
