"""Benchmark: tri-modal clips/s (fwd + loss) on one GPU at bf16.

Runs the full-size tri-modal model (DINOv2 ViT-B/14+reg+LoRA, HuBERT-base
on 10 s audio, DistilBERT, 512-d projections) plus both max-mean InfoNCE
losses under the H100 configuration (``h100_model_config``,
``perf_eval_loss_config``) at batch 64, and reports clips per second.

Timing: warm-up calls compile, then each timed step ends in
``block_until_ready``. Everything printed names the device it ran on:
platform, device kind and count, the card's name and power limit as
``nvidia-smi`` reports them, and ``peak_bytes_in_use``. There is no CPU
fallback: without a GPU the script exits non-zero.

  python bench.py [--batch 64] [--steps 10]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

AUDIO_SAMPLES = 160_000  # 10 s @ 16 kHz
TEXT_LEN = 32


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpu() -> dict:
    """The JAX device description; raises SystemExit without a GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX found {devices[0].platform} devices only"
        )
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def peak_bytes_in_use():
    """Peak bytes the first device's arrays took (None where the backend
    keeps no memory statistics, e.g. the CPU)."""
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else int(stats["peak_bytes_in_use"])


def make_inputs(batch: int, image_size: int = 224, seed: int = 0):
    """Random (images, audio, token_ids, text_mask) at the model's
    real widths."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    return (
        jnp.asarray(rng.normal(size=(batch, image_size, image_size, 3)),
                    jnp.float32),
        jnp.asarray(rng.normal(size=(batch, AUDIO_SAMPLES)) * 0.1,
                    jnp.float32),
        jnp.asarray(rng.integers(1, 30_000, size=(batch, TEXT_LEN)),
                    jnp.int32),
        jnp.ones((batch, TEXT_LEN), jnp.float32),
    )


def make_fwd_loss(model_cfg, loss_cfg):
    """fwd_loss(params, images, audio, token_ids, text_mask) -> dict of
    the tri-modal features and both losses (eval mode)."""
    from triad.models import TriadModel
    from triad.ops import av_loss, tv_loss

    model = TriadModel(model_cfg)

    def fwd_loss(params, images, audio, token_ids, text_mask):
        out = model.apply(
            {"params": params}, images, audio, token_ids, text_mask,
            train=False,
        )
        temp = params["temperature"]
        av = av_loss(out["audio"], out["visual"], temp, loss_cfg)
        tv = tv_loss(out["text"], out["visual"], text_mask, temp, loss_cfg)
        return {**out, "loss_av": av.total, "loss_tv": tv.total,
                "loss": av.total + tv.total}

    return fwd_loss


def time_calls(fn, *args, steps: int = 10, warmup: int = 2) -> dict:
    """Compile, warm up, then time ``steps`` calls, each ending in
    block_until_ready. Returns seconds: compile, mean and per-step."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    for _ in range(warmup - 1):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(steps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t)
    return {"compile_s": compile_s, "step_s": float(np.mean(times)),
            "steps_s": times}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args(argv)

    device = require_gpu()
    card = card_name_and_power_limit()

    import jax

    from triad.cli.common import enable_compile_cache
    from triad.core.config import h100_model_config, perf_eval_loss_config
    from triad.models import init_triad_model

    enable_compile_cache()
    cfg, loss_cfg = h100_model_config(), perf_eval_loss_config()
    params = init_triad_model(cfg, jax.random.key(0))
    run = jax.jit(make_fwd_loss(cfg, loss_cfg))
    timing = time_calls(run, params, *make_inputs(args.batch),
                        steps=args.steps)
    print(json.dumps({
        "metric": f"tri-modal clips/s (fwd+loss, bf16, B={args.batch}, "
                  f"10 s audio)",
        "value": args.batch / timing["step_s"],
        "unit": "clips/s",
        "step_ms": timing["step_s"] * 1e3,
        "compile_s": timing["compile_s"],
        "peak_bytes_in_use": peak_bytes_in_use(),
        "card": card,
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
