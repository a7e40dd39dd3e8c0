"""End-to-end ingest-at-consumption-rate proof.

scripts/data_throughput.py measures decode in isolation; this script
wires decode to the device: a real TriadPack AV loader (decode +
augmentation + device_put via the trainer's Prefetcher) plus a TV loader
(WordPiece tokenize + image aug) feed the PRODUCTION joint train step
(StepFactory, h100_model_config, donated state) for >= N real
dispatched steps, i.e. exactly the Trainer.train() hot-loop structure.

Reports sustained clips/s INCLUDING data against the step-only rate; if
the two match, host ingest on this machine's cores covers the device's
consumption. Prints one JSON line.

Run: python scripts/ingest_train_e2e.py [steps] [workers] [worker_mode]
"""

import json
import sys
import time

sys.path.insert(0, ".")

import jax

from triad.cli.common import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

B = 64
AUDIO_SECS = 10.0
AUDIO_SAMPLES = int(AUDIO_SECS * 16_000)
TEXT_LEN = 32
IMAGE = 224


def main() -> None:
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    workers = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    # arg 3: AV worker mode — "thread" (default) or "process" (spawned
    # decode workers).
    worker_mode = sys.argv[3] if len(sys.argv) > 3 else "thread"

    import os
    import shutil
    import tempfile

    from triad.core.config import OptimConfig, h100_model_config
    from triad.data.datasets import (
        SyntheticAVDataset,
        SyntheticTVDataset,
    )
    from triad.data.packed import PackedAVDataset, pack_dataset
    from triad.data.pipeline import AVLoader, Prefetcher, TVLoader, cycling
    from triad.data.tokenizer import WordPieceTokenizer
    from triad.models import init_triad_model
    from triad.train.optim import OptimizerBank, ParamPartition
    from triad.train.step import StepFactory, init_train_state

    from triad.core.config import perf_train_loss_config

    model_cfg = h100_model_config()
    loss_cfg = perf_train_loss_config()
    # Tiny LR: this script measures INGEST THROUGHPUT, not convergence —
    # at the default lr the random-noise toy objective drifts upward.
    # Real-data stability is pinned by the parity trajectories and
    # tests/test_learning.py, not by this harness.
    optim_cfg = OptimConfig(
        gradient_accumulation_steps=1, learning_rate=1e-6
    )
    params = init_triad_model(model_cfg, jax.random.key(0))
    partition = ParamPartition(params)
    bank = OptimizerBank(optim_cfg, partition, total_updates=10_000)
    factory = StepFactory(model_cfg, loss_cfg, optim_cfg, bank)
    state = init_train_state(params, bank, jax.random.key(1))
    step = jax.jit(factory.make_step("joint"), donate_argnums=0)
    one = jnp.float32(1.0)

    # -- data: packed AV shard + synthetic-caption TV, trainer loaders --
    tmp = tempfile.mkdtemp(prefix="triad_ingest_e2e_")
    try:
        n_clips = 256
        src = SyntheticAVDataset(
            size=n_clips, image_size=IMAGE, audio_seconds=AUDIO_SECS
        )
        path = os.path.join(tmp, "e2e.tpack")
        t0 = time.perf_counter()
        pack_dataset(src, path, image_size=IMAGE, audio_samples=AUDIO_SAMPLES)
        print(
            f"# packed {n_clips} clips in {time.perf_counter() - t0:.1f}s",
            file=sys.stderr,
        )
        av_ds = PackedAVDataset(path)
        # Production ingest shape (configs/h100_scale.yaml): wire-dtype
        # device augmentation — host work per clip is one memcpy; the
        # augment math runs on the device (data/device_aug.py).
        # TRIAD_INGEST_HOSTAUG=1 measures host-side augmentation.
        devaug = os.environ.get("TRIAD_INGEST_HOSTAUG") != "1"
        av_loader = AVLoader(
            av_ds, batch_size=B, audio_num_samples=AUDIO_SAMPLES,
            num_workers=workers, worker_mode=worker_mode, seed=0,
            device_augment=devaug,
        )
        if devaug:
            # File-backed captions (the production TV path): decoded
            # uint8 + draw params ship to the device, augment math
            # on the device — 4x fewer image wire bytes than fp32.
            from PIL import Image

            cap_root = os.path.join(tmp, "caps", "a")
            os.makedirs(cap_root)
            rng0 = np.random.default_rng(1)
            for i in range(256):
                arr = rng0.integers(
                    0, 256, size=(IMAGE, IMAGE, 3)
                ).astype(np.uint8)
                Image.fromarray(arr).save(
                    os.path.join(cap_root, f"i{i}.jpg"), quality=90
                )
                with open(os.path.join(cap_root, f"i{i}.txt"), "w") as f:
                    f.write(f"synthetic caption number {i}")
            from triad.data.datasets import LocalCaptionDataset

            tv_ds = LocalCaptionDataset(
                os.path.join(tmp, "caps"), image_size=IMAGE
            )
            corpus = [f"synthetic caption number {i}" for i in range(64)]
        else:
            tv_ds = SyntheticTVDataset(size=256, image_size=IMAGE)
            corpus = [
                tv_ds.__getitem__(i, apply_augmentation=False)[1]
                for i in range(64)
            ]
        tok = WordPieceTokenizer.build_from_corpus(corpus)
        tv_loader = TVLoader(
            tv_ds, tok, B, max_text_tokens=TEXT_LEN, seed=0,
            num_workers=max(1, workers // 4), device_augment=devaug,
        )

        def put_av(b):
            return {
                "images": jnp.asarray(b["images"]),
                "audio": jnp.asarray(b["audio"]),
            }

        def put_tv(b):
            return {
                "images": jnp.asarray(b["images"]),
                "token_ids": jnp.asarray(b["token_ids"]),
                "text_mask": jnp.asarray(b["text_mask"]),
            }

        if devaug:
            from triad.data.device_aug import device_ingest_av

            def put_av_fn(b):
                out = device_ingest_av(b)
                # the jitted step's batch pytree is arrays only
                return {"images": out["images"], "audio": out["audio"]}
        else:
            put_av_fn = put_av
        av_it = Prefetcher(
            cycling(lambda e, b: av_loader.epoch(e, b)), prefetch=4,
            device_put=put_av_fn,
        )
        if devaug:
            from triad.data.device_aug import device_ingest_tv

            def put_tv_fn(b):
                out = device_ingest_tv(b)
                return {
                    "images": out["images"],
                    "token_ids": out["token_ids"],
                    "text_mask": out["text_mask"],
                }
        else:
            put_tv_fn = put_tv
        tv_it = Prefetcher(
            cycling(lambda e, b: tv_loader.epoch(e, b)), prefetch=4,
            device_put=put_tv_fn,
        )

        # Warm: compile + fill prefetch queues.
        state, metrics = step(state, next(av_it), next(tv_it), one, one)
        t_compile = time.perf_counter()
        print(f"# compiled+first step at +{t_compile - t0:.0f}s",
              file=sys.stderr)
        for _ in range(3):
            state, metrics = step(state, next(av_it), next(tv_it), one, one)
        float(metrics["train_loss"])  # sync before the clock

        t0 = time.perf_counter()
        nan_reported = False
        # TRIAD_INGEST_PROBE=1: per-step loss readbacks (syncs every
        # step — diagnostic mode, throughput number invalid) so the
        # EXACT culprit batch of a NaN is still in hand for forensics.
        probe_every = 1 if os.environ.get("TRIAD_INGEST_PROBE") else 5
        wait_s = 0.0  # time blocked on the prefetchers = host starvation
        disp_s = 0.0  # step dispatch (async submit, not completion)
        for i in range(steps):
            tw = time.perf_counter()
            av_b, tv_b = next(av_it), next(tv_it)
            td = time.perf_counter()
            wait_s += td - tw
            state, metrics = step(state, av_b, tv_b, one, one)
            disp_s += time.perf_counter() - td
            if (i + 1) % probe_every == 0 and i + 1 < steps:
                # Cheap progress probes (one ~30 ms readback each):
                # pins WHERE a divergence/NaN enters a long run.
                li = float(metrics["train_loss"])
                print(f"# step {i + 1}: loss={li:.4f}",
                      file=sys.stderr, flush=True)
                if li != li and not nan_reported:
                    nan_reported = True
                    import jax.numpy as _jnp

                    for nm, bb in (("av", av_b), ("tv", tv_b)):
                        for k2, v2 in bb.items():
                            if hasattr(v2, "dtype") and _jnp.issubdtype(
                                v2.dtype, _jnp.floating
                            ):
                                print(
                                    f"# NaN forensics {nm}.{k2}: finite="
                                    f"{bool(_jnp.all(_jnp.isfinite(v2)))} "
                                    f"max|x|={float(_jnp.max(_jnp.abs(v2))):.3e}",
                                    file=sys.stderr, flush=True,
                                )
                    import jax as _jax

                    bad = [
                        p for p, v2 in _jax.tree_util.tree_leaves_with_path(
                            state.params
                        )
                        if _jnp.issubdtype(v2.dtype, _jnp.floating)
                        and not bool(_jnp.all(_jnp.isfinite(v2)))
                    ]
                    print(
                        f"# NaN forensics: {len(bad)} non-finite param "
                        f"leaves"
                        + (f"; first: {bad[:3]}" if bad else ""),
                        file=sys.stderr, flush=True,
                    )
        loss = float(metrics["train_loss"])  # one readback ends the clock
        dt = (time.perf_counter() - t0) / steps
        av_it.close()
        tv_it.close()

        print(json.dumps({
            "metric": "train clips/s incl. packed ingest "
                      f"(joint step, B={B}, {workers} {worker_mode} workers)",
            "value": round(B / dt, 1),
            "unit": "clips/s",
            "step_ms": round(dt * 1e3, 1),
            # where the wall lives: blocked-on-prefetcher time is host
            # ingest starvation; the remainder of step_ms is device
            # compute + the h2d transfers.
            "host_wait_ms": round(wait_s / steps * 1e3, 1),
            "dispatch_ms": round(disp_s / steps * 1e3, 1),
            "steps": steps,
            "final_loss": round(loss, 4),
        }))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    print(f"# devices: {jax.devices()}", file=sys.stderr)
    main()
