"""Smoke test of the tri-modal trainer on a GPU, through its entry points.

  python chip_smoke.py          # phases 1-6 on one card
  python chip_smoke.py --four   # DP training on 4 cards vs one device

Phases, in order, in one process (one process per card):

1. env      — platform, device kind and count, the card's name and power
              limit, the package census, the compile-cache directory.
2. train    — the real Trainer through ``triad.cli.train.main`` at
              full model width (2 blocks per encoder) on synthetic
              data, H100 config, 22 AV + 22 TV clips per step: a first
              run writes a checkpoint, a second run resumes from it;
              then timed steps on the resumed Trainer, each ending in
              block_until_ready.
3. fwd+loss — bench.py's forward + both losses at B=64 under the H100
              config, against the float32 parity reference on the
              same parameters and inputs.
4. kernels  — the flash attention kernel compiled at the encoders' real
              attention shapes against the float32 reference (dropout
              mask included), with its time beside XLA's; cuDNN's fused
              attention is tried at the same shapes and its answer shown.
5. serve    — a random-init bundle exported for cuda
              (``triad.cli.export.main``; full width, 2 blocks per
              encoder) answers 3 requests from ``serve/server.py``
              running in this process.
6. nan rows — the XLA conv frontend on the two checked-in audio rows that
              once drove the GroupNorm variance negative: finite output.

``--four`` runs only the four-card path: data-parallel training with
all-gathered negatives through ``triad.cli.train.main`` with
``mesh.num_devices=4`` (one process driving all cards; full width, 1
block per encoder) against the same command on one device at the same
global batch, and checks the Trainer's compiled step for all-gathers of
encoder activations.

Every phase prints one JSON line carrying the card's name and power
limit. Any failed check raises, so the script exits non-zero; the last
line, printed only on success, is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Phase functions take their configs and sizes as arguments, so the CPU
tests run them at tiny widths with Pallas in interpret mode; only
``main`` refuses a machine without a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import io
import json
import math
import re
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

import bench

REPO = Path(__file__).resolve().parent
NAN_ROWS = REPO / "tests" / "data" / "nan_culprit_audio_rows.npz"
CENSUS = ("flax", "orbax.checkpoint", "msgpack", "rich", "yaml", "PIL", "cv2")

# Tolerances (reasons in PERF.md): bf16 compute through 12 layers vs the
# float32 reference; bf16 kernel inputs with float32 accumulation.
EMBED_MIN_COSINE = 0.99
LOSS_REL_TOL = 0.02
KERNEL_MAX_ABS = 2e-2
KERNEL_GRAD_REL_L2 = 2e-2
DP_LOSS_REL_TOL = 0.02


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Every phase's shapes; the defaults are the real ones."""

    batch_av: int = 22
    batch_tv: int = 22
    # 4 micro-steps = one optimizer update at the reference's
    # accumulation of 4, so a restore that lost the params would show.
    train_steps: int = 4
    timed_steps: int = 3
    eval_batch: int = 64
    bench_steps: int = 5
    audio_samples: int = 160_000
    text_len: int = 32
    # (batch, tokens, heads, head_dim, dropout rate, key mask):
    # HuBERT 10 s, ViT 224/14 + CLS + 4 registers, DistilBERT text.
    attention: Tuple[Tuple[int, int, int, int, float, bool], ...] = (
        (64, 499, 12, 64, 0.1, False),
        (64, 261, 12, 64, 0.0, False),
        (64, 32, 12, 64, 0.1, True),
    )
    kernel_steps: int = 10
    serve_batch: int = 1
    four_batch: int = 24


class CompileClock:
    """Seconds JAX spent compiling, from jax.monitoring."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **kwargs) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration


def emit(phase: str, card: str, **fields) -> Dict[str, Any]:
    record = {"phase": phase, "card": card, **fields}
    print(json.dumps(record, default=float), flush=True)
    return record


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# -- 1. env -------------------------------------------------------------------


def package_census() -> Dict[str, str]:
    out = {}
    for name in CENSUS:
        try:
            mod = importlib.import_module(name)
        except ImportError:
            out[name] = "absent"
        else:
            out[name] = str(getattr(mod, "__version__", "present"))
    return out


def phase_env(card: str) -> Dict[str, Any]:
    import jax

    from triad.cli.common import enable_compile_cache

    devices = jax.devices()
    return emit(
        "env", card, python=".".join(map(str, sys.version_info[:3])),
        jax=jax.__version__, platform=devices[0].platform,
        device_kind=devices[0].device_kind, device_count=len(devices),
        packages=package_census(), compile_cache=enable_compile_cache(),
    )


# -- 2. train -----------------------------------------------------------------


def train_config(model_cfg, loss_cfg, sizes: Sizes, workdir: str,
                 epochs: int):
    """The reference's training setup (batch 22 + 22, accumulation 4),
    synthetic data, all epochs joint AV+TV, no periodic hooks. 32
    synthetic clips per modality (or one batch, if larger), so the
    retrieval eval at each epoch's end embeds 8 clips in one batch."""
    from triad.core.config import Config, DataConfig, TrainConfig

    clips = max(sizes.batch_av, sizes.batch_tv, 32)
    data = DataConfig(
        audio_num_samples=sizes.audio_samples,
        image_size=model_cfg.vit.image_size,
        max_text_tokens=sizes.text_len,
        batch_size_av=sizes.batch_av, batch_size_tv=sizes.batch_tv,
        synthetic_av_size=clips, synthetic_tv_size=clips,
    )
    never = 10**9
    train = TrainConfig(
        num_epochs=epochs, steps_per_epoch=sizes.train_steps,
        av_focus_epochs=0, tv_warmup_epochs=0, weighted_joint_epochs=0,
        vis_every=never, save_every_steps=never, validation_frequency=never,
        output_dir=workdir, seed=0,
    )
    return Config(model=model_cfg, loss=loss_cfg, data=data, train=train)


def _run_cli_train(config, workdir: str, force_new: bool):
    from triad.cli.train import main as train_main

    path = Path(workdir) / f"config_{config.train.num_epochs}.json"
    path.write_text(config.to_json())
    argv = ["--config", str(path)] + (["--force-new"] if force_new else [])
    return train_main(argv)


def _train_records(workdir: str):
    """The Trainer's per-step metric records (metrics.jsonl)."""
    for line in (Path(workdir) / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if "train_loss" in rec and "training_phase" in rec:
            yield rec


def _logged_losses(workdir: str) -> Dict[int, float]:
    return {int(r["global_step"]): float(r["train_loss"])
            for r in _train_records(workdir)}


def joint_step_args(trainer):
    """(state, av_batch, tv_batch, w_av, w_tv) for the trainer's joint
    step, from its own loaders and device-put path."""
    import jax.numpy as jnp

    av = next(iter(trainer.av_loader.epoch(0)))
    tv = next(iter(trainer.tv_loader.epoch(0)))
    one = jnp.float32(1.0)
    return (trainer.state, trainer._device_av(av), trainer._device_tv(tv),
            one, one)


def _params_checksum(params) -> float:
    import jax

    return float(sum(np.abs(np.asarray(x, np.float64)).sum()
                     for x in jax.tree.leaves(params)))


def phase_train(model_cfg, loss_cfg, sizes: Sizes, card: str,
                clock: CompileClock) -> Dict[str, Any]:
    import jax

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as work:
        config = train_config(model_cfg, loss_cfg, sizes, work, epochs=1)
        c0, t0 = clock.seconds, time.perf_counter()
        trainer = _run_cli_train(config, work, force_new=True)
        run_s, run_compile_s = time.perf_counter() - t0, clock.seconds - c0
        saved = trainer.ckpt.latest_step()
        _check(saved == sizes.train_steps,
               f"checkpoint at step {saved}, expected {sizes.train_steps}")
        trained = _params_checksum(trainer.state.params)

        # The same command again resumes from the checkpoint: the run is
        # complete, so it restores and trains nothing.
        resumed = _run_cli_train(config, work, force_new=False)
        _check(resumed.progress.global_step == sizes.train_steps,
               f"resumed at step {resumed.progress.global_step}")
        restored = _params_checksum(resumed.state.params)
        _check(restored == trained,
               f"resumed params differ: {restored} vs {trained}")
        resumed.ckpt.close()
        del resumed
        logged = _logged_losses(work)

        # Steady-state steps on the already-compiled joint step.
        step = trainer._steps["joint"]
        args = joint_step_args(trainer)
        state = args[0]
        losses, times = [], []
        for _ in range(sizes.timed_steps):
            t = time.perf_counter()
            state, metrics = step(state, *args[1:])
            jax.block_until_ready((state, metrics))
            times.append(time.perf_counter() - t)
            losses.append(float(metrics["train_loss"]))
        trainer.ckpt.close()
        del trainer, state, args

    all_losses = list(logged.values()) + losses
    _check(all(math.isfinite(x) for x in all_losses),
           f"non-finite training loss: {all_losses}")
    return emit(
        "train", card,
        clips_per_step=sizes.batch_av + sizes.batch_tv,
        logged_losses={str(k): v for k, v in sorted(logged.items())},
        timed_losses=losses, step_s=times,
        step_s_mean=float(np.mean(times)),
        run_wall_s=run_s, run_compile_s=run_compile_s,
        resumed_step=sizes.train_steps,
        peak_bytes_in_use=bench.peak_bytes_in_use(),
    )


# -- 3. fwd+loss ----------------------------------------------------------------


def parity_config(model_cfg):
    """The float32 reference: XLA attention, float32 compute."""
    return dataclasses.replace(model_cfg, compute_dtype="float32", **{
        name: dataclasses.replace(getattr(model_cfg, name),
                                  attention_impl="xla")
        for name in ("vit", "hubert", "text")
    })


def _token_cosines(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    num = (a * b).sum(-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return num / np.maximum(den, 1e-30)


def phase_fwd_loss(model_cfg, loss_cfg, sizes: Sizes, card: str,
                   steps: int) -> Dict[str, Any]:
    import jax

    from triad.core.config import LossConfig
    from triad.models import init_triad_model

    params = init_triad_model(model_cfg, jax.random.key(0))
    inputs = bench.make_inputs(sizes.eval_batch, model_cfg.vit.image_size)
    inputs = (inputs[0], inputs[1][:, : sizes.audio_samples],
              inputs[2][:, : sizes.text_len], inputs[3][:, : sizes.text_len])
    run = jax.jit(bench.make_fwd_loss(model_cfg, loss_cfg))
    got = run(params, *inputs)
    timing = (bench.time_calls(run, params, *inputs, steps=steps)
              if steps else None)
    ref_fn = bench.make_fwd_loss(parity_config(model_cfg), LossConfig())
    with jax.default_matmul_precision("highest"):
        want = jax.jit(ref_fn)(params, *inputs)

    cos = {k: _token_cosines(got[k], want[k]) for k in ("visual", "audio",
                                                        "text")}
    loss, loss_ref = float(got["loss"]), float(want["loss"])
    rel = abs(loss - loss_ref) / abs(loss_ref)
    record = emit(
        "fwd_loss", card, batch=sizes.eval_batch,
        min_token_cosine={k: float(v.min()) for k, v in cos.items()},
        mean_token_cosine={k: float(v.mean()) for k, v in cos.items()},
        loss=loss, loss_ref=loss_ref, loss_rel_err=rel,
        step_s=None if timing is None else timing["step_s"],
        clips_per_s=None if timing is None
        else sizes.eval_batch / timing["step_s"],
        compile_s=None if timing is None else timing["compile_s"],
        peak_bytes_in_use=bench.peak_bytes_in_use(),
    )
    for k, v in cos.items():
        _check(v.min() >= EMBED_MIN_COSINE,
               f"{k} token cosine {v.min()} < {EMBED_MIN_COSINE}")
    _check(rel <= LOSS_REL_TOL, f"loss rel err {rel} > {LOSS_REL_TOL}")
    return record


# -- 4. kernels -------------------------------------------------------------------


def _rel_l2(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_kernels(sizes: Sizes, card: str, steps: int,
                  probe_cudnn: bool) -> Dict[str, Any]:
    import jax
    import jax.numpy as jnp

    from triad.models.layers import attention
    from triad.ops.flash_attention import (
        attention_reference,
        dropout_keep_mask,
        flash_attention,
    )

    rows = []
    for b, n, h, d, rate, masked in sizes.attention:
        rng = np.random.default_rng(n)
        q, k, v, do = (jnp.asarray(rng.normal(size=(b, n, h, d)),
                                   jnp.bfloat16) for _ in range(4))
        km = None
        if masked:
            m = rng.random((b, n)) > 0.25
            m[:, 0] = True
            km = jnp.asarray(m, jnp.float32)
        seed = 17

        def kern(q, k, v):
            return flash_attention(q, k, v, km, dropout_rate=rate, seed=seed)

        def ref(q, k, v):
            return attention_reference(q, k, v, km, dropout_rate=rate,
                                       seed=seed)

        def grads(f):
            return jax.jit(lambda q, k, v, do: jax.vjp(f, q, k, v)[1](do))

        out = jax.jit(kern)(q, k, v)
        g = grads(kern)(q, k, v, do)
        f32 = lambda x: x.astype(jnp.float32)
        with jax.default_matmul_precision("highest"):
            out_ref = jax.jit(ref)(*map(f32, (q, k, v)))
            g_ref = grads(ref)(*map(f32, (q, k, v, do)))
        row = {
            "shape": [b, n, h, d], "dropout": rate, "key_mask": masked,
            "max_abs_err": float(jnp.max(jnp.abs(f32(out) - out_ref))),
            "grad_rel_l2": [_rel_l2(x, y) for x, y in zip(g, g_ref)],
        }
        _check(row["max_abs_err"] <= KERNEL_MAX_ABS, f"flash fwd {row}")
        _check(max(row["grad_rel_l2"]) <= KERNEL_GRAD_REL_L2,
               f"flash grads {row}")
        if steps:
            mask4 = None if km is None else (km > 0)[:, None, None, :]
            rng_key = jax.random.key(0) if rate else None

            def xla(q, k, v):
                return attention(q, k, v, mask4, jnp.bfloat16, impl="xla",
                                 dropout_rate=rate, dropout_rng=rng_key)

            for name, f in (("flash", kern), ("xla", xla)):
                row[f"{name}_fwd_ms"] = 1e3 * bench.time_calls(
                    jax.jit(f), q, k, v, steps=steps)["step_s"]
                row[f"{name}_fwd_bwd_ms"] = 1e3 * bench.time_calls(
                    grads(f), q, k, v, do, steps=steps)["step_s"]
        if probe_cudnn:
            row["cudnn"] = _probe_cudnn(q, k, v, do, km, steps)
        rows.append(row)
    keep = float(np.asarray(dropout_keep_mask(3, 4, 12, 499, 0.1)).mean())
    _check(abs(keep - 0.9) < 0.01, f"keep rate {keep}")
    return emit("kernels", card, flash_attention=rows, keep_rate_p01=keep)


def _probe_cudnn(q, k, v, do, km, steps: int):
    """cuDNN's fused attention at the same shape (no dropout: it takes
    only a static seed). Reports each direction's time, or the reason
    cuDNN refused it."""
    import jax

    mask = None if km is None else (km > 0)[:, None, None, :]

    def f(q, k, v):
        return jax.nn.dot_product_attention(q, k, v, mask=mask,
                                            implementation="cudnn")

    out = {}
    for name, fn, args in (
        ("fwd", jax.jit(f), (q, k, v)),
        ("fwd_bwd", jax.jit(lambda q, k, v, do: jax.vjp(f, q, k, v)[1](do)),
         (q, k, v, do)),
    ):
        try:
            out[f"{name}_ms"] = 1e3 * bench.time_calls(
                fn, *args, steps=steps)["step_s"]
        except (NotImplementedError, ValueError) as e:
            out[f"{name}_refused"] = f"{type(e).__name__}: {e}"[:160]
    return out


# -- 5. serve -------------------------------------------------------------------


def _post(url: str, body: bytes, content_type: str) -> bytes:
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": content_type},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read()


def phase_serve(model_cfg, sizes: Sizes, card: str,
                platforms: str) -> Dict[str, Any]:
    from triad.cli.export import main as export_main
    from triad.core.config import Config, DataConfig
    from triad.serve.server import make_server

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as work:
        cfg = Config(model=model_cfg, data=DataConfig(
            audio_num_samples=sizes.audio_samples,
            image_size=model_cfg.vit.image_size,
            max_text_tokens=sizes.text_len,
        ))
        cfg_path = Path(work) / "config.json"
        cfg_path.write_text(cfg.to_json())
        t0 = time.perf_counter()
        export_main(["--random-init", "--config", str(cfg_path), "--out",
                     str(Path(work) / "bundle"), "--platforms", platforms])
        export_s = time.perf_counter() - t0

        srv = make_server(str(Path(work) / "bundle"), port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        rng = np.random.default_rng(0)
        b, size = sizes.serve_batch, model_cfg.vit.image_size
        requests = [
            ("/v1/embed/audio", rng.normal(size=(b, sizes.audio_samples))
             .astype(np.float32) * 0.1),
            ("/v1/embed/image", rng.normal(size=(b, size, size, 3))
             .astype(np.float32)),
        ]
        answers, times = {}, {}
        try:
            for path, arr in requests:
                buf = io.BytesIO()
                np.save(buf, arr)
                t = time.perf_counter()
                raw = _post(url + path, buf.getvalue(), "application/x-npy")
                times[path] = time.perf_counter() - t
                answers[path] = np.load(io.BytesIO(raw), allow_pickle=False)
            t = time.perf_counter()
            raw = _post(url + "/v1/embed/text", json.dumps(
                {"texts": ["a dog barks in the park"] * b}).encode(),
                "application/json")
            times["/v1/embed/text"] = time.perf_counter() - t
            answers["/v1/embed/text"] = np.asarray(
                json.loads(raw)["tokens"], np.float32)
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=60)
    shapes = {k: list(v.shape) for k, v in answers.items()}
    for k, v in answers.items():
        _check(v.shape[0] == b and v.shape[-1] == model_cfg.embedding_dim,
               f"{k} answered shape {v.shape}")
        _check(bool(np.isfinite(v).all()), f"{k} answered non-finite values")
    return emit("serve", card, platforms=platforms, export_s=export_s,
                request_s=times, answer_shapes=shapes)


# -- 6. nan rows ----------------------------------------------------------------


def frontend_features(hubert_cfg, compute_dtype: str,
                      audio: np.ndarray) -> np.ndarray:
    """The XLA conv frontend (random init, key 0) on normalized audio."""
    import jax
    import jax.numpy as jnp

    from triad.models.hubert import ConvFeatureEncoder, normalize_waveform

    enc = ConvFeatureEncoder(
        dataclasses.replace(hubert_cfg, frontend_impl="conv"),
        dtype=jnp.dtype(compute_dtype),
    )
    x = normalize_waveform(jnp.asarray(audio))
    params = enc.init(jax.random.key(0), x[:, :2000])["params"]
    return np.asarray(jax.jit(enc.apply)({"params": params}, x), np.float32)


def phase_nan_rows(model_cfg, card: str) -> Dict[str, Any]:
    rows = np.load(NAN_ROWS)["av_audio"]
    feats = frontend_features(model_cfg.hubert, model_cfg.compute_dtype, rows)
    finite = bool(np.isfinite(feats).all())
    record = emit("nan_rows", card, rows=int(rows.shape[0]),
                  features_shape=list(feats.shape), finite=finite)
    _check(finite, "non-finite frontend features on the culprit rows")
    return record


# -- --four -----------------------------------------------------------------------


_SHAPE = re.compile(r"\w+\[([\d,]+)\]")


def activation_all_gathers(hlo: str, batch: int, hidden_sizes: Sequence[int]):
    """Forward-pass all-gather lines of an HLO module whose result is a
    (batch, ..., hidden) encoder activation: what a batch-split step
    should never need. The backward may gather a small cotangent on
    purpose (the text-embedding gradient's scatter-add gathers the
    (B, N, C) cotangent instead of reducing a (vocab, C) gradient)."""
    bad = []
    for line in hlo.splitlines():
        if " all-gather(" not in line and " all-gather-start(" not in line:
            continue
        if "transpose(" in line.split("op_name=", 1)[-1]:
            continue
        lhs = line.split(" all-gather", 1)[0]
        for dims in _SHAPE.findall(lhs):
            shape = [int(x) for x in dims.split(",")]
            if (len(shape) >= 3 and shape[0] == batch
                    and shape[-1] in hidden_sizes):
                bad.append(line.strip()[:200])
                break
    return bad


def cut_depth(model_cfg, layers: int):
    """Every encoder cut to ``layers`` blocks; widths unchanged."""
    return dataclasses.replace(model_cfg, **{
        name: dataclasses.replace(getattr(model_cfg, name), num_layers=layers)
        for name in ("vit", "hubert", "text")
    })


def _four_config(model_cfg, loss_cfg, sizes: Sizes, workdir: str,
                 n_devices: int):
    """The four-card comparison's training run, on ``n_devices`` at the
    global batch ``four_batch`` AV + ``four_batch`` TV: every encoder
    unfrozen and one update per step, so each logged loss follows the
    earlier steps' gradients; 2 epochs of 2 steps, so the Trainer logs
    every step's loss."""
    from triad.core.config import MeshConfig, OptimConfig

    b = sizes.four_batch
    cfg = train_config(
        model_cfg, loss_cfg,
        dataclasses.replace(sizes, batch_av=b, batch_tv=b, train_steps=2),
        workdir, epochs=2,
    )
    return dataclasses.replace(
        cfg,
        train=dataclasses.replace(cfg.train, optim=OptimConfig(
            gradient_accumulation_steps=1, unfreeze_audio_step=0,
            unfreeze_text_step=0, unfreeze_vit_step=0,
        )),
        mesh=MeshConfig(num_devices=n_devices),
    )


def phase_four(model_cfg, loss_cfg, sizes: Sizes, card: str,
               n_devices: int, expect_kernel: bool) -> Dict[str, Any]:
    """Data-parallel training with all-gathered negatives through
    ``triad.cli.train.main`` with ``mesh.num_devices=n_devices`` (one
    process driving every card), against the same command on one device
    at the same global batch: same parameters, data and dropout masks, so
    the losses differ only by reduction order and rounding. The compiled
    joint step of the Trainer that ran on the mesh is then scanned for
    all-gathers of encoder activations and for the flash kernel."""
    import gc

    with tempfile.TemporaryDirectory(prefix="chip_smoke_four_") as work:
        losses, hlo, wall = {}, "", {}
        for n in (1, n_devices):
            run_dir = Path(work) / f"devices_{n}"
            run_dir.mkdir()
            config = _four_config(model_cfg, loss_cfg, sizes, str(run_dir), n)
            t0 = time.perf_counter()
            trainer = _run_cli_train(config, str(run_dir), force_new=True)
            wall[n] = time.perf_counter() - t0
            _check((trainer.mesh is None) == (n == 1),
                   f"{n} devices: mesh {trainer.mesh}")
            losses[n] = _logged_losses(str(run_dir))
            if n > 1:
                step = trainer._steps["joint"]
                hlo = step.lower(*joint_step_args(trainer)).compile().as_text()
            trainer.ckpt.close()
            del trainer
            gc.collect()

    steps = sorted(losses[1])
    single = [losses[1][s] for s in steps]
    dp = [losses[n_devices].get(s, math.nan) for s in steps]
    hidden = {model_cfg.vit.hidden_size, model_cfg.hubert.hidden_size,
              model_cfg.text.hidden_size}
    gathers = activation_all_gathers(hlo, sizes.four_batch, hidden)
    kernels = len(re.findall(r"xla\.gpu\.triton", hlo))
    rel = [abs(d - s_) / abs(s_) for d, s_ in zip(dp, single)]
    record = emit(
        "four", card, devices=n_devices, global_batch_av=sizes.four_batch,
        global_batch_tv=sizes.four_batch,
        layers_per_encoder=model_cfg.hubert.num_layers, steps=steps,
        dp_losses=dp, single_losses=single, loss_rel_err=rel,
        run_wall_s={str(k): v for k, v in wall.items()},
        triton_kernel_calls_in_hlo=kernels, activation_all_gathers=gathers,
        peak_bytes_in_use=bench.peak_bytes_in_use(),
    )
    _check(len(steps) == 4, f"logged steps {steps}")
    _check(all(math.isfinite(x) for x in dp + single), f"non-finite: {record}")
    _check(max(rel) <= DP_LOSS_REL_TOL, f"DP vs single losses differ: {rel}")
    _check(not gathers, f"encoder activations all-gathered: {gathers}")
    _check(kernels or not expect_kernel,
           "flash kernel missing from the DP step")
    return record


# -- main -----------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="only the 4-card DP path and its 1-device reference")
    args = p.parse_args(argv)

    device = bench.require_gpu()
    card = bench.card_name_and_power_limit()
    print(card, flush=True)

    from triad.core.config import (
        h100_model_config,
        perf_eval_loss_config,
        perf_train_loss_config,
    )

    model_cfg = h100_model_config()
    sizes = Sizes()
    phase_env(card)
    if args.four:
        _check(device["count"] >= 4, f"--four needs 4 cards: {device}")
        # Full width, depth cut to 1 block per encoder: the path under
        # test is the mesh, not the depth, and four cards cost four times.
        phase_four(cut_depth(model_cfg, 1), perf_train_loss_config(), sizes,
                   card, n_devices=4, expect_kernel=True)
    else:
        clock = CompileClock()
        # Full width, 2 blocks per encoder where depth adds only compile
        # time: the Trainer's programs and the export at full depth would
        # take much of the smoke's 20 minutes (PERF.md). fwd+loss keeps
        # the full depth.
        shallow = cut_depth(model_cfg, 2)
        phase_train(shallow, perf_train_loss_config(), sizes, card, clock)
        phase_fwd_loss(model_cfg, perf_eval_loss_config(), sizes, card,
                       steps=sizes.bench_steps)
        phase_kernels(sizes, card, steps=sizes.kernel_steps,
                      probe_cudnn=True)
        phase_serve(shallow, sizes, card, platforms="cuda")
        phase_nan_rows(model_cfg, card)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
