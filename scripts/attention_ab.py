"""End-to-end A/B of the encoders' attention implementations on one GPU.

Times, in one process and on the same parameters and inputs, the two
programs that the attention choice of ``h100_model_config`` decides:

- bench.py's eval forward + both losses at B=64, with HuBERT on the
  flash kernel or on cuDNN's fused forward (the ViT stays on flash,
  which beat cuDNN at its 261 tokens);
- the Trainer's jitted joint train step (full model, 22 AV + 22 TV
  clips, the H100 training loss), with the ViT and HuBERT attention on
  the flash kernel or on XLA.

Each variant compiles first; then the variants are timed in rounds
A B, B A, A B, ... so that drift hits both alike, each call ending in
``block_until_ready``. The eval variants must agree on the loss.
Prints one JSON line per program and variant, each with the card's name
and power limit; exits non-zero without a GPU.

  python scripts/attention_ab.py [--rounds 4] [--steps 5]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402
import chip_smoke  # noqa: E402

# (ViT, HuBERT) attention per variant; DistilBERT stays on XLA.
TRAIN_VARIANTS = {"flash": ("flash", "flash"), "xla": ("xla", "xla")}
EVAL_VARIANTS = {"flash": ("flash", "flash"),
                 "cudnn_hubert": ("flash", "cudnn")}


def with_attention(model_cfg, vit: str, hubert: str):
    return dataclasses.replace(
        model_cfg,
        vit=dataclasses.replace(model_cfg.vit, attention_impl=vit),
        hubert=dataclasses.replace(model_cfg.hubert, attention_impl=hubert),
    )


def alternate(runs, rounds: int, steps: int):
    """{name: seconds per call} over ``rounds`` blocks of ``steps`` calls
    each, the order of ``runs`` reversed every other round."""
    names = list(runs)
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            for _ in range(steps):
                t = time.perf_counter()
                runs[name]()
                times[name].append(time.perf_counter() - t)
    return times


def _agree(losses, what: str) -> None:
    ref = next(iter(losses.values()))
    for name, loss in losses.items():
        rel = abs(loss - ref) / abs(ref)
        if not rel <= chip_smoke.LOSS_REL_TOL:
            raise AssertionError(f"{what}: {name} loss {loss} vs {ref}")


def train_step_ab(model_cfg, loss_cfg, sizes, variants, workdir):
    """The Trainer's own joint step per variant (built as the training CLI
    builds it, without training), alternately timed."""
    import jax

    from triad.train.trainer import Trainer

    runs, info, first_loss = {}, {}, {}
    for name, (vit, hubert) in variants.items():
        run_dir = Path(workdir) / name
        run_dir.mkdir()
        config = chip_smoke.train_config(
            with_attention(model_cfg, vit, hubert), loss_cfg, sizes,
            str(run_dir), epochs=1,
        )
        trainer = Trainer(config, force_new_training=True)
        step = trainer._steps["joint"]
        state, *rest = chip_smoke.joint_step_args(trainer)
        t0 = time.perf_counter()
        compiled = step.lower(state, *rest).compile()
        compile_s = time.perf_counter() - t0
        holder = [state]

        def run(step=step, holder=holder, rest=rest):
            holder[0], metrics = step(holder[0], *rest)
            jax.block_until_ready((holder[0], metrics))
            return metrics

        first_loss[name] = float(run()["train_loss"])
        runs[name] = run
        info[name] = {"compile_s": compile_s, "temp_bytes": int(
            compiled.memory_analysis().temp_size_in_bytes)}
        trainer.ckpt.close()
    # The variants draw different attention-dropout masks (the kernel's
    # hash vs jax.random), so their training losses agree only loosely.
    if not all(np.isfinite(list(first_loss.values()))):
        raise AssertionError(f"train step losses {first_loss}")
    return runs, info, first_loss


def eval_ab(model_cfg, loss_cfg, sizes, variants):
    """bench.py's fwd+loss per variant on one set of params and inputs."""
    import jax

    from triad.models import init_triad_model

    params = init_triad_model(model_cfg, jax.random.key(0))
    inputs = bench.make_inputs(sizes.eval_batch, model_cfg.vit.image_size)
    inputs = (inputs[0], inputs[1][:, : sizes.audio_samples],
              inputs[2][:, : sizes.text_len], inputs[3][:, : sizes.text_len])
    runs, info, loss = {}, {}, {}
    for name, (vit, hubert) in variants.items():
        cfg = with_attention(model_cfg, vit, hubert)
        fn = jax.jit(bench.make_fwd_loss(cfg, loss_cfg))
        t0 = time.perf_counter()
        compiled = fn.lower(params, *inputs).compile()
        compile_s = time.perf_counter() - t0
        loss[name] = float(fn(params, *inputs)["loss"])
        runs[name] = (lambda fn=fn: jax.block_until_ready(fn(params, *inputs)))
        info[name] = {"compile_s": compile_s, "temp_bytes": int(
            compiled.memory_analysis().temp_size_in_bytes)}
    _agree(loss, "eval fwd+loss")
    return runs, info, loss


def report(program, card, runs, info, loss, rounds, steps, clips):
    times = alternate(runs, rounds, steps)
    records = []
    for name in runs:
        mean = float(np.mean(times[name]))
        records.append({
            "program": program, "variant": name, "card": card,
            "step_ms_mean": 1e3 * mean, "step_ms_min": 1e3 * min(times[name]),
            "clips_per_s": clips / mean, "loss": loss[name], **info[name],
        })
        print(json.dumps(records[-1]), flush=True)
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args(argv)

    bench.require_gpu()
    card = bench.card_name_and_power_limit()
    print(card, flush=True)

    from triad.cli.common import enable_compile_cache
    from triad.core.config import (
        h100_model_config,
        perf_eval_loss_config,
        perf_train_loss_config,
    )

    enable_compile_cache()
    sizes = chip_smoke.Sizes()
    model_cfg = h100_model_config()
    runs, info, loss = eval_ab(model_cfg, perf_eval_loss_config(), sizes,
                               EVAL_VARIANTS)
    report("eval_fwd_loss", card, runs, info, loss, args.rounds, args.steps,
           sizes.eval_batch)
    del runs
    with tempfile.TemporaryDirectory(prefix="attention_ab_") as work:
        runs, info, loss = train_step_ab(
            model_cfg, perf_train_loss_config(), sizes, TRAIN_VARIANTS, work,
        )
        report("train_step", card, runs, info, loss, args.rounds, args.steps,
               sizes.batch_av + sizes.batch_tv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
