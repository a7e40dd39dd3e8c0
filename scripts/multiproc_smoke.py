"""Multi-process data-parallel training smoke: 2 CPU processes x 4
virtual devices each == the single-process 8-device mesh.

Proves the multi-host enablement end to end through the PRODUCTION
Trainer (parallel/distributed.py + the loaders' process_shard row
slicing + Trainer._put's make_array_from_process_local_data): every
process runs the same deterministic samplers, decodes only its rows,
and the jitted DP step sees bitwise the same global batches as a
single-process run — so the final temperature and parameters must match
the single-process reference. Three phases, all judged against the ONE
single-process reference run:

  dp      2 coordinated processes, pure DP (+ZeRO-1) over dp8.
  tp      the same over a dp4 x tp2 mesh (multi-host x tensor-parallel
          x ZeRO composition, parallel/tp.py + zero.py param_specs).
  resume  both workers are PREEMPTED (os._exit) right after the
          mid-epoch step-2 checkpoint, then fresh workers autoresume
          from the shared Orbax checkpoint and finish — the reference
          mid-epoch-resume contract (train.py:914-926) at multi-host
          scale.

Parent mode (no TRIAD_PROCESS_ID in the env):
  python scripts/multiproc_smoke.py [dp] [tp] [resume]   # default: all

Worker mode (TRIAD_PROCESS_ID set): train and print
``FINAL temp=<x> checksum=<y>``.

(run by tests/test_parallel.py::test_multiprocess_dp_matches_single_process)
"""

import os
import re
import socket
import subprocess
import sys
import tempfile

sys.path.insert(0, ".")

N_PROCESSES = 2
DEVICES_PER_PROCESS = 4


def worker() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")

    # identical tiny graphs recur across phases — share compiles
    from triad.cli.common import enable_compile_cache

    enable_compile_cache()

    import dataclasses
    from pathlib import Path

    import numpy as np

    from triad.core.config import MeshConfig
    from triad.parallel.distributed import initialize_from_env

    pid, pc = initialize_from_env()
    print(f"process {pid}/{pc} devices={jax.device_count()} "
          f"local={jax.local_device_count()}", flush=True)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tests.test_trainer import tiny_config
    from triad.train.trainer import Trainer

    cfg = tiny_config(Path(os.environ["TRIAD_SMOKE_DIR"]))
    tp = 2 if os.environ.get("TRIAD_SMOKE_TP") else 1
    train = cfg.train
    if os.environ.get("TRIAD_SMOKE_SAVE_EVERY"):
        train = dataclasses.replace(
            train, save_every_steps=int(os.environ["TRIAD_SMOKE_SAVE_EVERY"])
        )
    cfg = dataclasses.replace(
        cfg,
        train=train,
        mesh=MeshConfig(num_devices=8, tp=tp),
        data=dataclasses.replace(
            cfg.data, batch_size_av=8, batch_size_tv=8,
            synthetic_av_size=16, synthetic_tv_size=16,
        ),
    )
    resume = bool(os.environ.get("TRIAD_SMOKE_RESUME"))
    trainer = Trainer(cfg, force_new_training=not resume)
    if resume:
        assert int(trainer.progress.global_step) == 2, trainer.progress
    if pc > 1:
        assert trainer._proc_shard == (pid, pc), trainer._proc_shard

    if os.environ.get("TRIAD_SMOKE_STOP_AFTER_SAVE"):
        # Simulate preemption: stop right after the first (mid-epoch)
        # checkpoint lands. sys.exit (not os._exit): both workers leave
        # at the same logical point and the distributed-runtime
        # shutdown barrier synchronizes them — an abrupt kill of the
        # process hosting the coordination service makes the OTHER
        # worker die fatally mid-save, which is a different test.
        orig = trainer.save_checkpoint

        def save_and_die(is_best=False):
            orig(is_best)
            print("PREEMPTED_AFTER_SAVE", flush=True)
            sys.exit(0)

        trainer.save_checkpoint = save_and_die

    trainer.train()
    # temperature + whole-tree checksum pin the final parameters; both
    # must match the single-process reference bit-for-bit-ish (the only
    # tolerated difference is collective reduction order).
    from triad.parallel.distributed import fetch

    temp = float(fetch(trainer.state.params["temperature"]))
    leaves = jax.tree_util.tree_leaves(trainer.state.params)
    checksum = float(sum(np.abs(fetch(l)).sum() for l in leaves))
    print(f"FINAL temp={temp:.8f} checksum={checksum:.6f}", flush=True)


def _spawn(env_extra, tag):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEVICES_PER_PROCESS}"
    )
    env.update(env_extra)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ), tag


def _final(output: str, tag: str):
    m = re.search(r"FINAL temp=([-\d.]+) checksum=([-\d.]+)", output)
    if not m:
        raise RuntimeError(f"{tag} produced no FINAL line:\n{output[-4000:]}")
    return float(m.group(1)), float(m.group(2))


def _run_workers(run_dir, tag, env_extra=None, expect_final=True):
    """Spawn N coordinated workers; return [(temp, checksum)] or None
    (expect_final=False: preemption phase, workers die mid-run).

    Retries ONCE on gloo rendezvous timeouts: on a slow/1-core box a
    cold compile cache can skew the workers' first-collective entry
    past gloo's hardcoded 30 s store timeout (a CPU-only test-infra
    artifact — GPU collectives use NCCL); the retry runs with the warm
    cache, so the skew is gone. Any other failure raises immediately.
    """
    for attempt in (1, 2, 3):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [
            _spawn(
                {
                    "TRIAD_SMOKE_DIR": run_dir,
                    "TRIAD_COORDINATOR": f"127.0.0.1:{port}",
                    "TRIAD_NUM_PROCESSES": str(N_PROCESSES),
                    "TRIAD_PROCESS_ID": str(i),
                    **(env_extra or {}),
                },
                f"{tag}{i}",
            )
            for i in range(N_PROCESSES)
        ]
        outs = [p.communicate(timeout=900)[0] for p, _ in procs]
        if any(p.returncode for p, _ in procs):
            gloo_skew = any(
                "Gloo context initialization failed" in o
                or "DEADLINE_EXCEEDED" in o
                for o in outs
            )
            if gloo_skew and attempt < 3:
                print(f"phase {tag}: gloo rendezvous timeout (cold-cache "
                      "compile skew) — retrying with warm cache", flush=True)
                continue
            for (p, t), o in zip(procs, outs):
                assert p.returncode == 0, f"{t} rc={p.returncode}\n{o[-4000:]}"
        break

    results = []
    for (_, t), out in zip(procs, outs):
        if expect_final:
            results.append(_final(out, t))
            print(f"{t}: temp={results[-1][0]:.8f} "
                  f"checksum={results[-1][1]:.6f}", flush=True)
        else:
            assert "PREEMPTED_AFTER_SAVE" in out, out[-4000:]
            print(f"{t}: preempted after mid-epoch checkpoint", flush=True)
    return results if expect_final else None


def _check(results, ref_temp, ref_sum, tag):
    for temp, chk in results:
        assert abs(temp - ref_temp) <= 1e-5 * max(1.0, abs(ref_temp)), (
            tag, temp, ref_temp,
        )
        assert abs(chk - ref_sum) <= 1e-4 * max(1.0, abs(ref_sum)), (
            tag, chk, ref_sum,
        )
    print(f"phase {tag}: PASSED", flush=True)


def parent(phases) -> None:
    # single-process 8-device reference, judged by every phase
    with tempfile.TemporaryDirectory() as ref_dir:
        p, _ = _spawn(
            {
                "TRIAD_SMOKE_DIR": ref_dir,
                "TRIAD_PROCESS_ID": "0",
                "TRIAD_NUM_PROCESSES": "1",
                "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
            },
            "reference",
        )
        out, _ = p.communicate(timeout=900)
        assert p.returncode == 0, out[-4000:]
        ref_temp, ref_sum = _final(out, "reference")
        print(f"reference: temp={ref_temp:.8f} checksum={ref_sum:.6f}")

    if "dp" in phases:
        with tempfile.TemporaryDirectory() as d:
            _check(_run_workers(d, "dp"), ref_temp, ref_sum, "dp")

    if "tp" in phases:
        with tempfile.TemporaryDirectory() as d:
            _check(
                _run_workers(d, "tp", {"TRIAD_SMOKE_TP": "1"}),
                ref_temp, ref_sum, "tp",
            )

    if "resume" in phases:
        with tempfile.TemporaryDirectory() as d:
            # save_every_steps=1: the first mid-epoch checkpoint lands
            # after micro-step 2 of 3 (global_step=2, batch cursor 2) —
            # the preempted run really does leave work behind.
            _run_workers(
                d, "preempt",
                {"TRIAD_SMOKE_SAVE_EVERY": "1",
                 "TRIAD_SMOKE_STOP_AFTER_SAVE": "1"},
                expect_final=False,
            )
            _check(
                _run_workers(
                    d, "resume",
                    {"TRIAD_SMOKE_SAVE_EVERY": "1",
                     "TRIAD_SMOKE_RESUME": "1"},
                ),
                ref_temp, ref_sum, "resume",
            )

    print("MULTIPROCESS SMOKE PASSED")


if __name__ == "__main__":
    if os.environ.get("TRIAD_PROCESS_ID") is not None:
        worker()
    else:
        parent(sys.argv[1:] or ["dp", "tp", "resume"])
