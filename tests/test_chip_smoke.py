"""chip_smoke.py's phases at tiny widths on the CPU (Pallas kernels in
interpret mode), its refusal to run without a GPU, and bench.py's."""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bench
import chip_smoke
from scripts import attention_ab
from tests.test_multimodal import small_model_config

REPO = Path(__file__).resolve().parent.parent
CARD = "CPU test (no card)"

TINY = chip_smoke.Sizes(
    batch_av=2, batch_tv=2, train_steps=2, timed_steps=1, eval_batch=2,
    bench_steps=0, audio_samples=1600, text_len=8,
    attention=((2, 37, 2, 16, 0.1, False), (2, 16, 2, 16, 0.0, True)),
    kernel_steps=0, serve_batch=1, four_batch=4,
)


def tiny_model(impl="flash", **kw):
    cfg = dataclasses.replace(small_model_config(), **kw)
    return dataclasses.replace(cfg, **{
        name: dataclasses.replace(getattr(cfg, name), attention_impl=impl)
        for name in ("vit", "hubert", "text")
    })


def tiny_loss():
    from triad.core.config import LossConfig

    return LossConfig(implementation="chunked_vjp", chunk_size=2,
                      matmul_precision="default", volume_dtype="bfloat16")


@pytest.mark.parametrize("entry", [chip_smoke.main, bench.main,
                                   attention_ab.main])
def test_refuses_to_run_without_a_gpu(entry, capsys):
    with pytest.raises(SystemExit) as e:
        entry([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_fails_alone_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_env():
    rec = chip_smoke.phase_env(CARD)
    assert rec["card"] == CARD and rec["device_count"] >= 1
    assert set(rec["packages"]) == set(chip_smoke.CENSUS)


def test_phase_train_checkpoints_and_resumes():
    clock = chip_smoke.CompileClock()
    rec = chip_smoke.phase_train(tiny_model(), tiny_loss(), TINY, CARD,
                                 clock)
    assert set(rec["logged_losses"]) == {"0", "1"}
    assert len(rec["timed_losses"]) == TINY.timed_steps
    assert rec["run_compile_s"] > 0


def test_phase_fwd_loss_matches_float32_reference():
    rec = chip_smoke.phase_fwd_loss(
        dataclasses.replace(tiny_model(), compute_dtype="bfloat16"),
        tiny_loss(), TINY, CARD, steps=0,
    )
    assert rec["loss_rel_err"] <= chip_smoke.LOSS_REL_TOL


def test_phase_kernels():
    rec = chip_smoke.phase_kernels(TINY, CARD, steps=0, probe_cudnn=False)
    assert len(rec["flash_attention"]) == len(TINY.attention)


def test_phase_serve_answers_three_requests():
    """bf16 compute, as on the card: answers still come back as float32."""
    rec = chip_smoke.phase_serve(
        dataclasses.replace(tiny_model("xla"), compute_dtype="bfloat16"),
        TINY, CARD, platforms="cpu",
    )
    assert set(rec["answer_shapes"]) == {
        "/v1/embed/audio", "/v1/embed/image", "/v1/embed/text"
    }


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_frontend_finite_on_nan_culprit_rows(dtype):
    """The two audio rows that once drove the GroupNorm variance
    negative: the full-size XLA conv frontend stays finite."""
    from triad.core.config import HubertConfig

    rows = np.load(chip_smoke.NAN_ROWS)["av_audio"]
    feats = chip_smoke.frontend_features(HubertConfig(), dtype, rows)
    assert feats.shape == (2, 499, 512)
    assert np.isfinite(feats).all()


def test_phase_nan_rows():
    rec = chip_smoke.phase_nan_rows(tiny_model(), CARD)
    assert rec["finite"]


def test_phase_four_dp_matches_single_device():
    """The training CLI on 4 virtual devices == the same CLI on one
    device at the same global batch, and the Trainer's own compiled DP
    step gathers no encoder activations (its output state is pinned to
    the input placement; the flash kernel runs under shard_map)."""
    model = chip_smoke.cut_depth(tiny_model(embedding_dim=16), 1)
    rec = chip_smoke.phase_four(model, tiny_loss(), TINY, CARD, n_devices=4,
                                expect_kernel=False)
    assert rec["activation_all_gathers"] == []
    assert rec["steps"] == [0, 1, 2, 3]
    assert rec["layers_per_encoder"] == 1


@pytest.mark.parametrize("line,bad", [
    ("%ag = bf16[24,499,768]{2,1,0} all-gather(bf16[6,499,768]{2,1,0} %x),"
     ' metadata={op_name="jit(step)/jvp()/conv_general_dilated"}', True),
    ("%ag = bf16[24,256,512]{2,1,0} all-gather(bf16[6,256,512]{2,1,0} %x)",
     False),
    ("%s = (bf16[6,32,768], bf16[24,32,768]) all-gather-start(bf16[6,32,768]"
     " %y)", True),
    ("%ag = bf16[24,32,768]{2,1,0} all-gather(bf16[6,32,768] %g),"
     ' metadata={op_name="jit(step)/transpose(jvp())/scatter-add"}', False),
    ("%ag = f32[128,48,768]{1,0,2} all-gather(f32[128,48,192] %d)", False),
    ("%d = bf16[24,499,768]{2,1,0} dot(bf16[24,499,768] %a, bf16[768,768]"
     " %b)", False),
])
def test_activation_all_gather_scan(line, bad):
    assert bool(chip_smoke.activation_all_gathers(line, 24, {768})) is bad


def test_attention_ab_times_each_variant(tmp_path):
    """The A/B script's train-step and eval legs at tiny size: every
    variant compiles, runs and is timed the same number of times."""
    variants = {"flash": ("flash", "flash"), "xla": ("xla", "xla")}
    runs, info, loss = attention_ab.train_step_ab(
        tiny_model("xla"), tiny_loss(), TINY, variants, str(tmp_path))
    recs = attention_ab.report("train_step", CARD, runs, info, loss,
                               rounds=2, steps=1, clips=4)
    assert [r["variant"] for r in recs] == ["flash", "xla"]
    runs, info, loss = attention_ab.eval_ab(
        tiny_model("xla"), tiny_loss(), TINY, variants)
    assert abs(loss["flash"] - loss["xla"]) <= 1e-3 * abs(loss["xla"])
    times = attention_ab.alternate(runs, rounds=3, steps=2)
    assert {k: len(v) for k, v in times.items()} == {"flash": 6, "xla": 6}
