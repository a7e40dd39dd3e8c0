"""Integration tests for the jitted train steps: loss decreases on a
fixed synthetic batch, accumulation boundaries, phase variants, and
metric plumbing (SURVEY §4 'implication for the rebuild')."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from triad.core.config import LossConfig, OptimConfig
from triad.models import init_triad_model
from triad.train import (
    OptimizerBank,
    ParamPartition,
    StepFactory,
    init_train_state,
)
from tests.test_multimodal import small_model_config


@pytest.fixture(scope="module")
def setup():
    model_cfg = small_model_config(visual_dropout_prob=0.0)
    loss_cfg = LossConfig()
    optim_cfg = OptimConfig(
        learning_rate=1e-3,
        gradient_accumulation_steps=2,
        unfreeze_audio_step=4,
        unfreeze_text_step=4,
        unfreeze_vit_step=4,
    )
    params = init_triad_model(model_cfg, jax.random.key(0))
    partition = ParamPartition(params)
    bank = OptimizerBank(optim_cfg, partition, total_updates=50)
    factory = StepFactory(model_cfg, loss_cfg, optim_cfg, bank)
    state = init_train_state(params, bank, jax.random.key(1))
    rng = np.random.default_rng(0)
    av_batch = {
        "images": jnp.asarray(rng.normal(size=(2, 28, 28, 3)).astype(np.float32)),
        "audio": jnp.asarray(rng.normal(size=(2, 1600)).astype(np.float32)),
    }
    tv_batch = {
        "images": jnp.asarray(rng.normal(size=(2, 28, 28, 3)).astype(np.float32)),
        "token_ids": jnp.asarray(rng.integers(1, 100, size=(2, 8))),
        "text_mask": jnp.asarray(
            np.array([[1] * 8, [1] * 6 + [0] * 2], dtype=np.float32)
        ),
    }
    return factory, state, av_batch, tv_batch


@pytest.mark.slow
def test_joint_step_loss_decreases(setup):
    factory, state, av_batch, tv_batch = setup
    step = jax.jit(factory.make_step("joint"))
    one = jnp.float32(1.0)
    losses = []
    for _ in range(14):
        state, metrics = step(state, av_batch, tv_batch, one, one)
        losses.append(float(metrics["train_loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], f"no learning: {losses[0]} -> {losses[-1]}"


@pytest.mark.slow
def test_accumulation_boundary_updates_params(setup):
    factory, state, av_batch, tv_batch = setup
    step = jax.jit(factory.make_step("av"))
    one = jnp.float32(1.0)
    p0 = state.params["temperature"]
    # accum=2: micro step 0 must NOT update params, step 1 must.
    state, m0 = step(state, av_batch, None, one, one)
    assert float(state.params["temperature"]) == float(p0)
    assert float(m0["lr_others"]) == 0.0  # no update this micro step
    state, m1 = step(state, av_batch, None, one, one)
    assert float(state.params["temperature"]) != float(p0)
    assert float(m1["lr_others"]) > 0.0
    assert float(m1["grad_norm_others"]) > 0.0
    # frozen vit group norm is exactly zero
    assert float(m1["grad_norm_vit"]) == 0.0


@pytest.mark.slow
def test_av_phase_has_no_tv_metrics(setup):
    factory, state, av_batch, tv_batch = setup
    step = jax.jit(factory.make_step("av"))
    one = jnp.float32(1.0)
    _, metrics = step(state, av_batch, None, one, one)
    assert "loss_av" in metrics and "loss_tv" not in metrics
    assert "av_separation" in metrics


@pytest.mark.slow
def test_tv_phase(setup):
    factory, state, av_batch, tv_batch = setup
    step = jax.jit(factory.make_step("tv"))
    one = jnp.float32(1.0)
    state, metrics = step(state, None, tv_batch, one, one)
    assert "loss_tv" in metrics and "loss_av" not in metrics
    assert np.isfinite(float(metrics["loss_tv"]))


@pytest.mark.slow
def test_eval_loss_deterministic(setup):
    factory, state, av_batch, tv_batch = setup
    ev = jax.jit(factory.make_eval_loss("joint"))
    one = jnp.float32(1.0)
    m1 = ev(state.params, av_batch, tv_batch, one, one)
    m2 = ev(state.params, av_batch, tv_batch, one, one)
    assert float(m1["train_loss"]) == float(m2["train_loss"])


def test_joint_step_with_flash_attention():
    """The flash attention kernel (interpret mode on CPU) with live
    attention dropout in every encoder, plus the custom-VJP chunked
    loss, runs the full joint step end-to-end: finite loss, params
    move."""
    import dataclasses

    from triad.core.config import h100_model_config

    flash = h100_model_config()
    model_cfg = small_model_config(visual_dropout_prob=0.0)
    model_cfg = dataclasses.replace(model_cfg, **{
        name: dataclasses.replace(
            getattr(model_cfg, name),
            attention_impl=getattr(flash, name).attention_impl,
        )
        for name in ("vit", "hubert", "text")
    })
    loss_cfg = LossConfig(implementation="chunked_vjp", chunk_size=2)
    optim_cfg = OptimConfig(
        gradient_accumulation_steps=1,
        unfreeze_audio_step=0, unfreeze_text_step=0, unfreeze_vit_step=0,
    )
    params = init_triad_model(model_cfg, jax.random.key(0))
    bank = OptimizerBank(optim_cfg, ParamPartition(params), total_updates=10)
    factory = StepFactory(model_cfg, loss_cfg, optim_cfg, bank)
    state = init_train_state(params, bank, jax.random.key(1))
    rng = np.random.default_rng(0)
    av = {
        "images": jnp.asarray(
            rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
        ),
        "audio": jnp.asarray(
            rng.normal(size=(2, 1600)).astype(np.float32)
        ),
    }
    tv = {
        "images": jnp.asarray(
            rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
        ),
        "token_ids": jnp.asarray(rng.integers(1, 100, size=(2, 8))),
        "text_mask": jnp.ones((2, 8), jnp.float32),
    }
    step = jax.jit(factory.make_step("joint"))
    one = jnp.float32(1.0)
    state2, metrics = step(state, av, tv, one, one)
    loss = float(metrics["train_loss"])
    assert np.isfinite(loss)
    assert float(state2.params["temperature"]) != float(
        state.params["temperature"]
    )
