"""Optimizer-bank tests: grouping, schedules vs torch OneCycleLR, staged
unfreeze + AdamW trajectories vs a torch reference, subtree clipping."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from triad.core.config import OptimConfig
from triad.train.optim import (
    FROZEN_GROUP,
    OptimizerBank,
    ParamPartition,
    clip_grads,
    gate_grads,
    group_schedules,
)


def tiny_params():
    """Param tree shaped like TriadModel's top level."""
    k = lambda s: jnp.full((3,), s, jnp.float32)
    return {
        "audio_backbone": {"layer_0": {"kernel": k(0.1)}},
        "audio_projection": {"projection1": {"kernel": k(0.2)}},
        "text_backbone": {"layer_0": {"kernel": k(0.3)}},
        "text_projection": {"projection1": {"kernel": k(0.4)}},
        "visual_backbone": {
            "block_0": {
                "attn": {
                    "qkv": {
                        "kernel": k(0.5),
                        "lora_a": k(0.6),
                        "lora_b": k(0.7),
                    }
                }
            }
        },
        "visual_projection": {"projection1": {"kernel": k(0.8)}},
        "temperature": jnp.asarray(1.5),
    }


class TestPartition:
    def test_labels(self):
        p = ParamPartition(tiny_params())
        by_path = dict(zip(p.path_strings(), p.labels))
        assert by_path["audio_backbone/layer_0/kernel"] == "audio"
        assert by_path["text_backbone/layer_0/kernel"] == "text"
        assert by_path["visual_backbone/block_0/attn/qkv/lora_a"] == "vit_lora"
        assert by_path["visual_backbone/block_0/attn/qkv/lora_b"] == "vit_lora"
        assert by_path["visual_backbone/block_0/attn/qkv/kernel"] == FROZEN_GROUP
        assert by_path["audio_projection/projection1/kernel"] == "others"
        assert by_path["temperature"] == "others"

    def test_split_merge_roundtrip(self):
        params = tiny_params()
        p = ParamPartition(params)
        merged = p.merge(p.split(params))
        jax.tree.map(np.testing.assert_array_equal, merged, params)


class TestOneCycleVsTorch:
    @pytest.mark.parametrize("total,peak", [(100, 1e-4), (37, 3e-4)])
    def test_schedule_matches_torch_onecycle(self, total, peak):
        cfg = OptimConfig(learning_rate=peak)
        sched = group_schedules(cfg, total)["others"]
        dummy = torch.nn.Parameter(torch.zeros(1))
        opt = torch.optim.SGD([dummy], lr=peak)
        tsched = torch.optim.lr_scheduler.OneCycleLR(
            opt, max_lr=peak, total_steps=total, pct_start=0.1,
            div_factor=10, final_div_factor=1e4, anneal_strategy="cos",
        )
        for step in range(total):
            ours = float(sched(step))
            theirs = tsched.get_last_lr()[0]
            np.testing.assert_allclose(ours, theirs, rtol=2e-4)
            opt.step()
            tsched.step() if step < total - 1 else None


class TestStagedUnfreezeVsTorch:
    @pytest.mark.slow
    def test_adamw_trajectory_with_delayed_group(self):
        """Two params: 'others' (always on) and 'audio' (unfrozen at step
        5). Compare 20 updates against torch AdamW + reference gating:
        audio optimizer first steps at update 5 with fresh Adam state and
        its own shortened OneCycle."""
        unfreeze = 5
        total = 20
        lr = 1e-2
        cfg = OptimConfig(
            learning_rate=lr, unfreeze_audio_step=unfreeze,
            unfreeze_text_step=0, unfreeze_vit_step=0,
            gradient_accumulation_steps=1,
        )
        rng = np.random.default_rng(0)
        w_o = rng.normal(size=(4,)).astype(np.float32)
        w_a = rng.normal(size=(4,)).astype(np.float32)
        grads_seq = rng.normal(size=(total, 2, 4)).astype(np.float32)

        # --- torch reference ---
        t_o = torch.nn.Parameter(torch.from_numpy(w_o.copy()))
        t_a = torch.nn.Parameter(torch.from_numpy(w_a.copy()))
        opt_o = torch.optim.AdamW([t_o], lr=lr)
        opt_a = torch.optim.AdamW([t_a], lr=lr * 0.25)
        sch_o = torch.optim.lr_scheduler.OneCycleLR(
            opt_o, max_lr=lr, total_steps=total, pct_start=0.1,
            div_factor=10, final_div_factor=1e4, anneal_strategy="cos",
        )
        sch_a = torch.optim.lr_scheduler.OneCycleLR(
            opt_a, max_lr=lr * 0.25, total_steps=total - unfreeze,
            pct_start=0.1, div_factor=10, final_div_factor=1e4,
            anneal_strategy="cos",
        )
        step_o = step_a = 0
        for s in range(total):
            t_o.grad = torch.from_numpy(grads_seq[s, 0].copy())
            opt_o.step(); opt_o.zero_grad()
            if step_o < total - 1:
                sch_o.step(); step_o += 1
            if s >= unfreeze:
                t_a.grad = torch.from_numpy(grads_seq[s, 1].copy())
                opt_a.step(); opt_a.zero_grad()
                if step_a < (total - unfreeze) - 1:
                    sch_a.step(); step_a += 1

        # --- ours ---
        params = {
            "audio_projection": {"w": jnp.asarray(w_o)},  # 'others' group
            "audio_backbone": {"w": jnp.asarray(w_a)},  # 'audio' group
        }
        part = ParamPartition(params)
        bank = OptimizerBank(cfg, part, total_updates=total)
        state = bank.init(params)
        for s in range(total):
            grads = {
                "audio_projection": {"w": jnp.asarray(grads_seq[s, 0])},
                "audio_backbone": {"w": jnp.asarray(grads_seq[s, 1])},
            }
            grads = gate_grads(grads, part, cfg, jnp.asarray(s))
            updates, state, _ = bank.update(grads, state, params, jnp.asarray(s))
            params = jax.tree.map(jnp.add, params, updates)

        np.testing.assert_allclose(
            np.asarray(params["audio_projection"]["w"]), t_o.detach().numpy(),
            rtol=2e-4, atol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(params["audio_backbone"]["w"]), t_a.detach().numpy(),
            rtol=2e-4, atol=1e-6,
        )

    def test_frozen_vit_base_never_moves(self):
        cfg = OptimConfig(gradient_accumulation_steps=1)
        params = tiny_params()
        part = ParamPartition(params)
        bank = OptimizerBank(cfg, part, total_updates=10)
        state = bank.init(params)
        grads = jax.tree.map(jnp.ones_like, params)
        grads = gate_grads(grads, part, cfg, jnp.asarray(0))
        updates, state, _ = bank.update(grads, state, params, jnp.asarray(0))
        frozen_update = updates["visual_backbone"]["block_0"]["attn"]["qkv"]["kernel"]
        np.testing.assert_array_equal(np.asarray(frozen_update), 0.0)
        lora_update = updates["visual_backbone"]["block_0"]["attn"]["qkv"]["lora_a"]
        assert np.abs(np.asarray(lora_update)).max() > 0


class TestClipping:
    def test_subtree_clip_matches_torch(self):
        cfg = OptimConfig(clip_norm=10.0)
        rng = np.random.default_rng(1)
        params = tiny_params()
        part = ParamPartition(params)
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 50),
            params,
        )
        clipped, metrics = clip_grads(grads, part, cfg)

        # torch clip_grad_norm_ over the audio subtree (backbone + proj).
        audio_leaves = [
            np.asarray(grads["audio_backbone"]["layer_0"]["kernel"]),
            np.asarray(grads["audio_projection"]["projection1"]["kernel"]),
        ]
        t = [torch.from_numpy(a.copy()).requires_grad_(True) for a in audio_leaves]
        for p, a in zip(t, audio_leaves):
            p.grad = torch.from_numpy(a.copy())
        torch.nn.utils.clip_grad_norm_(t, 10.0)
        np.testing.assert_allclose(
            np.asarray(clipped["audio_backbone"]["layer_0"]["kernel"]),
            t[0].grad.numpy(), rtol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(clipped["audio_projection"]["projection1"]["kernel"]),
            t[1].grad.numpy(), rtol=1e-5,
        )
        # Other groups are untouched by clipping.
        np.testing.assert_array_equal(
            np.asarray(clipped["visual_projection"]["projection1"]["kernel"]),
            np.asarray(grads["visual_projection"]["projection1"]["kernel"]),
        )
        assert metrics["grad_norm_others"] > 0


class TestMomentDtype:
    @pytest.mark.slow
    def test_bf16_moments_halve_state_and_track_fp32(self):
        """bf16 moment storage: state dtype is bf16, trajectory stays
        close to the fp32 bank over a short horizon (storage-only knob)."""
        params = tiny_params()
        rng = np.random.default_rng(3)
        grads_seq = [
            jax.tree.map(
                lambda x: jnp.asarray(
                    rng.normal(size=x.shape).astype(np.float32) * 0.1
                ),
                params,
            )
            for _ in range(5)
        ]

        def run(cfg):
            part = ParamPartition(params)
            bank = OptimizerBank(cfg, part, total_updates=100)
            state = bank.init(params)
            p = params
            for i, g in enumerate(grads_seq):
                upd, state, _ = bank.update(
                    g, state, p, jnp.asarray(i, jnp.int32)
                )
                p = jax.tree.map(jnp.add, p, upd)
            return p, state

        base = OptimConfig(unfreeze_audio_step=0, unfreeze_text_step=0)
        lowp = OptimConfig(
            unfreeze_audio_step=0, unfreeze_text_step=0,
            mu_dtype="bfloat16", nu_dtype="bfloat16",
        )
        p32, _ = run(base)
        p16, s16 = run(lowp)

        mu_leaf = s16.adam["others"][0].mu[0]
        nu_leaf = s16.adam["others"][0].nu[0]
        assert mu_leaf.dtype == jnp.bfloat16
        assert nu_leaf.dtype == jnp.bfloat16

        diffs = jax.tree.map(
            lambda a, b: float(jnp.max(jnp.abs(a - b))), p32, p16
        )
        assert max(jax.tree.leaves(diffs)) < 5e-4
