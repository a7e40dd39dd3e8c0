"""Jitted train steps: fwd + loss + grad accumulation + 4-group update.

Replicates one iteration of the reference hot loop (train.py:932-1045):

  micro step: encode AV and/or TV batches, phase-weighted total loss,
  loss / grad_accum, accumulate grads; every ``gradient_accumulation_steps``
  micro steps: per-group grad norms, audio/text subtree clip, 4x gated
  AdamW update + schedule step.

Three step variants mirror the curriculum phases (train.py:880-905):
  "av"    — av_focus epochs: AV batch only
  "tv"    — tv_warmup epochs: TV batch only
  "joint" — weighted_joint / full_joint: both, with traced (w_av, w_tv)

All metrics (losses, sim stats, lrs, grad norms, temperature) are
computed inside the jitted step and returned as device scalars — the
reference's per-step ``.item()`` syncs (model.py:443-447 etc.) become a
single fetch after the step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import contextlib
import dataclasses

import jax
import jax.numpy as jnp

from triad.core.config import LossConfig, ModelConfig, OptimConfig
from triad.models.multimodal import TriadModel
from triad.ops import av_loss, tv_loss
from triad.train.optim import (
    BankState,
    OptimizerBank,
    clip_grads,
    gate_grads,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    """Everything the jitted step mutates. A pure pytree — checkpointable
    (train/checkpoint.py), shardable with jax.sharding."""

    params: Any
    opt: BankState
    grad_accum: Any  # same structure as params
    global_step: jax.Array  # micro step (reference global_step)
    rng: jax.Array

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def init_train_state(
    params: Any, bank: OptimizerBank, rng: jax.Array
) -> TrainState:
    # The grad accumulator (a params-sized buffer) only exists when
    # gradient accumulation is on; with accum == 1 the step applies
    # grads directly (saves ~1 GB HBM + a round of memory traffic at
    # full size).
    accum = bank.cfg.gradient_accumulation_steps
    zeros = jax.tree.map(jnp.zeros_like, params) if accum > 1 else None
    return TrainState(
        params=params,
        opt=bank.init(params),
        grad_accum=zeros,
        global_step=jnp.zeros((), jnp.int32),
        rng=rng,
    )


class StepFactory:
    """Builds the jitted per-phase train steps for a TriadModel."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        loss_cfg: LossConfig,
        optim_cfg: OptimConfig,
        bank: OptimizerBank,
        mesh=None,
        mesh_axis="data",
    ):
        """``mesh``: optional jax.sharding.Mesh with a 'data' axis. When
        set, the losses use the distributed all-gathered-negatives path
        (triad.parallel.dp) — batches must be sharded along
        ``mesh_axis`` (a name or a tuple of names for multi-slice
        meshes) and params replicated; gradients flow through the
        collectives."""
        self.model = TriadModel(model_cfg)
        self.loss_cfg = loss_cfg
        self.optim_cfg = optim_cfg
        self.bank = bank
        self.partition = bank.partition
        self.mesh = mesh
        self.mesh_axis = mesh_axis

    def mesh_context(self):
        """Context for tracing the encoders. Under a data-parallel mesh
        (every axis carries the batch) they see it as the abstract mesh,
        so per-example ops the partitioner cannot split by batch run
        under shard_map instead (models/layers.over_batch). TP and FSDP
        meshes carry a non-batch axis and keep plain GSPMD."""
        axes = (self.mesh_axis,) if isinstance(self.mesh_axis, str) \
            else tuple(self.mesh_axis)
        if self.mesh is None or set(self.mesh.axis_names) != set(axes):
            return contextlib.nullcontext()
        return jax.sharding.use_abstract_mesh(self.mesh.abstract_mesh)

    # -- loss -----------------------------------------------------------

    def compute_losses(
        self,
        params: Any,
        av_batch: Optional[Dict[str, jax.Array]],
        tv_batch: Optional[Dict[str, jax.Array]],
        rng: jax.Array,
        w_av: jax.Array,
        w_tv: jax.Array,
        train: bool = True,
    ) -> Tuple[jax.Array, Dict[str, jax.Array]]:
        """Phase-weighted total loss + metrics dict.

        av_batch: {"images": (B,H,W,3), "audio": (B,T)}
        tv_batch: {"images": (B,H,W,3), "token_ids": (B,Nt), "text_mask": (B,Nt)}
        """
        temp = params["temperature"]
        metrics: Dict[str, jax.Array] = {"temperature": temp}

        total = jnp.zeros((), jnp.float32)
        rng_av, rng_tv = jax.random.split(rng)

        if av_batch is not None:
            with self.mesh_context():
                feats = self.model.apply(
                    {"params": params},
                    av_batch["images"],
                    av_batch["audio"],
                    train=train,
                    rngs={"dropout": rng_av},
                    method=_encode_av,
                )
            if self.mesh is not None:
                from triad.parallel.dp import distributed_av_loss

                av = distributed_av_loss(
                    feats["audio"], feats["visual"], temp, self.loss_cfg,
                    self.mesh, axis=self.mesh_axis,
                )
            else:
                av = av_loss(
                    feats["audio"], feats["visual"], temp, self.loss_cfg
                )
            total = total + w_av * av.total
            metrics.update(av.stats)
            metrics.update(
                loss_av=av.total,
                av_contrastive_loss=av.contrastive,
                av_reg_loss=av.reg,
                av_smooth_loss=av.smooth,
            )

        if tv_batch is not None:
            with self.mesh_context():
                feats = self.model.apply(
                    {"params": params},
                    tv_batch["images"],
                    tv_batch["token_ids"],
                    tv_batch["text_mask"],
                    train=train,
                    rngs={"dropout": rng_tv},
                    method=_encode_tv,
                )
            if self.mesh is not None:
                from triad.parallel.dp import distributed_tv_loss

                tv = distributed_tv_loss(
                    feats["text"], feats["visual"], tv_batch["text_mask"],
                    temp, self.loss_cfg, self.mesh, axis=self.mesh_axis,
                )
            else:
                tv = tv_loss(
                    feats["text"], feats["visual"], tv_batch["text_mask"],
                    temp, self.loss_cfg,
                )
            total = total + w_tv * tv.total
            metrics.update(tv.stats)
            metrics.update(loss_tv=tv.total, tv_contrastive_loss=tv.contrastive)

        metrics["train_loss"] = total
        return total, metrics

    # -- step factories -------------------------------------------------

    def make_step(self, mode: str):
        """mode: "av" | "tv" | "joint". Returns a jittable
        step(state, av_batch, tv_batch, w_av, w_tv) -> (state, metrics).
        Unused batches may be None (fixed per-trace, like the reference's
        per-phase code paths)."""
        accum = self.optim_cfg.gradient_accumulation_steps

        def step(
            state: TrainState,
            av_batch: Optional[Dict[str, jax.Array]],
            tv_batch: Optional[Dict[str, jax.Array]],
            w_av: jax.Array,
            w_tv: jax.Array,
        ) -> Tuple[TrainState, Dict[str, jax.Array]]:
            step_rng = jax.random.fold_in(state.rng, state.global_step)

            def loss_fn(params):
                return self.compute_losses(
                    params,
                    av_batch if mode in ("av", "joint") else None,
                    tv_batch if mode in ("tv", "joint") else None,
                    step_rng,
                    w_av,
                    w_tv,
                )

            (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params
            )
            # loss / accum before backward (train.py:986); freeze-gating per
            # micro step (torch requires_grad semantics, train.py:934).
            if accum > 1:
                grads = jax.tree.map(lambda g: g / accum, grads)
            grads = gate_grads(
                grads, self.partition, self.optim_cfg, state.global_step
            )

            def do_update(acc):
                clipped, norm_metrics = clip_grads(
                    acc, self.partition, self.optim_cfg
                )
                updates, opt_state, lr_metrics = self.bank.update(
                    clipped, state.opt, state.params, state.global_step
                )
                new_params = jax.tree.map(jnp.add, state.params, updates)
                return new_params, opt_state, {**norm_metrics, **lr_metrics}

            if accum == 1:
                # No accumulator buffer, no boundary cond: every micro
                # step is an update step.
                params, opt_state, upd_metrics = do_update(grads)
                grad_accum = None
            else:
                acc = jax.tree.map(jnp.add, state.grad_accum, grads)
                is_boundary = (state.global_step + 1) % accum == 0

                def apply_update(_):
                    new_params, opt_state, m = do_update(acc)
                    zeros = jax.tree.map(jnp.zeros_like, acc)
                    return new_params, opt_state, zeros, m

                def no_update(_):
                    zero_metrics = {
                        **{
                            f"grad_norm_{n}": jnp.zeros((), jnp.float32)
                            for n in ("others", "audio", "text", "vit_lora", "vit")
                        },
                        **{
                            f"lr_{g}": jnp.zeros((), jnp.float32)
                            for g in ("others", "audio", "text", "vit_lora")
                        },
                    }
                    return state.params, state.opt, acc, zero_metrics

                params, opt_state, grad_accum, upd_metrics = jax.lax.cond(
                    is_boundary, apply_update, no_update, None
                )
            metrics.update(upd_metrics)
            metrics["global_step"] = state.global_step

            new_state = state.replace(
                params=params,
                opt=opt_state,
                grad_accum=grad_accum,
                global_step=state.global_step + 1,
            )
            return new_state, metrics

        return step

    def make_eval_loss(self, mode: str):
        """Validation loss (no dropout, no update) — reference
        validate(), train.py:710-832."""

        def eval_step(params, av_batch, tv_batch, w_av, w_tv):
            rng = jax.random.key(0)
            _, metrics = self.compute_losses(
                params,
                av_batch if mode in ("av", "joint") else None,
                tv_batch if mode in ("tv", "joint") else None,
                rng,
                w_av,
                w_tv,
                train=False,
            )
            return metrics

        return eval_step


# Helper apply-methods: model.apply(..., method=fn) calls fn(model, ...).
def _encode_av(model: TriadModel, images, audio, train: bool):
    return {
        "visual": model.encode_visual(images, train=train),
        "audio": model.encode_audio(audio, train=train),
    }


def _encode_tv(model: TriadModel, images, token_ids, text_mask, train: bool):
    return {
        "visual": model.encode_visual(images, train=train),
        "text": model.encode_text(token_ids, text_mask, train=train),
    }
