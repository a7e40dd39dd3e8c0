"""Four-group optimizer bank with staged unfreezing and delayed OneCycle.

Replicates the reference trainer's optimizer structure exactly
(citations into reference src/train.py):

* Param grouping by name-match (train.py:251-261):
    'audio'      — HuBERT backbone        (audio_embedder.hubert)
    'text'       — DistilBERT backbone    (text_embedder.encoder)
    'vit_lora'   — LoRA adapter factors   (visual_embedder.model + "lora")
    'vit_frozen' — ViT base weights       (never optimized, train.py:296)
    'others'     — projections + temperature (always trained from step 0)

* 4x AdamW at base lr (train.py:272-287; torch defaults: b1 .9, b2 .999,
  eps 1e-8, weight decay 0.01 on every param).

* 4x OneCycle cosine schedules (train.py:302-343): pct_start .1,
  div_factor 10, final_div 1e4; per-group peak scaling others 1.0x /
  audio .25x / text .75x / vit_lora .5x; cycle lengths shortened by each
  group's unfreeze step. The vit_lora group *trains from step 0* but on
  the shortened cycle (train.py:1036-1040) — a reference quirk kept as-is.

* Staged unfreezing (train.py:527-548, 1016-1033): before a group's
  unfreeze step its backbone gets no gradient and its AdamW state is
  untouched (torch: requires_grad False + opt.step() skipped). Here the
  gate zeroes the backbone grads *before* clipping/metrics (matching
  torch's p.grad is None) and skips the group's optax update entirely via
  lax.cond, so Adam moments and bias-correction counts start at the
  unfreeze step, exactly like a torch optimizer whose first .step() runs
  at unfreeze. Unfreeze thresholds are compared against the *micro* step
  (global_step), while schedules advance per optimizer update — the same
  unit mix as the reference (train.py:1016 vs 302-343).

* Per-subtree grad clipping (train.py:1004-1006): global-norm 10.0 over
  audio_embedder.* (backbone + its projection head) and separately over
  text_embedder.*, computed after gate-zeroing (so before unfreeze the
  norm covers only the projections, as in torch).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from triad.core.config import OptimConfig

GROUPS = ("others", "audio", "text", "vit_lora")
FROZEN_GROUP = "vit_frozen"


# ---------------------------------------------------------------------------
# Param labeling (reference train.py:251-261)
# ---------------------------------------------------------------------------


def label_for_path(path: Tuple[str, ...]) -> str:
    """Group label for a param path in the TriadModel tree."""
    keys = tuple(
        p.key if hasattr(p, "key") else str(p) for p in path
    )
    joined = "/".join(keys)
    if joined.startswith("audio_backbone"):
        return "audio"
    if joined.startswith("text_backbone"):
        return "text"
    if joined.startswith("visual_backbone"):
        leaf = keys[-1]
        return "vit_lora" if "lora" in leaf else FROZEN_GROUP
    return "others"


class ParamPartition:
    """Static partition of a param pytree into optimizer groups.

    Built once from the tree structure (labels are static Python), then
    ``split``/``merge`` are pure reindexing — jit-friendly.
    """

    def __init__(self, params: Any):
        flat, self.treedef = jax.tree_util.tree_flatten_with_path(params)
        self.paths = [p for p, _ in flat]
        self.labels = [label_for_path(p) for p in self.paths]
        self.group_indices: Dict[str, List[int]] = {
            g: [i for i, l in enumerate(self.labels) if l == g]
            for g in GROUPS + (FROZEN_GROUP,)
        }

    def leaves(self, tree: Any) -> List[jax.Array]:
        return self.treedef.flatten_up_to(tree)

    def split(self, tree: Any) -> Dict[str, List[jax.Array]]:
        leaves = self.leaves(tree)
        return {
            g: [leaves[i] for i in idx] for g, idx in self.group_indices.items()
        }

    def merge(self, parts: Dict[str, List[jax.Array]]) -> Any:
        leaves: List[Any] = [None] * len(self.paths)
        for g, idx in self.group_indices.items():
            for j, i in enumerate(idx):
                leaves[i] = parts[g][j]
        return jax.tree_util.tree_unflatten(self.treedef, leaves)

    def path_strings(self) -> List[str]:
        return [
            "/".join(p.key if hasattr(p, "key") else str(p) for p in path)
            for path in self.paths
        ]


# ---------------------------------------------------------------------------
# Schedules (reference train.py:298-348)
# ---------------------------------------------------------------------------


def onecycle(cfg: OptimConfig, peak_scale: float, cycle_steps: int):
    """torch.optim.lr_scheduler.OneCycleLR-exact cosine schedule.

    optax.cosine_onecycle_schedule discretizes differently (peak at
    pct*total vs torch's pct*total - 1, final value at total vs
    total - 1), so the torch milestones are replicated here:
      phase 1: cos-anneal initial -> max over [0, pct*total - 1]
      phase 2: cos-anneal max -> min over [pct*total - 1, total - 1]
    with initial = max/div_factor, min = initial/final_div_factor, and
    the value clamping at min beyond the cycle end (the reference stops
    stepping the scheduler there, train.py:345-348 + 1018-1040).
    """
    total = max(1, cycle_steps)
    max_lr = cfg.learning_rate * peak_scale
    initial_lr = max_lr / cfg.div_factor
    min_lr = initial_lr / cfg.final_div_factor
    warm_end = max(cfg.pct_start * total - 1, 1e-8)
    anneal_end = max(total - 1, warm_end + 1e-8)

    def _annealing_cos(start, end, pct):
        return end + (start - end) / 2.0 * (jnp.cos(jnp.pi * pct) + 1.0)

    def schedule(count):
        c = jnp.asarray(count, jnp.float32)
        pct1 = jnp.clip(c / warm_end, 0.0, 1.0)
        lr1 = _annealing_cos(initial_lr, max_lr, pct1)
        pct2 = jnp.clip((c - warm_end) / (anneal_end - warm_end), 0.0, 1.0)
        lr2 = _annealing_cos(max_lr, min_lr, pct2)
        return jnp.where(c <= warm_end, lr1, lr2)

    return schedule


def onecycle_momentum(cfg: OptimConfig, cycle_steps: int):
    """torch OneCycleLR's momentum cycling (cycle_momentum=True default,
    inherited by the reference's 4 schedulers, train.py:302-343): beta1
    anneals max_momentum (0.95) -> base_momentum (0.85) during warmup,
    back to max_momentum during the anneal — the inverse of the lr curve.
    """
    total = max(1, cycle_steps)
    warm_end = max(cfg.pct_start * total - 1, 1e-8)
    anneal_end = max(total - 1, warm_end + 1e-8)
    base_m, max_m = cfg.base_momentum, cfg.max_momentum

    def _annealing_cos(start, end, pct):
        return end + (start - end) / 2.0 * (jnp.cos(jnp.pi * pct) + 1.0)

    def schedule(count):
        c = jnp.asarray(count, jnp.float32)
        pct1 = jnp.clip(c / warm_end, 0.0, 1.0)
        m1 = _annealing_cos(max_m, base_m, pct1)
        pct2 = jnp.clip((c - warm_end) / (anneal_end - warm_end), 0.0, 1.0)
        m2 = _annealing_cos(base_m, max_m, pct2)
        return jnp.where(c <= warm_end, m1, m2)

    return schedule


class CycledAdamState(NamedTuple):
    count: jax.Array
    mu: Any
    nu: Any


def scale_by_cycled_adam(
    b1_schedule,
    b2: float,
    eps: float,
    mu_dtype: str = "float32",
    nu_dtype: str = "float32",
):
    """Adam moment scaling with a schedule-dependent beta1, matching
    torch Adam(W) driven by OneCycleLR momentum cycling: m_t uses the
    *current* beta1, and the bias correction is 1 - beta1_t ** t with the
    current beta (torch recomputes it from the live group beta each step).

    mu_dtype / nu_dtype control moment *storage* (bf16 halves optimizer
    HBM); the EMA update and the final m_hat / (sqrt(v_hat) + eps) always
    compute in fp32.
    """
    mu_dt = jnp.dtype(mu_dtype)
    nu_dt = jnp.dtype(nu_dtype)
    f32 = jnp.float32

    def init(params):
        # mu and nu must be DISTINCT buffers (sharing one zeros tree
        # breaks jit donation: the same buffer would be donated twice).
        mu = jax.tree.map(lambda p: jnp.zeros(p.shape, mu_dt), params)
        nu = jax.tree.map(lambda p: jnp.zeros(p.shape, nu_dt), params)
        return CycledAdamState(jnp.zeros((), jnp.int32), mu, nu)

    def update(updates, state, params=None):
        del params
        b1 = b1_schedule(state.count)
        count = state.count + 1
        mu = jax.tree.map(
            lambda m, g: (
                b1 * m.astype(f32) + (1.0 - b1) * g.astype(f32)
            ).astype(mu_dt),
            state.mu, updates,
        )
        nu = jax.tree.map(
            lambda v, g: (
                b2 * v.astype(f32)
                + (1.0 - b2) * (g.astype(f32) * g.astype(f32))
            ).astype(nu_dt),
            state.nu, updates,
        )
        c = count.astype(f32)
        bc1 = 1.0 - jnp.power(b1, c)
        bc2 = 1.0 - jnp.power(jnp.asarray(b2, f32), c)
        out = jax.tree.map(
            lambda m, v: (m.astype(f32) / bc1)
            / (jnp.sqrt(v.astype(f32) / bc2) + eps),
            mu, nu,
        )
        return out, CycledAdamState(count, mu, nu)

    return optax.GradientTransformation(init, update)


def cycled_adamw(cfg: OptimConfig, lr_schedule, momentum_schedule):
    """AdamW with OneCycle-cycled beta1 (torch-parity optimizer)."""
    return optax.chain(
        scale_by_cycled_adam(
            momentum_schedule, cfg.b2, cfg.eps,
            mu_dtype=cfg.mu_dtype, nu_dtype=cfg.nu_dtype,
        ),
        optax.add_decayed_weights(cfg.weight_decay),
        optax.scale_by_schedule(lambda count: -lr_schedule(count)),
    )


def group_schedules(cfg: OptimConfig, total_updates: int) -> Dict[str, Any]:
    return {
        "others": onecycle(cfg, cfg.lr_scale_others, total_updates),
        "audio": onecycle(
            cfg, cfg.lr_scale_audio, total_updates - cfg.unfreeze_audio_step
        ),
        "text": onecycle(
            cfg, cfg.lr_scale_text, total_updates - cfg.unfreeze_text_step
        ),
        "vit_lora": onecycle(
            cfg, cfg.lr_scale_vit_lora, total_updates - cfg.unfreeze_vit_step
        ),
    }


def group_gates(cfg: OptimConfig, global_step: jax.Array) -> Dict[str, jax.Array]:
    """Whether each group's optimizer steps at this update
    (train.py:1016-1040; vit_lora and others always step)."""
    return {
        "others": jnp.asarray(True),
        "audio": global_step >= cfg.unfreeze_audio_step,
        "text": global_step >= cfg.unfreeze_text_step,
        "vit_lora": jnp.asarray(True),
    }


# ---------------------------------------------------------------------------
# Gradient preparation: freeze-gating + subtree clipping
# ---------------------------------------------------------------------------


def _masked_global_norm(leaves: List[jax.Array]) -> jax.Array:
    if not leaves:
        return jnp.zeros((), jnp.float32)
    return jnp.sqrt(
        sum(jnp.sum(jnp.square(l.astype(jnp.float32))) for l in leaves)
    )


def gate_grads(
    grads: Any,
    partition: ParamPartition,
    cfg: OptimConfig,
    global_step: jax.Array,
) -> Any:
    """Zero grads for not-yet-unfrozen backbones and the frozen ViT base.

    The torch equivalent is requires_grad=False (train.py:527-548): no
    grads ever exist for those params. Applied per *micro* step so grad
    accumulation across an unfreeze boundary matches torch exactly.
    """
    leaves = partition.leaves(grads)
    audio_on = global_step >= cfg.unfreeze_audio_step
    text_on = global_step >= cfg.unfreeze_text_step

    gated: List[jax.Array] = []
    for label, g in zip(partition.labels, leaves):
        if label == FROZEN_GROUP:
            gated.append(jnp.zeros_like(g))
        elif label == "audio":
            gated.append(g * audio_on.astype(g.dtype))
        elif label == "text":
            gated.append(g * text_on.astype(g.dtype))
        else:
            gated.append(g)
    return jax.tree_util.tree_unflatten(partition.treedef, gated)


def clip_grads(
    grads: Any, partition: ParamPartition, cfg: OptimConfig
) -> Tuple[Any, Dict[str, jax.Array]]:
    """Per-group grad-norm metrics + audio/text subtree clipping, applied
    to the (accumulated) grads at the update boundary.

    Metrics mirror the reference's per-group norms (train.py:990-1002,
    computed after torch's None-grads — our gate-zeroing — and before
    clip). Clipping (train.py:1004-1006): global-norm 10.0 over
    audio_embedder.* (HuBERT backbone + audio projection head) and
    separately over text_embedder.*; before unfreeze the gated-off
    backbone grads are zero, so the norm covers only the projections,
    as in torch (None grads are skipped by clip_grad_norm_).
    """
    paths = partition.path_strings()
    leaves = list(partition.leaves(grads))
    f32 = lambda x: x.astype(jnp.float32)

    metrics: Dict[str, jax.Array] = {}
    for grp in GROUPS + (FROZEN_GROUP,):
        idx = partition.group_indices[grp]
        name = "vit" if grp == FROZEN_GROUP else grp
        metrics[f"grad_norm_{name}"] = _masked_global_norm(
            [f32(leaves[i]) for i in idx]
        )

    def clip_subtree(prefixes: Tuple[str, ...]):
        idx = [i for i, p in enumerate(paths) if p.startswith(prefixes)]
        norm = _masked_global_norm([f32(leaves[i]) for i in idx])
        coef = jnp.minimum(1.0, cfg.clip_norm / (norm + 1e-6))
        for i in idx:
            leaves[i] = leaves[i] * coef.astype(leaves[i].dtype)

    clip_subtree(("audio_backbone", "audio_projection"))
    clip_subtree(("text_backbone", "text_projection"))

    return jax.tree_util.tree_unflatten(partition.treedef, leaves), metrics


# ---------------------------------------------------------------------------
# The optimizer bank
# ---------------------------------------------------------------------------


class BankState(NamedTuple):
    adam: Dict[str, Any]  # per-group optax adamw state over leaf lists
    sched_counts: Dict[str, jax.Array]  # per-group applied-update counts


class OptimizerBank:
    """4x AdamW with per-group delayed OneCycle schedules.

    ``update`` consumes *prepared* grads (see prepare_grads) and the
    global micro-step, returns parameter updates (to be added) and the
    new state. Groups whose gate is off contribute zero updates and keep
    their Adam/bias-correction state untouched (torch parity).
    """

    def __init__(self, cfg: OptimConfig, partition: ParamPartition, total_updates: int):
        self.cfg = cfg
        self.partition = partition
        self.schedules = group_schedules(cfg, total_updates)
        cycle_lengths = {
            "others": total_updates,
            "audio": total_updates - cfg.unfreeze_audio_step,
            "text": total_updates - cfg.unfreeze_text_step,
            "vit_lora": total_updates - cfg.unfreeze_vit_step,
        }
        if cfg.cycle_momentum:
            self.txs = {
                g: cycled_adamw(
                    cfg,
                    self.schedules[g],
                    onecycle_momentum(cfg, cycle_lengths[g]),
                )
                for g in GROUPS
            }
        else:
            self.txs = {
                g: optax.adamw(
                    learning_rate=self.schedules[g],
                    b1=cfg.b1,
                    b2=cfg.b2,
                    eps=cfg.eps,
                    weight_decay=cfg.weight_decay,
                    # optax supports low-precision storage for mu only;
                    # nu stays fp32 on this (non-default) path.
                    mu_dtype=jnp.dtype(cfg.mu_dtype),
                )
                for g in GROUPS
            }

    def init(self, params: Any) -> BankState:
        parts = self.partition.split(params)
        adam = {g: self.txs[g].init(parts[g]) for g in GROUPS}
        counts = {g: jnp.zeros((), jnp.int32) for g in GROUPS}
        return BankState(adam, counts)

    def update(
        self,
        grads: Any,
        state: BankState,
        params: Any,
        global_step: jax.Array,
    ) -> Tuple[Any, BankState, Dict[str, jax.Array]]:
        grad_parts = self.partition.split(grads)
        param_parts = self.partition.split(params)
        gates = group_gates(self.cfg, global_step)

        new_adam: Dict[str, Any] = {}
        new_counts: Dict[str, jax.Array] = {}
        update_parts: Dict[str, List[jax.Array]] = {}
        metrics: Dict[str, jax.Array] = {}

        for g in GROUPS:
            tx, gate = self.txs[g], gates[g]

            def do_update(_, g=g, tx=tx):
                return tx.update(grad_parts[g], state.adam[g], param_parts[g])

            def skip(_, g=g):
                zeros = [jnp.zeros_like(x) for x in grad_parts[g]]
                return zeros, state.adam[g]

            upd, adam_state = jax.lax.cond(gate, do_update, skip, None)
            new_adam[g] = adam_state
            new_counts[g] = state.sched_counts[g] + gate.astype(jnp.int32)
            update_parts[g] = upd
            metrics[f"lr_{g}"] = self.schedules[g](state.sched_counts[g])

        # Frozen ViT base: never updated (train.py:296 — no optimizer).
        update_parts[FROZEN_GROUP] = [
            jnp.zeros_like(x) for x in param_parts[FROZEN_GROUP]
        ]

        updates = self.partition.merge(update_parts)
        return updates, BankState(new_adam, new_counts), metrics
