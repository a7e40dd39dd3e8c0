"""The training orchestrator (reference MultiModalTrainer,
train.py:43-1146).

Owns: data loaders (real reference-layout datasets or synthetic),
curriculum phases, the jitted per-phase train steps, validation,
1000-way retrieval, grounding visualization, Orbax checkpoint/autoresume
with mid-epoch exactness, and JSONL/wandb metrics.

Curriculum (train.py:880-905): epoch-indexed
  av_focus -> tv_warmup -> weighted_joint (AV weight start->end) -> full_joint.

Periodic hooks (train.py:1108-1120): viz every ``vis_every`` steps,
checkpoint every ``save_every_steps`` (mid-epoch cursor saved), validate
+ retrieval every ``validation_frequency``; per-epoch validation with
best-model tracking (train.py:1129-1144).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from triad.core.config import Config
from triad.data import (
    AVLoader,
    AudioVisualDataset,
    FlatAudioVisualDataset,
    LocalCaptionDataset,
    SyntheticAVDataset,
    SyntheticTVDataset,
    TVLoader,
    WordPieceTokenizer,
)
from triad.eval import (
    av_retrieval_metrics,
    embed_av_subset,
    embed_tv_subset,
    select_subset_indices,
    tv_retrieval_metrics,
)
from triad.models import TriadModel, init_triad_model
from triad.ops import pairwise_similarity
from triad.train.checkpoint import (
    CheckpointManager,
    HostProgress,
    warn_on_config_mismatch,
)
from triad.train.optim import OptimizerBank, ParamPartition
from triad.train.step import StepFactory, TrainState, init_train_state
from triad.utils import MetricsLogger, StepTimer
from triad.viz import AudioVisualizer, TextVisualizer


def _open_av_root(root: str, image_size: int, segmented: bool):
    """AV dataset from a data root: TriadPack shards (a ``.tpack`` file
    or a directory containing them — the pre-decoded chip-rate path,
    data/packed.py) or the reference's mp4 folder layouts."""
    from pathlib import Path

    from triad.data.packed import PackedAVDataset

    p = Path(root)
    if p.suffix == ".tpack" or (p.is_dir() and any(p.glob("*.tpack"))):
        ds = PackedAVDataset(root, segmented=segmented)
        if ds.image_size != image_size:
            raise ValueError(
                f"packed shard image_size {ds.image_size} != configured "
                f"{image_size}"
            )
        return ds
    if segmented:
        return AudioVisualDataset(root, image_size=image_size)
    return FlatAudioVisualDataset(root, image_size=image_size)


class Trainer:
    def __init__(self, config: Config, force_new_training: bool = False):
        self.config = config
        tc = config.train
        self.output_dir = Path(tc.output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.metrics = MetricsLogger(
            str(self.output_dir),
            use_wandb=tc.use_wandb,
            project_name=tc.project_name,
            config=config.to_dict(),
        )

        # -- data ------------------------------------------------------
        dc = config.data
        grounded_spec = None
        if dc.synthetic_grounded:
            from triad.data.datasets import GroundedSyntheticSpec

            grounded_spec = GroundedSyntheticSpec(
                num_classes=dc.synthetic_grounded_classes,
                image_size=dc.image_size,
                patch_size=config.model.vit.patch_size,
                sample_rate=dc.sample_rate,
            )

        def _synth_av(size: int, seed: int = 0):
            secs = dc.audio_num_samples / dc.sample_rate
            if grounded_spec is not None:
                from triad.data.datasets import GroundedSyntheticAVDataset

                return GroundedSyntheticAVDataset(
                    size=size, audio_seconds=secs, spec=grounded_spec,
                    seed=seed,
                )
            return SyntheticAVDataset(
                size=size, image_size=dc.image_size, audio_seconds=secs,
                seed=seed,
            )

        def _synth_tv(size: int, seed: int = 0):
            if grounded_spec is not None:
                from triad.data.datasets import GroundedSyntheticTVDataset

                return GroundedSyntheticTVDataset(
                    size=size, spec=grounded_spec, seed=seed
                )
            return SyntheticTVDataset(
                size=size, image_size=dc.image_size, seed=seed
            )

        if dc.audio_visual_data_root:
            self.av_dataset = _open_av_root(
                dc.audio_visual_data_root, dc.image_size, segmented=True
            )
        else:
            self.av_dataset = _synth_av(dc.synthetic_av_size)
        if dc.text_dataset_path:
            self.tv_dataset = LocalCaptionDataset(
                dc.text_dataset_path, image_size=dc.image_size
            )
        else:
            self.tv_dataset = _synth_tv(dc.synthetic_tv_size)

        self.val_av_dataset = None
        if dc.audio_visual_val_data_root:
            self.val_av_dataset = _open_av_root(
                dc.audio_visual_val_data_root, dc.image_size, segmented=False
            )
        elif not dc.audio_visual_data_root:
            self.val_av_dataset = _synth_av(
                max(8, dc.synthetic_av_size // 4), seed=1
            )
        self.val_tv_dataset = None
        if dc.text_dataset_val_path:
            self.val_tv_dataset = LocalCaptionDataset(
                dc.text_dataset_val_path, image_size=dc.image_size, augment=False
            )
        elif not dc.text_dataset_path:
            self.val_tv_dataset = _synth_tv(
                max(8, dc.synthetic_tv_size // 4), seed=1
            )

        if dc.tokenizer_vocab:
            self.tokenizer = WordPieceTokenizer.from_vocab_file(dc.tokenizer_vocab)
        else:
            corpus = [
                self.tv_dataset.__getitem__(i, apply_augmentation=False)[1]
                for i in range(min(len(self.tv_dataset), 2000))
            ]
            self.tokenizer = WordPieceTokenizer.build_from_corpus(corpus)
            self.metrics.info(
                f"Built corpus tokenizer with {len(self.tokenizer.vocab)} entries "
                "(pass data.tokenizer_vocab for the pretrained vocab)"
            )

        # Multi-process (multi-host) runs: every process runs the same
        # deterministic samplers and decodes only its row-slice of each
        # global batch (parallel/distributed.py). batch_size_* stay
        # GLOBAL; _put assembles the globally-sharded arrays.
        from triad.parallel.distributed import process_shard

        self._proc_shard = process_shard()
        self.av_loader = AVLoader(
            self.av_dataset, dc.batch_size_av, dc.audio_num_samples,
            seed=tc.seed, num_workers=dc.num_workers,
            worker_mode=dc.worker_mode,
            unique_videos=dc.unique_videos
            and hasattr(self.av_dataset, "video_files"),
            process_shard=self._proc_shard,
            device_augment=dc.device_augment,
        )
        self.tv_loader = TVLoader(
            self.tv_dataset, self.tokenizer, dc.batch_size_tv,
            max_text_tokens=dc.max_text_tokens, seed=tc.seed,
            num_workers=dc.num_workers, worker_mode=dc.worker_mode,
            process_shard=self._proc_shard,
            device_augment=dc.device_augment,
        )

        # -- mesh (DP scale-out; opt-in via mesh.num_devices) ----------
        n_dev = config.mesh.num_devices or 1
        tp = config.mesh.tp
        fsdp = config.mesh.fsdp
        self.mesh_axis = config.mesh.data_axis
        self._tp_specs = None
        if n_dev > 1:
            from triad.parallel import make_mesh
            from triad.parallel.dp import make_multislice_mesh

            # fsdp x num_slices composes: the FSDP shards live over
            # 'data' ONLY (per-use gathers stay inside a slice); params
            # replicate across 'replica', so only the loss-path gathers
            # and the grad reduction cross slices.
            if tp > 1 or fsdp:
                # a pallas_call is opaque to the GSPMD partitioner —
                # sharded params need the XLA attention (parallel/tp.py)
                from triad.parallel.tp import resolve_xla_impls

                config = dataclasses.replace(
                    config, model=resolve_xla_impls(config.model)
                )
                self.config = config
            if config.mesh.num_slices > 1 and n_dev % (
                config.mesh.num_slices * tp
            ):
                raise ValueError(
                    f"mesh.num_devices={n_dev} not divisible by "
                    f"num_slices({config.mesh.num_slices}) x tp({tp})"
                )
            if tp > 1 and config.mesh.num_slices > 1:
                # TP x multi-slice: 3-D (replica, data, model) mesh —
                # batch + loss collectives over the (replica, data)
                # tuple, Megatron params over 'model' (each TP group
                # inside one slice; no per-layer psum crosses slices).
                from triad.parallel.tp import make_multislice_tp_mesh

                ns = config.mesh.num_slices
                self.mesh = make_multislice_tp_mesh(
                    ns, n_dev // ns // tp, tp,
                    replica_axis=config.mesh.replica_axis,
                    data_axis=config.mesh.data_axis,
                    model_axis=config.mesh.model_axis,
                )
                self.mesh_axis = (
                    config.mesh.replica_axis, config.mesh.data_axis
                )
            elif tp > 1:
                from triad.parallel.tp import make_dp_tp_mesh

                self.mesh = make_dp_tp_mesh(
                    n_dev, tp, data_axis=config.mesh.data_axis,
                    model_axis=config.mesh.model_axis,
                )
            elif config.mesh.num_slices > 1:
                self.mesh = make_multislice_mesh(
                    config.mesh.num_slices,
                    n_dev // config.mesh.num_slices,
                    axes=(config.mesh.replica_axis, config.mesh.data_axis),
                )
                self.mesh_axis = (
                    config.mesh.replica_axis, config.mesh.data_axis
                )
            else:
                self.mesh = make_mesh(n_dev, axis=config.mesh.data_axis)
            dp_size = n_dev // tp
            for name, bs in (
                ("batch_size_av", dc.batch_size_av),
                ("batch_size_tv", dc.batch_size_tv),
            ):
                if bs % dp_size:
                    raise ValueError(
                        f"{name}={bs} not divisible by the data-parallel "
                        f"size {dp_size}"
                    )
            extras = ["all-gathered negatives"]
            if tp > 1:
                extras.append(f"tensor-parallel x{tp}")
            if fsdp:
                extras.append("FSDP params")
            if config.mesh.num_slices > 1:
                extras.append(f"{config.mesh.num_slices} slices")
            self.metrics.info(
                f"Data-parallel over {dp_size} replicas "
                f"({', '.join(extras)})"
            )
        else:
            if self._proc_shard is not None:
                raise ValueError(
                    "multi-process run (jax.process_count() > 1) needs a "
                    "device mesh: set mesh.num_devices to the GLOBAL chip "
                    "count (every process would otherwise train its own "
                    "redundant copy)"
                )
            self.mesh = None

        # -- model / optimizer ----------------------------------------
        self.model = TriadModel(config.model)
        if config.pretrained.any():
            # Pretrained backbones from on-disk snapshots (the
            # reference's startup fetches, model.py:29-30, 79-80, 218)
            # or a full trained reference checkpoint.
            from triad.models.hf_import import (
                init_params_from_pretrained,
            )

            pre = config.pretrained
            params = init_params_from_pretrained(
                config.model, jax.random.key(tc.seed),
                hubert_path=pre.hubert, text_path=pre.text,
                vit_path=pre.vit,
                reference_checkpoint=pre.reference_checkpoint,
            )
            params = jax.tree.map(jnp.asarray, params)
            self.metrics.info(
                "Loaded pretrained weights: "
                + ", ".join(
                    f"{k}={v}" for k, v in (
                        ("hubert", pre.hubert), ("text", pre.text),
                        ("vit", pre.vit),
                        ("reference", pre.reference_checkpoint),
                    ) if v
                )
            )
        else:
            params = init_triad_model(config.model, jax.random.key(tc.seed))
        self.partition = ParamPartition(params)

        self.steps_per_epoch = tc.steps_per_epoch or max(
            len(self.av_loader), len(self.tv_loader)
        )
        self.total_updates = (
            self.steps_per_epoch * tc.num_epochs
        ) // tc.optim.gradient_accumulation_steps
        self.bank = OptimizerBank(tc.optim, self.partition, self.total_updates)
        self.factory = StepFactory(
            config.model, config.loss, tc.optim, self.bank, mesh=self.mesh,
            mesh_axis=self.mesh_axis,
        )
        self.state: TrainState = init_train_state(
            params, self.bank, jax.random.key(tc.seed + 1)
        )
        if self.mesh is not None:
            if tp > 1 or fsdp:
                # Sharded parameters: Megatron column/row specs (tp),
                # largest-dim 'data' sharding (fsdp), or both. With
                # zero1, moments shard over 'data' on top of their
                # param's spec (parallel/zero.py); without it they
                # replicate.
                from triad.parallel.distributed import put_global_tree
                from triad.parallel.tp import (
                    tp_param_specs,
                    tp_state_shardings,
                )

                self._tp_specs = (
                    tp_param_specs(
                        params, tp, model_axis=config.mesh.model_axis
                    )
                    if tp > 1
                    else jax.tree.map(lambda _: P(), params)
                )
                if fsdp:
                    from triad.parallel.fsdp import fsdp_param_specs

                    self._tp_specs = fsdp_param_specs(
                        params, self.mesh,
                        data_axis=config.mesh.data_axis,
                        base_specs=self._tp_specs,
                    )
                if config.mesh.zero1:
                    from triad.parallel.zero import apply_zero1

                    self.state = apply_zero1(
                        self.state, self.mesh, self.mesh_axis,
                        param_specs=self._tp_specs,
                        partition=self.partition,
                    )
                else:
                    self.state = put_global_tree(
                        self.state,
                        tp_state_shardings(
                            self.state, self.mesh, self._tp_specs
                        ),
                    )
            elif config.mesh.zero1:
                from triad.parallel.zero import apply_zero1

                self.state = apply_zero1(
                    self.state, self.mesh, self.mesh_axis
                )
            else:
                from triad.parallel.distributed import put_global_tree

                self.state = put_global_tree(
                    self.state, NamedSharding(self.mesh, P())
                )
        # donate_argnums=0: the previous TrainState's buffers (params +
        # Adam moments + accumulator, ~4 GB at full size) are reused for
        # the new state instead of coexisting with it.
        jit_kw = {}
        if self.mesh is not None:
            # Pin the new state to the old one's placement. Left free,
            # GSPMD lets the ZeRO-1 update leave most params sharded over
            # 'data', and the next forward then partitions layers by
            # weight and all-gathers the batch's activations around them.
            jit_kw["out_shardings"] = (
                jax.tree.map(lambda x: x.sharding, self.state),
                NamedSharding(self.mesh, P()),
            )
        self._steps = {
            mode: jax.jit(
                self.factory.make_step(mode), donate_argnums=0, **jit_kw
            )
            for mode in ("av", "tv", "joint")
        }
        # Multi-process only: per-mode AOT-compiled executables, built
        # at first use so compile-time skew is absorbed by a
        # coordination barrier BEFORE the first gloo collective (see
        # _step_fn_ready / parallel.distributed.coordination_barrier).
        self._compiled_steps = {}
        self._eval_steps = {
            mode: jax.jit(self.factory.make_eval_loss(mode))
            for mode in ("av", "tv", "joint")
        }

        # Retrieval-eval encoders, jitted ONCE here with params as an
        # argument: building fresh @jax.jit closures inside
        # eval_1000_way_retrieval recompiled the encoders on every
        # periodic eval.
        def _enc_av(params, images, audio):
            with self.factory.mesh_context():
                a = self.model.apply(
                    {"params": params}, audio, train=False,
                    method=TriadModel.encode_audio,
                )
                v = self.model.apply(
                    {"params": params}, images, train=False,
                    method=TriadModel.encode_visual,
                )
            return a, v

        def _enc_tv(params, images, ids, mask):
            with self.factory.mesh_context():
                t = self.model.apply(
                    {"params": params}, ids, mask, train=False,
                    method=TriadModel.encode_text,
                )
                v = self.model.apply(
                    {"params": params}, images, train=False,
                    method=TriadModel.encode_visual,
                )
            return t, v

        self._enc_av = jax.jit(_enc_av)
        self._enc_tv = jax.jit(_enc_tv)

        # -- progress / resume ----------------------------------------
        self.progress = HostProgress()
        self.ckpt = CheckpointManager(
            str(self.output_dir / "checkpoints"),
            async_save=tc.async_checkpointing,
        )
        if not force_new_training and self.ckpt.latest_step() is not None:
            self._resume()

        self.audio_viz = AudioVisualizer(
            patch_size=config.model.vit.patch_size,
            image_size=config.model.vit.image_size,
        )
        self.text_viz = TextVisualizer(
            patch_size=config.model.vit.patch_size,
            image_size=config.model.vit.image_size,
        )
        self._vis_samples_av = self._cache_vis_samples_av(tc.num_vis_samples_av)
        self._vis_samples_tv = self._cache_vis_samples_tv(tc.num_vis_samples_tv)
        self.timer = StepTimer()
        self.metrics.info(
            f"Trainer ready: {self.steps_per_epoch} steps/epoch, "
            f"{self.total_updates} total updates"
        )

    def _step_fn_ready(self, mode: str, step_fn, args):
        """The step callable to actually invoke — always ``step_fn``
        (the plain jit); multi-process, the first use per mode first
        COMPILES the step without executing it and then rendezvouses at
        the coordination-service barrier, so the first gloo collective
        is entered moments apart no matter how skewed the per-process
        compiles were (gloo's rendezvous KV lookups time out at ~30 s;
        a cold compile cache on a loaded machine skews entry by
        minutes).

        The ``lower().compile()`` result is deliberately DISCARDED, not
        called: AOT executables are sharding-strict, and GSPMD may pick
        different shardings for a few output leaves than the inputs had
        (measured: 5/107 state leaves), which a plain-jit call absorbs
        by recompiling but an AOT call rejects. The warm-up's value is
        populating the persistent compilation cache (set
        JAX_COMPILATION_CACHE_DIR on multi-host launches; the smoke
        harness does), so the real call after the barrier deserializes
        in seconds instead of recompiling for minutes.
        """
        if jax.process_count() == 1:
            return step_fn
        if mode not in self._compiled_steps:
            step_fn.lower(*args).compile()
            from triad.parallel.distributed import coordination_barrier

            coordination_barrier(f"triad_step_compiled_{mode}")
            self._compiled_steps[mode] = True
        return step_fn

    # ------------------------------------------------------------------
    # Phases (train.py:880-905)
    # ------------------------------------------------------------------

    def phase_for_epoch(self, epoch: int) -> Tuple[str, float, float]:
        tc = self.config.train
        if epoch < tc.av_focus_epochs:
            return "av_focus", 1.0, 0.0
        if epoch < tc.av_focus_epochs + tc.tv_warmup_epochs:
            return "tv_warmup", 0.0, 1.0
        joint_start = tc.av_focus_epochs + tc.tv_warmup_epochs
        if epoch < joint_start + tc.weighted_joint_epochs:
            progress = (epoch - joint_start) / tc.weighted_joint_epochs
            w_av = tc.av_weight_start - progress * (
                tc.av_weight_start - tc.av_weight_end
            )
            return "weighted_joint", w_av, 1.0 - w_av
        return "full_joint", 1.0, 1.0

    @staticmethod
    def _mode(phase: str) -> str:
        return {"av_focus": "av", "tv_warmup": "tv"}.get(phase, "joint")

    # ------------------------------------------------------------------
    # Train loop (train.py:876-1146)
    # ------------------------------------------------------------------

    def train(self) -> None:
        tc = self.config.train
        for epoch in range(self.progress.epoch, tc.num_epochs):
            phase, w_av, w_tv = self.phase_for_epoch(epoch)
            self.metrics.info(f"Epoch {epoch} phase={phase} w_av={w_av:.2f}")

            if self.progress.current_batch_idx == 0:
                self.av_dataset.switch_segment()
                self.progress.dataset_segment = getattr(
                    self.av_dataset, "current_segment", 0
                )

            start_batch = self.progress.current_batch_idx
            # Background prefetch: the host assembles + device_puts the
            # next batches while the device runs the current step
            # (replaces the reference's DataLoader worker prefetch,
            # train.py:157-181).
            from triad.data import Prefetcher

            av_iter = tv_iter = None
            if phase != "tv_warmup":
                av_iter = Prefetcher(
                    self._cycling_iter(self.av_loader, epoch, start_batch),
                    prefetch=self.config.data.prefetch,
                    device_put=self._device_av,
                )
            if phase != "av_focus":
                tv_iter = Prefetcher(
                    self._cycling_iter(self.tv_loader, epoch, start_batch),
                    prefetch=self.config.data.prefetch,
                    device_put=self._device_tv,
                )
            step_fn = self._steps[self._mode(phase)]
            epoch_losses = []

            # Optional jax.profiler trace of the first profile_steps steps
            # of the first trained epoch (SURVEY §5 tracing hook).
            profile_left = (
                self.config.train.profile_steps
                if epoch == self.progress.epoch
                else 0
            )
            if profile_left > 0:
                from triad.utils import profile_trace

                self._prof = profile_trace(str(self.output_dir / "profile"))
                self._prof.__enter__()

            for batch_idx in range(start_batch, self.steps_per_epoch):
                av_batch = next(av_iter) if av_iter is not None else None
                tv_batch = next(tv_iter) if tv_iter is not None else None
                run_step = self._step_fn_ready(
                    self._mode(phase), step_fn,
                    (self.state, av_batch, tv_batch,
                     jnp.float32(w_av), jnp.float32(w_tv)),
                )
                self.state, metrics = run_step(
                    self.state, av_batch, tv_batch,
                    jnp.float32(w_av), jnp.float32(w_tv),
                )
                self.timer.tick()
                if profile_left > 0:
                    profile_left -= 1
                    if profile_left == 0:
                        jax.block_until_ready(self.state.params)
                        self._prof.__exit__(None, None, None)
                gs = int(self.progress.global_step)
                if batch_idx % 10 == 0 or batch_idx == self.steps_per_epoch - 1:
                    host = self._fetch_metrics(metrics)
                    host.update(
                        epoch=epoch, training_phase=phase,
                        av_weight=w_av, tv_weight=w_tv,
                    )
                    host.update(
                        self.timer.metrics(
                            self.config.data.batch_size_av
                            + self.config.data.batch_size_tv
                        )
                    )
                    self.metrics.log(host, step=gs)
                # Keep the loss as a device scalar: a per-step float()
                # here blocks on step completion every step — the
                # reference's .item() sync reintroduced outside the
                # step. One stacked fetch happens at epoch end instead.
                epoch_losses.append(metrics["train_loss"])

                self.progress.global_step += 1
                if gs > 0 and gs % tc.vis_every == 0:
                    self.visualize_samples(epoch)
                if gs > 0 and gs % tc.save_every_steps == 0:
                    self.progress.epoch = epoch
                    self.progress.current_batch_idx = batch_idx + 1
                    self.save_checkpoint()
                if gs > 0 and gs % tc.validation_frequency == 0:
                    self.validate(phase)
                    self.eval_1000_way_retrieval()

            for it in (av_iter, tv_iter):
                if it is not None:
                    it.close()
            mean_loss = (
                float(jnp.mean(jnp.stack(epoch_losses)))
                if epoch_losses
                else float("nan")
            )
            self.metrics.info(f"Epoch {epoch} done, mean loss {mean_loss:.4f}")

            val = self.validate(phase)
            self.eval_1000_way_retrieval()
            is_best = False
            if val is not None and val < self.progress.best_loss:
                self.progress.best_loss = val
                is_best = True
                self.metrics.info(f"New best val loss {val:.4f}")
            self.progress.epoch = epoch + 1
            self.progress.current_batch_idx = 0
            self.save_checkpoint(is_best=is_best)
        # Drain the async checkpoint writer before returning: letting
        # its thread pool race interpreter shutdown raises a cosmetic
        # "cannot schedule new futures after interpreter shutdown" from
        # the final save's commit callbacks.
        self.ckpt.wait_until_finished()
        self.metrics.info("Training complete!")

    @staticmethod
    def _fetch_metrics(metrics: Dict[str, jax.Array]) -> Dict[str, float]:
        """Fetch a dict of device scalars with ONE transfer. A float()
        per entry costs a blocking device round-trip each (~15
        metrics); stacking first makes the log cadence pay a single
        readback."""
        keys = [k for k, v in metrics.items() if jnp.ndim(v) == 0]
        vals = np.asarray(jnp.stack([metrics[k] for k in keys]))
        host: Dict[str, float] = dict(zip(keys, map(float, vals)))
        for k, v in metrics.items():
            if k not in host:
                host[k] = v
        return host

    # ------------------------------------------------------------------
    # Data plumbing
    # ------------------------------------------------------------------

    def _cycling_iter(self, loader, epoch: int, start_batch: int) -> Iterator:
        # ``start_batch`` counts TRAINER batches; with steps_per_epoch >
        # len(loader) the uninterrupted run cycles into later loader
        # epochs mid-trainer-epoch, so a resume cursor can lie at or
        # past len(loader) — normalize it into (loader epoch, batch) or
        # the first loader.epoch() comes back empty and a resumed run
        # would diverge from (or crash out of) the uninterrupted one.
        n = len(loader)
        if n > 0:
            epoch += start_batch // n
            start_batch %= n

        def gen():
            e, b = epoch, start_batch
            while True:
                yielded = False
                for item in loader.epoch(e, b):
                    yielded = True
                    yield item
                if not yielded and b == 0:
                    raise RuntimeError("empty loader")
                e, b = e + 1, 0

        return gen()

    def _put(self, arr) -> jax.Array:
        if self.mesh is not None:
            if self._proc_shard is not None:
                # Multi-process: ``arr`` is this host's row-slice; the
                # returned array has the full global shape with only
                # our shards addressable (parallel/distributed.py).
                from triad.parallel.distributed import (
                    global_batch_from_local,
                )

                return global_batch_from_local(
                    self.mesh, P(self.mesh_axis), arr
                )
            return jax.device_put(
                jnp.asarray(arr),
                NamedSharding(self.mesh, P(self.mesh_axis)),
            )
        return jnp.asarray(arr)

    def _device_av(self, batch) -> Dict[str, jax.Array]:
        if "frames_u8" in batch:
            # Wire-dtype raw batch (data.device_augment): transfer uint8
            # frames + int16 audio + O(B) param vectors through the
            # mesh-aware _put, then run the augment math on-device (one
            # tiny jitted program; GSPMD keeps it batch-sharded).
            from triad.data.device_aug import (
                audio_i16_to_f32,
                device_augment_av,
            )

            images = device_augment_av(
                self._put(batch["frames_u8"]),
                self._put(batch["aug_flip"]),
                self._put(batch["aug_brightness"]),
                self._put(batch["aug_contrast"]),
                self._put(batch["aug_saturation"]),
            )
            return {
                "images": images,
                "audio": audio_i16_to_f32(self._put(batch["audio_i16"])),
            }
        return {
            "images": self._put(batch["images"]),
            "audio": self._put(batch["audio"]),
        }

    def _device_tv(self, batch) -> Dict[str, jax.Array]:
        if "frames_u8" in batch:
            # Wire-dtype raw TV batch (data.device_augment): uint8
            # pixels + O(B) draw params through the mesh-aware _put,
            # augment math on-device (data/device_aug.py).
            from triad.data.device_aug import device_augment_tv

            images = device_augment_tv(
                self._put(batch["frames_u8"]),
                self._put(batch["aug_flip"]),
                self._put(batch["aug_dx"]),
                self._put(batch["aug_dy"]),
                self._put(batch["aug_perm"]),
                self._put(batch["aug_factors"]),
            )
            return {
                "images": images,
                "token_ids": self._put(batch["token_ids"]),
                "text_mask": self._put(batch["text_mask"]),
            }
        return {
            "images": self._put(batch["images"]),
            "token_ids": self._put(batch["token_ids"]),
            "text_mask": self._put(batch["text_mask"]),
        }

    # ------------------------------------------------------------------
    # Checkpointing (train.py:382-525)
    # ------------------------------------------------------------------

    def save_checkpoint(self, is_best: bool = False) -> None:
        self.ckpt.save(
            step=self.progress.global_step,
            train_state=self.state,
            progress=self.progress,
            config_dict=self.config.to_dict(),
            is_best=is_best,
        )
        self.metrics.info(
            f"Saved checkpoint at step {self.progress.global_step}"
            + (" (best)" if is_best else "")
        )

    def _resume(self) -> None:
        state, progress, saved_cfg, _ = self.ckpt.restore(self.state)
        self.state = state
        self.progress = progress
        warn_on_config_mismatch(
            saved_cfg.get("train", {}), self.config.to_dict().get("train", {}),
            logger=self.metrics.info,
        )
        if hasattr(self.av_dataset, "set_segment"):
            self.av_dataset.set_segment(progress.dataset_segment)
        self.metrics.info(
            f"Resumed from step {progress.global_step} "
            f"(epoch {progress.epoch}, batch {progress.current_batch_idx})"
        )

    # ------------------------------------------------------------------
    # Validation (train.py:710-832)
    # ------------------------------------------------------------------

    def validate(
        self, phase: str, max_batches: Optional[int] = None
    ) -> Optional[float]:
        """Phase-aware validation. The reference iterates each val
        loader fully and INDEPENDENTLY (train.py:710-832: all AV val
        batches, then all TV val batches, then the phase-weighted sum
        of the two means) — pairing them in lockstep would silently
        drop the longer set's tail. ``max_batches`` caps each loader
        separately."""
        _, w_av, w_tv = self.phase_for_epoch(max(self.progress.epoch, 0))
        mode = self._mode(phase)
        limit = max_batches if max_batches is not None else 10**9
        w_av_d, w_tv_d = jnp.float32(w_av), jnp.float32(w_tv)

        def _run_leg(leg_mode: str, batches, device_fn) -> Dict[str, list]:
            eval_fn = self._eval_steps[leg_mode]
            totals: Dict[str, list] = {}
            for count, batch in enumerate(batches):
                if count >= limit:
                    break
                b = device_fn(batch)
                m = eval_fn(
                    self.state.params,
                    b if leg_mode == "av" else None,
                    b if leg_mode == "tv" else None,
                    w_av_d, w_tv_d,
                )
                m = self._fetch_metrics(m)
                for k, v in m.items():
                    totals.setdefault(k, []).append(v)
            return totals

        av_totals: Dict[str, list] = {}
        tv_totals: Dict[str, list] = {}
        if self.val_av_dataset is not None and mode in ("av", "joint"):
            av_loader = AVLoader(
                self.val_av_dataset, self.config.data.batch_size_av,
                self.config.data.audio_num_samples, shuffle=False,
                augment=False, num_workers=self.config.data.num_workers,
                process_shard=self._proc_shard,
            )
            av_totals = _run_leg("av", iter(av_loader), self._device_av)
        if self.val_tv_dataset is not None and mode in ("tv", "joint"):
            tv_loader = TVLoader(
                self.val_tv_dataset, self.tokenizer,
                self.config.data.batch_size_tv,
                max_text_tokens=self.config.data.max_text_tokens,
                shuffle=False, augment=False,
                num_workers=self.config.data.num_workers,
                process_shard=self._proc_shard,
            )
            tv_totals = _run_leg("tv", iter(tv_loader), self._device_tv)
        if not av_totals and not tv_totals:
            return None

        avg: Dict[str, float] = {}
        for totals in (av_totals, tv_totals):
            for k, v in totals.items():
                if k in ("train_loss", "temperature"):
                    continue
                avg[f"val_{k}"] = float(np.mean(v))
        # Phase-weighted total over the per-leg means (each leg's
        # train_loss already carries its phase weight: the eval step
        # computes w_av*av.total / w_tv*tv.total for a single-pair
        # batch).
        leg_means = [
            float(np.mean(t["train_loss"]))
            for t in (av_totals, tv_totals)
            if "train_loss" in t
        ]
        avg["val_train_loss"] = float(np.sum(leg_means))
        temps = (
            av_totals.get("temperature") or tv_totals.get("temperature")
        )
        if temps:
            avg["val_temperature"] = float(np.mean(temps))
        self.metrics.log(avg, step=self.progress.global_step)
        return avg.get("val_train_loss")

    # ------------------------------------------------------------------
    # Retrieval eval (train.py:835-874 -> eval/retrieval.py)
    # ------------------------------------------------------------------

    def _shard_eval_input(self, arr) -> jax.Array:
        """Batch-shard a retrieval/eval input over the mesh when it
        divides evenly — the N-way embedding then runs data-parallel
        instead of every chip redundantly computing the same (replicated)
        batch. Multi-process runs keep the replicated path (every host
        embeds the full subset; sharding there would need per-host
        row-slices of the eval set)."""
        arr = jnp.asarray(arr)
        if self.mesh is None or self._proc_shard is not None:
            return arr
        n = int(np.prod(
            [self.mesh.shape[a] for a in (
                self.mesh_axis if isinstance(self.mesh_axis, tuple)
                else (self.mesh_axis,)
            )]
        ))
        if arr.shape[0] % n:
            return arr
        return jax.device_put(
            arr, NamedSharding(self.mesh, P(self.mesh_axis))
        )

    def eval_1000_way_retrieval(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        temp = float(self.state.params["temperature"])
        subset_size = min(
            self.config.train.retrieval_subset_size,
            len(self.val_av_dataset or []) or 10**9,
            len(self.val_tv_dataset or []) or 10**9,
        )
        if self.val_av_dataset is not None:
            indices = select_subset_indices(
                len(self.val_av_dataset),
                str(self.output_dir / "retrieval_subset_av.json"),
                subset_size,
            )

            def enc_av(images, audio):
                return self._enc_av(
                    self.state.params,
                    self._shard_eval_input(images),
                    self._shard_eval_input(audio),
                )

            a, am, v = embed_av_subset(
                enc_av, self.val_av_dataset, indices,
                self.config.data.audio_num_samples,
                num_tokens_fn=self.config.model.hubert.num_audio_tokens,
            )
            out.update(av_retrieval_metrics(a, am, v, temp))
        if self.val_tv_dataset is not None:
            indices = select_subset_indices(
                len(self.val_tv_dataset),
                str(self.output_dir / "retrieval_subset_tv.json"),
                subset_size,
            )

            def enc_tv(images, ids, mask):
                return self._enc_tv(
                    self.state.params,
                    self._shard_eval_input(images),
                    self._shard_eval_input(ids),
                    self._shard_eval_input(mask),
                )

            t, tm, v = embed_tv_subset(
                enc_tv, self.val_tv_dataset, indices, self.tokenizer,
                self.config.data.max_text_tokens,
            )
            out.update(tv_retrieval_metrics(t, tm, v, temp))
        if out:
            self.metrics.log(
                {f"retrieval_{k}": v for k, v in out.items()},
                step=self.progress.global_step,
            )
        return out

    # ------------------------------------------------------------------
    # Visualization hook (train.py:550-708)
    # ------------------------------------------------------------------

    def _cache_vis_samples_av(self, n: int):
        ds = self.val_av_dataset or self.av_dataset
        n = min(n, len(ds))
        items = [ds.__getitem__(i, apply_augmentation=False) for i in range(n)]
        return items

    def _cache_vis_samples_tv(self, n: int):
        ds = self.val_tv_dataset or self.tv_dataset
        n = min(n, len(ds))
        return [ds.__getitem__(i, apply_augmentation=False) for i in range(n)]

    def visualize_samples(self, epoch: int, max_samples: int = 4) -> None:
        from triad.data.audio import pad_or_trim

        phase, _, _ = self.phase_for_epoch(epoch)
        viz_dir = self.output_dir / "viz" / f"epoch_{epoch}"
        viz_dir.mkdir(parents=True, exist_ok=True)
        params = self.state.params

        def sim_av(frame, audio):
            a = self.model.apply(
                {"params": params}, jnp.asarray(audio), train=False,
                method=TriadModel.encode_audio,
            )
            v = self.model.apply(
                {"params": params}, jnp.asarray(frame), train=False,
                method=TriadModel.encode_visual,
            )
            return np.asarray(
                pairwise_similarity(a, v, params["temperature"])[0]
            )

        if phase != "tv_warmup":
            for i, item in enumerate(self._vis_samples_av[:max_samples]):
                audio = pad_or_trim(
                    item["audio"], self.config.data.audio_num_samples
                )
                self.audio_viz.plot_audio_token_attentions(
                    sim_av, item["video_frames"], audio,
                    str(viz_dir / f"av_{i}.png"), num_tokens_to_show=8,
                )
                self.metrics.log_image(
                    f"viz_av_{i}", str(viz_dir / f"av_{i}.png"),
                    step=self.progress.global_step,
                )
                if i == 0:
                    # attention mp4 with the original audio muxed when the
                    # source file + ffmpeg exist (train.py:658-680).
                    src = item.get("video_path")
                    self.audio_viz.make_attention_video(
                        sim_av, item["video_frames"], audio,
                        str(viz_dir / "av_0_attention.mp4"),
                        video_path=src if src and not str(src).startswith("synthetic") else None,
                    )
                    self.metrics.log_video(
                        "viz_av_0_attention",
                        str(viz_dir / "av_0_attention.mp4"),
                        step=self.progress.global_step,
                    )

        def sim_tv(frame, text):
            ids, mask = self.tokenizer.encode_batch(
                [text], max_length=self.config.data.max_text_tokens,
                pad_to=self.config.data.max_text_tokens,
            )
            t = self.model.apply(
                {"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                train=False, method=TriadModel.encode_text,
            )
            v = self.model.apply(
                {"params": params}, jnp.asarray(frame), train=False,
                method=TriadModel.encode_visual,
            )
            sims = np.asarray(
                pairwise_similarity(t, v, params["temperature"])[0]
            )
            n_valid = int(mask.sum())
            tokens = self.tokenizer.tokenize(text)[:n_valid]
            return sims[:n_valid], tokens

        if phase != "av_focus":
            for i, (img, caption) in enumerate(self._vis_samples_tv[:max_samples]):
                if not caption:
                    continue
                self.text_viz.plot_token_attentions(
                    sim_tv, img, caption, str(viz_dir / f"tv_{i}.png")
                )
                self.metrics.log_image(
                    f"viz_tv_{i}", str(viz_dir / f"tv_{i}.png"),
                    step=self.progress.global_step,
                )
        self.metrics.info(f"Wrote visualizations to {viz_dir}")
