"""End-to-end parity harness: triad vs the torch reference pipeline.

Builds the full reference pipeline in torch (HF modules from config +
the reference's exact loss/train code path per model.py:474-608) and
the triad pipeline, shares ported weights, runs BASELINE configs 1-4
end-to-end, and compares losses per step and R@1/5/10.

The torch side is tests/torch_reference.py (reference MultiModalModel
clone: HF HuBERT/DistilBERT from config, hub-layout DINOv2 + real peft
LoRA, oracle losses citing model.py line-by-line). Weights flow through
the PRODUCTION import path (models/reference_import.port_reference_
state_dict on the torch state_dict — the same code that loads a real
reference checkpoint). Identical synthetic media feeds both sides.

Legs (BASELINE.json configs):
  1 tv      image-text fwd+loss (model.py:595-608)
  2 av      audio-visual fwd+loss (model.py:474-488)
  3 tri     joint forward + all three pairwise sim matrices incl.
            text<->audio (model.py:610-637)
  4 retr    N-way retrieval, all four directions: torch = the
            reference's per-pair aggregation loop (retrieval.py:159-175)
            vs triad's vectorized eval; ranks must agree. Plus the
            viz heatmap tensor (squaring quirk, viz.py:58-71).
  5 train   K joint train steps with the reference's 4-group AdamW +
            OneCycle + subtree clipping (train.py:246-348, 988-1040) on
            both sides; per-step losses compared.

Usage:
  python scripts/parity_e2e.py --size small            # seconds, CI
  python scripts/parity_e2e.py --size full --retr-n 32 # the PARITY.md run
Prints one JSON line per leg and a final summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def parity_model_cfg(size: str):
    """ModelConfig for the parity run: fp32 compute, parity-default
    impls, ALL dropouts zero (the train-steps leg must be deterministic
    on both frameworks; eval legs are dropout-free anyway)."""
    import dataclasses

    from triad.core.config import (
        DistilBertConfig,
        HubertConfig,
        ModelConfig,
        ViTConfig,
    )

    if size == "small":
        cfg = ModelConfig(
            embedding_dim=32,
            compute_dtype="float32",
            visual_dropout_prob=0.0,
            vit=ViTConfig(
                image_size=28, patch_size=14, hidden_size=32, num_layers=2,
                num_heads=4,
            ),
            hubert=HubertConfig(
                hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, conv_dim=(16, 16), conv_kernel=(10, 3),
                conv_stride=(5, 2), num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4,
                hidden_dropout=0.0, activation_dropout=0.0,
                attention_dropout=0.0, feat_proj_dropout=0.0,
                layerdrop=0.0, apply_spec_augment=False,
            ),
            text=DistilBertConfig(
                vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, max_position_embeddings=64,
                dropout=0.0, attention_dropout=0.0,
            ),
        )
    else:
        base = ModelConfig()
        cfg = dataclasses.replace(
            base,
            compute_dtype="float32",
            visual_dropout_prob=0.0,
            hubert=dataclasses.replace(
                base.hubert, hidden_dropout=0.0, activation_dropout=0.0,
                attention_dropout=0.0, feat_proj_dropout=0.0,
                layerdrop=0.0, apply_spec_augment=False,
            ),
            text=dataclasses.replace(
                base.text, dropout=0.0, attention_dropout=0.0
            ),
        )
    return cfg


def make_media(cfg, B: int, audio_samples: int, text_len: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, cfg.vit.image_size, cfg.vit.image_size, 3))
    img = img.astype(np.float32)
    audio = (rng.normal(size=(B, audio_samples)) * 0.1).astype(np.float32)
    ids = rng.integers(1, cfg.text.vocab_size, size=(B, text_len))
    mask = np.ones((B, text_len), np.float32)
    return img, audio, ids.astype(np.int64), mask


class Harness:
    def __init__(self, size: str, seed: int = 0, via_file: bool = False,
                 ref_ckpt: str | None = None):
        import jax

        jax.config.update("jax_default_matmul_precision", "highest")
        import torch

        from tests.torch_reference import build_reference_model, port_to_triad
        from triad.core.config import LossConfig
        from triad.models import TriadModel

        self.size = size
        self.cfg = parity_model_cfg(size)
        self.loss_cfg = LossConfig(
            implementation="chunked", chunk_size=4 if size == "small" else 8
        )
        t0 = time.time()
        self.torch_model = build_reference_model(self.cfg, seed=seed)
        if ref_ckpt:
            # A REAL reference checkpoint file: load it into BOTH sides —
            # the torch clone (so the comparison is against the actual
            # trained weights) and triad via the production import.
            from triad.models.reference_import import (
                load_reference_checkpoint,
                strip_compile_prefix,
            )

            payload = torch.load(
                ref_ckpt, map_location="cpu", weights_only=False
            )
            sd = strip_compile_prefix(
                payload.get("model_state_dict", payload)
            )
            self.torch_model.load_state_dict(sd)
            self.params = load_reference_checkpoint(ref_ckpt, self.cfg)
            print(f"# loaded reference checkpoint {ref_ckpt}",
                  file=sys.stderr)
        elif via_file:
            self.params = self._port_via_file(seed)
        else:
            self.params = port_to_triad(self.torch_model, self.cfg)
        self.model = TriadModel(self.cfg)
        print(f"# built + ported weights in {time.time() - t0:.1f}s",
              file=sys.stderr)
        if size == "small":
            self.B, self.audio_samples, self.text_len = 4, 800, 8
        else:
            self.B, self.audio_samples, self.text_len = 8, 160_000, 32

    def _port_via_file(self, seed: int):
        """Round-trip the torch state through an on-disk reference-format
        checkpoint file: write
        the exact payload the reference's save_checkpoint produces
        (train.py:398-437 — a monolithic dict with ``model_state_dict``,
        optimizer/scheduler states, counters, RNG blobs), with keys
        ``_orig_mod.``-prefixed as a torch.compile'd run would leave
        them, then import through the PRODUCTION file loader
        ``load_reference_checkpoint``. Proves the entire
        checkpoint-file path; only the download itself stays untested
        in this zero-egress image."""
        import tempfile

        import torch

        from triad.models.reference_import import (
            load_reference_checkpoint,
        )

        sd = {
            f"_orig_mod.{k}": v
            for k, v in self.torch_model.state_dict().items()
        }
        payload = {
            "model_state_dict": sd,
            "optimizer_others_state_dict": {},
            "optimizer_audio_state_dict": {},
            "optimizer_text_state_dict": {},
            "optimizer_vit_lora_state_dict": {},
            "epoch": 0,
            "global_step": 0,
            "current_batch_idx": 0,
            "best_loss": float("inf"),
            "rng_state": torch.get_rng_state(),
            "numpy_rng_state": np.random.get_state(),
            "config": {"seed": seed},
        }
        with tempfile.TemporaryDirectory() as d:
            path = str(Path(d) / "checkpoint_epoch0_step0.pt")
            torch.save(payload, path)
            size_mb = Path(path).stat().st_size / 1e6
            print(f"# wrote reference-format checkpoint ({size_mb:.0f} MB),"
                  " reloading via load_reference_checkpoint",
                  file=sys.stderr)
            return load_reference_checkpoint(path, self.cfg)

    # -- jax encoders ---------------------------------------------------

    def _encode(self, img, audio, ids, mask):
        import jax
        import jax.numpy as jnp

        @jax.jit
        def run(params, img, audio, ids, mask):
            from triad.models.multimodal import TriadModel as TM

            return self.model.apply(
                {"params": params}, img, audio, ids, mask, train=False
            )

        return run(
            self.params, jnp.asarray(img), jnp.asarray(audio),
            jnp.asarray(ids.astype(np.int32)), jnp.asarray(mask),
        )

    def _torch_encode(self, img, audio, ids, mask):
        import torch

        with torch.no_grad():
            frames = torch.tensor(img).permute(0, 3, 1, 2)
            v = self.torch_model.visual_embedder(frames)
            a = self.torch_model.audio_embedder(torch.tensor(audio))
            t, _ = self.torch_model.text_embedder(
                torch.tensor(ids), torch.tensor(mask)
            )
        return a.numpy(), v.numpy(), t.numpy()

    # -- legs -----------------------------------------------------------

    def leg_tv(self):
        """Config 1: image-text fwd + TV loss."""
        import torch

        from triad.ops import tv_loss
        import jax.numpy as jnp

        img, audio, ids, mask = make_media(
            self.cfg, self.B, self.audio_samples, self.text_len
        )
        out = self._encode(img, audio, ids, mask)
        ours = tv_loss(
            out["text"], out["visual"], jnp.asarray(mask),
            self.params["temperature"], self.loss_cfg,
        )
        from triad.ops.similarity import aggregate_crossbatch

        clip_ours = np.asarray(
            aggregate_crossbatch(
                out["text"], out["visual"], self.params["temperature"],
                clamp_min=-20.0, query_mask=jnp.asarray(mask),
                implementation="dense", compute_diag=False,
            ).clip_sims
        )
        with torch.no_grad():
            ref = self.torch_model.forward_text_visual(
                torch.tensor(img).permute(0, 3, 1, 2),
                torch.tensor(ids), torch.tensor(mask),
            )
        return {
            "config": 1,
            "total_ours": float(ours.total),
            "total_ref": float(ref["total"]),
            "d_total": abs(float(ours.total) - float(ref["total"])),
            "d_contrastive": abs(
                float(ours.contrastive) - float(ref["contrastive"])
            ),
            "d_reg": abs(float(ours.reg) - float(ref["reg"])),
            "d_clip_sims": float(
                np.abs(clip_ours - ref["clip_sims"].numpy()).max()
            ),
        }

    def leg_av(self):
        """Config 2: audio-visual fwd + AV loss."""
        import torch

        from triad.ops import av_loss

        img, audio, ids, mask = make_media(
            self.cfg, self.B, self.audio_samples, self.text_len, seed=1
        )
        out = self._encode(img, audio, ids, mask)
        ours = av_loss(
            out["audio"], out["visual"], self.params["temperature"],
            self.loss_cfg,
        )
        from triad.ops.similarity import aggregate_crossbatch

        clip_ours = np.asarray(
            aggregate_crossbatch(
                out["audio"], out["visual"], self.params["temperature"],
                clamp_min=-60.0, implementation="dense", compute_diag=False,
            ).clip_sims
        )
        with torch.no_grad():
            ref = self.torch_model.forward_audio_visual(
                torch.tensor(img).permute(0, 3, 1, 2), torch.tensor(audio)
            )
        return {
            "config": 2,
            "total_ours": float(ours.total),
            "total_ref": float(ref["total"]),
            "d_total": abs(float(ours.total) - float(ref["total"])),
            "d_contrastive": abs(
                float(ours.contrastive) - float(ref["contrastive"])
            ),
            "d_reg": abs(float(ours.reg) - float(ref["reg"])),
            "d_smooth": abs(float(ours.smooth) - float(ref["smooth"])),
            "d_clip_sims": float(
                np.abs(clip_ours - ref["clip_sims"].numpy()).max()
            ),
        }

    def leg_trimodal(self):
        """Config 3: generic tri-modal forward — joint loss + the three
        normalized pairwise sim matrices incl. text<->audio."""
        import torch
        import jax
        import jax.numpy as jnp

        img, audio, ids, mask = make_media(
            self.cfg, self.B, self.audio_samples, self.text_len, seed=2
        )

        @jax.jit
        def run(params, img, audio, ids, mask):
            from triad.models.multimodal import TriadModel as TM

            return self.model.apply(
                {"params": params},
                images=img, audio=audio, token_ids=ids, attention_mask=mask,
                method=TM.inference_forward,
            )

        ours = run(
            self.params, jnp.asarray(img), jnp.asarray(audio),
            jnp.asarray(ids.astype(np.int32)), jnp.asarray(mask),
        )
        with torch.no_grad():
            ref = self.torch_model(
                frames=torch.tensor(img).permute(0, 3, 1, 2),
                audio=torch.tensor(audio),
                ids=torch.tensor(ids), mask=torch.tensor(mask),
            )
        out = {"config": 3}
        for k in (
            "vis_text_sim_matrix", "vis_audio_sim_matrix",
            "text_audio_sim_matrix",
        ):
            out[f"d_{k}"] = float(
                np.abs(np.asarray(ours[k]) - ref[k].numpy()).max()
            )
        return out

    def leg_retrieval(self, n: int):
        """Config 4: N-way retrieval (reference per-pair loop vs our
        vectorized eval) + viz heatmap parity."""
        import torch
        import torch.nn.functional as F

        from tests.torch_oracle import oracle_retrieval_aggregate
        from triad.eval.retrieval import (
            av_retrieval_metrics,
            compute_recall_at_k,
            tv_retrieval_metrics,
        )
        from triad.viz.heatmaps import patches_to_heatmaps

        temp = float(self.params["temperature"])
        # Embed n items (batched to bound memory at full size).
        a_all, v_all, t_all = [], [], []
        bs = 8
        for lo in range(0, n, bs):
            m = min(bs, n - lo)
            img, audio, ids, mask = make_media(
                self.cfg, m, self.audio_samples, self.text_len, seed=100 + lo
            )
            out = self._encode(img, audio, ids, mask)
            a_all.append(np.asarray(out["audio"], np.float32))
            v_all.append(np.asarray(out["visual"], np.float32))
            t_all.append(np.asarray(out["text"], np.float32))
        a = np.concatenate(a_all)
        v = np.concatenate(v_all)
        t = np.concatenate(t_all)
        masks = np.ones((n, a.shape[1]), np.float32)
        t_mask = np.ones((n, t.shape[1]), np.float32)

        # ours: vectorized blocked eval (triad/eval/retrieval.py)
        ours_av = av_retrieval_metrics(
            a / np.linalg.norm(a, axis=-1, keepdims=True),
            masks,
            v / np.linalg.norm(v, axis=-1, keepdims=True),
            temp,
        )
        ours_tv = tv_retrieval_metrics(t, t_mask, v, temp)

        # reference: the O(N^2) per-pair aggregation loop
        # (retrieval.py:159-175; embed: AV normalized :93-94, TV not
        # :236-246 — asymmetry kept on both sides)
        ta = F.normalize(torch.tensor(a), dim=-1)
        tv_ = F.normalize(torch.tensor(v), dim=-1)
        tt = torch.tensor(t)
        tvu = torch.tensor(v)

        def pair_scores(qs, ks):
            s = np.zeros((n, n), np.float32)
            for i in range(n):
                for j in range(n):
                    s[i, j] = oracle_retrieval_aggregate(qs[i], ks[j], temp)
            return s

        ref_a2v = compute_recall_at_k(pair_scores(ta, tv_))
        ref_v2a = compute_recall_at_k(pair_scores(tv_, ta))
        ref_t2v = compute_recall_at_k(pair_scores(tt, tvu))
        ref_v2t = compute_recall_at_k(pair_scores(tvu, tt))

        out = {"config": 4, "n": n}
        for direction, ref_m in (
            ("A->V", ref_a2v), ("V->A", ref_v2a),
            ("T->V", ref_t2v), ("V->T", ref_v2t),
        ):
            for k in ("r1", "r5", "r10"):
                ours_m = (ours_av if "A" in direction else ours_tv)[
                    f"{direction}_{k}"
                ]
                out[f"{direction}_{k}_ours"] = ours_m
                out[f"{direction}_{k}_ref"] = ref_m[k]
                out[f"d_{direction}_{k}"] = abs(ours_m - ref_m[k])

        # viz heatmaps: normalized sims + the squaring quirk
        from triad.ops.similarity import pairwise_similarity
        from tests.torch_oracle import oracle_pairwise_similarity
        import jax.numpy as jnp

        sims_ours = np.asarray(
            pairwise_similarity(
                jnp.asarray(a[:1]), jnp.asarray(v[:1]),
                self.params["temperature"],
            )[0]
        )
        sims_ref = oracle_pairwise_similarity(
            torch.tensor(a[:1]), torch.tensor(v[:1]), torch.tensor(temp)
        )[0].numpy()
        out["d_viz_sims"] = float(np.abs(sims_ours - sims_ref).max())
        grid = self.cfg.vit.image_size // self.cfg.vit.patch_size
        hm_ours = patches_to_heatmaps(
            sims_ours, grid, self.cfg.vit.image_size
        )
        hm_ref_pre = (sims_ref.reshape(-1, grid, grid)) ** 2  # viz.py:62
        hm_ours_pre = (sims_ours.reshape(-1, grid, grid)) ** 2
        out["d_viz_heatmap_grid"] = float(
            np.abs(hm_ours_pre - hm_ref_pre).max()
        )
        out["viz_heatmap_shape"] = list(hm_ours.shape)
        return out

    def leg_train_steps(self, steps: int):
        """Config 5 (semantics leg): K joint train steps, reference
        optimizer wiring on both sides (4x AdamW + OneCycle + subtree
        clip 10, train.py:246-348, 988-1040), all groups unfrozen from
        step 0, accumulation 1. Compares the per-step loss trajectory."""
        import jax
        import jax.numpy as jnp
        import torch
        from torch.nn.utils import clip_grad_norm_

        from tests.torch_oracle import oracle_av_loss, oracle_tv_loss
        from triad.core.config import OptimConfig
        from triad.train import (
            OptimizerBank,
            ParamPartition,
            StepFactory,
            init_train_state,
        )

        # >=100: torch OneCycleLR divides by pct_start*total_steps-1
        # (zero-length warmup phase below ~10 steps)
        total_updates = max(steps * 2, 100)
        lr = 1e-4
        optim_cfg = OptimConfig(
            learning_rate=lr, gradient_accumulation_steps=1,
            unfreeze_audio_step=0, unfreeze_text_step=0, unfreeze_vit_step=0,
        )
        partition = ParamPartition(self.params)
        bank = OptimizerBank(optim_cfg, partition, total_updates)
        factory = StepFactory(
            self.cfg, self.loss_cfg, optim_cfg, bank, mesh=None
        )
        state = init_train_state(
            jax.tree.map(jnp.asarray, self.params), bank, jax.random.key(0)
        )
        step = jax.jit(factory.make_step("joint"))

        # torch side: fresh copy of the model in train mode (dropouts are
        # all zero by config), reference optimizer wiring
        tm = self.torch_model
        tm.train()
        audio_p, text_p, lora_p, vit_p, others_p = [], [], [], [], []
        for name, p in tm.named_parameters():
            if "audio_embedder.hubert" in name:
                audio_p.append(p)
            elif "text_embedder.encoder" in name:
                text_p.append(p)
            elif "visual_embedder.model" in name and "lora" in name:
                lora_p.append(p)
            elif "visual_embedder.model" in name:
                vit_p.append(p)
            else:
                others_p.append(p)
        for p in vit_p:
            p.requires_grad = False
        opts = {
            "others": torch.optim.AdamW(others_p, lr=lr),
            "audio": torch.optim.AdamW(audio_p, lr=lr),
            "text": torch.optim.AdamW(text_p, lr=lr),
            "vit_lora": torch.optim.AdamW(lora_p, lr=lr),
        }
        scales = {"others": 1.0, "audio": 0.25, "text": 0.75, "vit_lora": 0.5}
        scheds = {
            g: torch.optim.lr_scheduler.OneCycleLR(
                opts[g], max_lr=lr * scales[g], total_steps=total_updates,
                pct_start=0.1, div_factor=10, final_div_factor=1e4,
                anneal_strategy="cos",
            )
            for g in opts
        }

        losses_ours, losses_ref = [], []
        one = jnp.float32(1.0)
        for k in range(steps):
            img, audio, ids, mask = make_media(
                self.cfg, self.B, self.audio_samples, self.text_len,
                seed=500 + k,
            )
            av_batch = {
                "images": jnp.asarray(img), "audio": jnp.asarray(audio)
            }
            tv_batch = {
                "images": jnp.asarray(img),
                "token_ids": jnp.asarray(ids.astype(np.int32)),
                "text_mask": jnp.asarray(mask),
            }
            state, metrics = step(state, av_batch, tv_batch, one, one)
            losses_ours.append(float(metrics["train_loss"]))

            frames = torch.tensor(img).permute(0, 3, 1, 2)
            av = tm.forward_audio_visual(frames, torch.tensor(audio))
            tv = tm.forward_text_visual(
                frames, torch.tensor(ids), torch.tensor(mask)
            )
            loss = av["total"] + tv["total"]
            losses_ref.append(float(loss))
            for opt in opts.values():
                opt.zero_grad()
            loss.backward()
            clip_grad_norm_(tm.audio_embedder.parameters(), 10.0)
            clip_grad_norm_(tm.text_embedder.parameters(), 10.0)
            for g in opts:
                opts[g].step()
                scheds[g].step()
        tm.eval()
        deltas = [abs(a - b) for a, b in zip(losses_ours, losses_ref)]
        return {
            "config": 5,
            "steps": steps,
            "losses_ours": losses_ours,
            "losses_ref": losses_ref,
            "d_per_step": deltas,
            "d_max": max(deltas),
            "d_temperature": abs(
                float(state.params["temperature"])
                - float(tm.temperature.detach())
            ),
        }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=["small", "full"], default="small")
    ap.add_argument("--legs", default="1,2,3,4,5")
    ap.add_argument("--retr-n", type=int, default=None)
    ap.add_argument("--train-steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--via-file", action="store_true",
        help="round-trip the weights through an on-disk reference-format "
             "checkpoint (torch.save -> load_reference_checkpoint)",
    )
    ap.add_argument(
        "--ref-ckpt", default=None,
        help="path to a REAL reference checkpoint_epoch{E}_step{S}.pt; "
             "loads it into both frameworks (runbook: on a machine with "
             "the trained checkpoint, run --size full --ref-ckpt PATH "
             "--legs 1,2,3,4)",
    )
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    h = Harness(
        args.size, seed=args.seed, via_file=args.via_file,
        ref_ckpt=args.ref_ckpt,
    )
    legs = {int(x) for x in args.legs.split(",")}
    retr_n = args.retr_n or (16 if args.size == "small" else 32)
    results = []
    for leg, fn in (
        (1, h.leg_tv),
        (2, h.leg_av),
        (3, h.leg_trimodal),
        (4, lambda: h.leg_retrieval(retr_n)),
        (5, lambda: h.leg_train_steps(args.train_steps)),
    ):
        if leg not in legs:
            continue
        t0 = time.time()
        r = fn()
        r["seconds"] = round(time.time() - t0, 1)
        results.append(r)
        print(json.dumps(r))
    worst = max(
        (v for r in results for k, v in r.items()
         if k.startswith("d_") and isinstance(v, float)),
        default=0.0,
    )
    print(json.dumps({"size": args.size, "worst_delta": worst}))


if __name__ == "__main__":
    main()
