"""Qualitative grounding demo: train on the grounded synthetic task,
then render dense attention artifacts through the production viz stack.

The reference demonstrates its result with checked-in heatmap images
(src/conts/*.png). This is the framework's equivalent, reproducible
end-to-end on CPU in ~3 minutes with no datasets or pretrained weights:
a from-scratch tiny TriadModel learns square<->tone<->word grounding
(tests/test_learning.py asserts the numbers) and the demo writes

  docs/demo/grounded_av_tokens.png  — audio-token attention grid: the
      heatmap mass sits on the class square's patch cell
  docs/demo/grounded_text_tokens.png — the class word's attention
  docs/demo/grounded_attention.mp4  — per-audio-token attention video
      with the (AAC) tone track muxed in, natively authored H.264

Run: python scripts/grounded_demo.py [out_dir]
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, ".")

import numpy as np
import jax.numpy as jnp


def main() -> None:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "docs/demo"
    from pathlib import Path

    from tests.test_learning import (
        AUDIO_SECONDS,
        K,
        av_batch_at,
        grounded_model_config,
        token_id,
        tv_batch_at,
    )
    from triad.core.config import LossConfig, OptimConfig
    from triad.data.datasets import (
        GroundedSyntheticAVDataset,
        GroundedSyntheticSpec,
        GroundedSyntheticTVDataset,
    )
    from triad.models import TriadModel, init_triad_model
    from triad.ops import pairwise_similarity
    from triad.train import (
        OptimizerBank,
        ParamPartition,
        StepFactory,
        init_train_state,
    )
    from triad.viz.heatmaps import AudioVisualizer, TextVisualizer

    cfg = grounded_model_config()
    spec = GroundedSyntheticSpec(num_classes=K)
    train_av = GroundedSyntheticAVDataset(
        size=64, audio_seconds=AUDIO_SECONDS, spec=spec, seed=0
    )
    train_tv = GroundedSyntheticTVDataset(size=64, spec=spec, seed=0)
    loss_cfg = LossConfig()
    optim_cfg = OptimConfig(
        learning_rate=2e-3, gradient_accumulation_steps=1,
        unfreeze_audio_step=0, unfreeze_text_step=0, unfreeze_vit_step=0,
    )
    params = init_triad_model(cfg, jax.random.key(0))
    bank = OptimizerBank(optim_cfg, ParamPartition(params), total_updates=120)
    factory = StepFactory(cfg, loss_cfg, optim_cfg, bank)
    state = init_train_state(params, bank, jax.random.key(1))
    step = jax.jit(factory.make_step("joint"))
    one = jnp.float32(1.0)
    for s in range(120):
        idxs = [(s * K + j) % len(train_av) for j in range(K)]
        state, m = step(
            state, av_batch_at(train_av, idxs), tv_batch_at(train_tv, idxs),
            one, one,
        )
        if s % 30 == 0:
            print(f"step {s}: loss {float(m['train_loss']):.3f}", flush=True)

    model = TriadModel(cfg)
    params = jax.device_get(state.params)

    dummy_ids = jnp.zeros((1, 2), jnp.int32)
    dummy_mask = jnp.ones((1, 2), jnp.float32)

    @jax.jit
    def encode(frames, audio):
        out = model.apply(
            {"params": params}, frames, audio, dummy_ids, dummy_mask,
            train=False,
        )
        return out["audio"], out["visual"], out["text"]

    # Pick a held-out sample whose token-mean attention argmax lands on
    # the class cell (the learning test shows ~11/16 do; like the
    # reference's curated conts/*.png, the demo shows a clean one).
    eval_av = GroundedSyntheticAVDataset(
        size=16, audio_seconds=AUDIO_SECONDS, spec=spec, seed=4242
    )
    pick = 0
    for i in range(len(eval_av)):
        it = eval_av[i]
        a, v, _ = encode(
            jnp.asarray(it["video_frames"][None]), jnp.asarray(it["audio"][None])
        )
        an = np.array(a[0])
        vn = np.array(v[0])
        an /= np.linalg.norm(an, axis=-1, keepdims=True) + 1e-12
        vn /= np.linalg.norm(vn, axis=-1, keepdims=True) + 1e-12
        score = np.einsum("td,pd->tp", an, vn).mean(axis=0)
        kk = eval_av.label(i)
        r, c = spec.cell(kk)
        if score.argmax() == r * spec.grid + c:
            pick = i
            break
    item = eval_av[pick]
    frame = np.asarray(item["video_frames"], np.float32)
    audio = np.asarray(item["audio"], np.float32)
    k = eval_av.label(pick)
    print(f"demo sample {pick}, class {k}: word={spec.word(k)!r} "
          f"cell={spec.cell(k)} freq={spec.frequency(k):.0f} Hz", flush=True)

    def av_similarity(frame_b, audio_b):
        a, v, _ = encode(jnp.asarray(frame_b), jnp.asarray(audio_b))
        temp = jnp.asarray(params["temperature"])
        return np.asarray(pairwise_similarity(a, v, temp)[0])

    def tv_similarity(frame_b, text):
        ids = jnp.asarray([[token_id(k), 0]], jnp.int32)
        mask = jnp.ones((1, 2), jnp.float32)
        out = model.apply(
            {"params": params}, jnp.asarray(frame_b),
            jnp.zeros((1, len(audio)), jnp.float32), ids, mask, train=False,
        )
        temp = jnp.asarray(params["temperature"])
        sims = np.asarray(
            pairwise_similarity(out["text"], out["visual"], temp)[0]
        )
        return sims[:1], [spec.word(k)]  # the one valid token

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    av_viz = AudioVisualizer(
        patch_size=spec.patch_size, image_size=spec.image_size
    )
    av_viz.plot_audio_token_attentions(
        av_similarity, frame, audio,
        output_path=str(out / "grounded_av_tokens.png"),
        num_tokens_to_show=4,
    )
    av_viz.make_attention_video(
        av_similarity, frame, audio, str(out / "grounded_attention.mp4"),
        fps=40,
    )
    tv_viz = TextVisualizer(
        patch_size=spec.patch_size, image_size=spec.image_size
    )
    tv_viz.plot_token_attentions(
        tv_similarity, frame, spec.word(k),
        output_path=str(out / "grounded_text_tokens.png"),
    )
    print(f"artifacts in {out}/", flush=True)


if __name__ == "__main__":
    main()
