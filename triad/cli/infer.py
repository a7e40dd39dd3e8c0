"""Tri-modal inference CLI: the reference's generic ``model.forward``
surface (model.py:610-637) as a standalone command — any subset of
{image, media/audio, text} in, per-modality token features plus all
pairwise normalized similarity matrices (including text<->audio) out.

  python -m triad.cli.infer --run-dir ./outputs_triad \
      --image frame.jpg --media clip.mp4 --text "a dog barking" \
      --out sims.json

``--image`` accepts an image file (the reference's forward takes a
frame *path*, model.py:614-622); ``--media`` extracts the audio track
of a wav/mp4 via the native decode stack. ``--random-init`` runs with
fresh parameters (smoke mode, no checkpoint needed). ``--int8`` runs
the Dense matmuls in the opt-in int8 serving mode
(models/quantize.py). Feature arrays go to ``--features-npz``; the
JSON output carries shapes and similarity-matrix summaries.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="tri-modal inference")
    parser.add_argument("--run-dir", help="training output dir (checkpoint)")
    parser.add_argument(
        "--random-init", action="store_true",
        help="fresh parameters instead of a checkpoint (smoke mode)",
    )
    parser.add_argument(
        "--config", help="YAML/JSON config file (with --random-init)"
    )
    parser.add_argument("--image", help="image file (jpg/png)")
    parser.add_argument("--media", help="wav/mp4 whose audio track to use")
    parser.add_argument("--text", help="caption text")
    parser.add_argument("--int8", action="store_true",
                        help="int8 serving mode for Dense matmuls")
    parser.add_argument("--out", help="write the JSON summary here")
    parser.add_argument("--features-npz", help="write feature arrays here")
    from triad.cli.common import add_platform_arg, apply_platform
    add_platform_arg(parser)

    args = parser.parse_args(argv)
    apply_platform(args)
    if not (args.image or args.media or args.text):
        parser.error("at least one of --image/--media/--text is required")
    if not args.run_dir and not args.random_init:
        parser.error("--run-dir or --random-init is required")

    import numpy as np
    import jax
    import jax.numpy as jnp

    from triad.core.config import Config
    from triad.models import TriadModel, init_triad_model

    if args.run_dir:
        from triad.train.checkpoint import read_run_meta

        meta = read_run_meta(args.run_dir)
        config = Config.from_dict(meta["config"])
        from triad.train.trainer import Trainer

        trainer = Trainer(config, force_new_training=False)
        params = jax.device_get(trainer.state.params)
        tokenizer = trainer.tokenizer
    else:
        if args.config:
            from triad.cli.train import load_config_file

            config = Config.from_dict(load_config_file(args.config))
        else:
            config = Config()
        params = init_triad_model(config.model, jax.random.key(0))
        from triad.data.tokenizer import WordPieceTokenizer

        tokenizer = WordPieceTokenizer.build_from_corpus(
            [args.text or "a"]
        )

    model = TriadModel(config.model)
    images = audio = token_ids = attention_mask = None
    if args.image:
        from triad.data.images import clean_image, load_image

        img = load_image(args.image, config.data.image_size)
        images = jnp.asarray(clean_image(img)[None])
    if args.media:
        from triad.data.audio import extract_audio, pad_or_trim

        wav = extract_audio(args.media)
        wav = pad_or_trim(wav, config.data.audio_num_samples)
        audio = jnp.asarray(wav[None])
    if args.text:
        ids, mask = tokenizer.encode_batch(
            [args.text], max_length=config.data.max_text_tokens,
            pad_to=config.data.max_text_tokens,
        )
        token_ids = jnp.asarray(ids)
        attention_mask = jnp.asarray(mask, jnp.float32)

    def run(params):
        return model.apply(
            {"params": params}, images=images, audio=audio,
            token_ids=token_ids, attention_mask=attention_mask,
            method=TriadModel.inference_forward,
        )

    if args.int8:
        from triad.models.quantize import int8_interception

        with int8_interception():
            out = jax.jit(run)(params)
    else:
        out = jax.jit(run)(params)
    out = {k: np.asarray(v) for k, v in out.items()}

    summary = {}
    for k, v in out.items():
        entry = {"shape": list(v.shape)}
        if k.endswith("_sim_matrix"):
            entry.update(
                mean=float(v.mean()), max=float(v.max()), min=float(v.min())
            )
        summary[k] = entry
    text = json.dumps(summary, indent=2, sort_keys=True)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    if args.features_npz:
        np.savez(args.features_npz, **out)


if __name__ == "__main__":
    main()
