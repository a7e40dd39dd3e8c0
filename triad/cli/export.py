"""Export a trained run to a self-contained serving bundle.

  python -m triad.cli.export --run-dir ./outputs_triad \
      --out ./bundle [--best] [--int8] [--platforms cpu,cuda]

  # smoke mode (no checkpoint):
  python -m triad.cli.export --random-init --out ./bundle

The bundle (serve/export.py) carries StableHLO modules with a symbolic
batch dim for audio/visual/text embedding + the retrieval pair-scorer,
the WordPiece vocab, and metadata — serve it with
``python -m triad.cli.serve --bundle ./bundle``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="export a serving bundle")
    p.add_argument("--run-dir", help="training output dir (checkpoint)")
    p.add_argument(
        "--random-init", action="store_true",
        help="fresh parameters instead of a checkpoint (smoke mode)",
    )
    p.add_argument("--config", help="YAML/JSON config (with --random-init)")
    p.add_argument("--out", required=True, help="bundle output dir")
    p.add_argument(
        "--best", action="store_true",
        help="export the best checkpoint instead of the latest",
    )
    p.add_argument("--int8", action="store_true",
                   help="int8 serving mode for Dense matmuls")
    p.add_argument(
        "--platforms", default="cpu,cuda",
        help="comma-separated lowering platforms (default cpu,cuda)",
    )
    from triad.cli.common import add_platform_arg, apply_platform
    add_platform_arg(p)

    args = p.parse_args(argv)
    apply_platform(args)
    if not args.run_dir and not args.random_init:
        p.error("--run-dir or --random-init is required")

    import jax

    from triad.core.config import Config
    from triad.models import init_triad_model
    from triad.serve.export import export_bundle

    if args.run_dir:
        from triad.train.checkpoint import read_run_meta

        meta = read_run_meta(args.run_dir)
        config = Config.from_dict(meta["config"])
        from triad.train.trainer import Trainer

        trainer = Trainer(config, force_new_training=False)
        if args.best:
            state, _, _ = trainer.ckpt.restore_best(trainer.state)
            params = jax.device_get(state.params)
        else:
            params = jax.device_get(trainer.state.params)
        vocab = trainer.tokenizer.vocab
    else:
        if args.config:
            from triad.cli.train import load_config_file

            config = Config.from_dict(load_config_file(args.config))
        else:
            config = Config()
        params = init_triad_model(config.model, jax.random.key(0))
        from triad.data.tokenizer import WordPieceTokenizer

        vocab = WordPieceTokenizer.build_from_corpus(
            ["a placeholder vocabulary for smoke exports"]
        ).vocab

    out = export_bundle(
        params,
        config.model,
        args.out,
        audio_num_samples=config.data.audio_num_samples,
        max_text_tokens=config.data.max_text_tokens,
        vocab=vocab,
        int8=args.int8,
        platforms=tuple(args.platforms.split(",")),
    )
    print(f"exported serving bundle -> {out}")


if __name__ == "__main__":
    main()
