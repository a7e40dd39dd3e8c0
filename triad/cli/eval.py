"""Retrieval evaluation CLI: load a checkpoint, run the 1000-way
cross-modal retrieval (R@1/5/10/20, A<->V and T<->V) and print/save the
metrics — the reference's eval_1000_way_retrieval surface
(train.py:835-874) as a standalone command.

  python -m triad.cli.eval --run-dir ./outputs_triad [--best]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="1000-way retrieval eval")
    parser.add_argument("--run-dir", required=True, help="training output dir")
    parser.add_argument(
        "--best", action="store_true", help="evaluate the best checkpoint"
    )
    parser.add_argument("--out", help="write metrics JSON here")
    from triad.cli.common import (
        add_platform_arg, apply_platform, enable_compile_cache,
    )
    add_platform_arg(parser)

    args = parser.parse_args(argv)
    apply_platform(args)
    enable_compile_cache()

    from triad.core.config import Config
    from triad.train.trainer import Trainer

    run_dir = Path(args.run_dir)
    # Config travels inside the checkpoint metadata.
    from triad.train.checkpoint import read_run_meta

    meta = read_run_meta(args.run_dir)
    config = Config.from_dict(meta["config"])

    trainer = Trainer(config, force_new_training=False)
    if args.best:
        state, _, _ = trainer.ckpt.restore_best(trainer.state)
        trainer.state = state
    metrics = trainer.eval_1000_way_retrieval()
    print(json.dumps(metrics, indent=2, sort_keys=True))
    if args.out:
        Path(args.out).write_text(json.dumps(metrics, indent=2, sort_keys=True))


if __name__ == "__main__":
    main()
