"""Training CLI.

The reference has no CLI (hard-coded kwargs at train.py:1148-1183); this
provides one: YAML/JSON config file + dotted overrides, synthetic-data
mode for smoke runs.

  python -m triad.cli.train --config cfg.yaml
  python -m triad.cli.train --synthetic --steps 5 --output-dir /tmp/run
  python -m triad.cli.train --set train.num_epochs=3 data.batch_size_av=16
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict


def load_config_file(path: str) -> Dict[str, Any]:
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path) as f:
            return yaml.safe_load(f)
    with open(path) as f:
        return json.load(f)


def apply_overrides(cfg_dict: Dict[str, Any], overrides) -> Dict[str, Any]:
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        if not _:
            raise ValueError(f"override must be key=value, got {ov!r}")
        node = cfg_dict
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node[parts[-1]] = value
    return cfg_dict


def build_config(args) -> "Config":
    from triad.core.config import Config

    cfg_dict = load_config_file(args.config) if args.config else {}
    cfg_dict = apply_overrides(cfg_dict, args.set)
    if args.output_dir:
        cfg_dict.setdefault("train", {})["output_dir"] = args.output_dir
    if args.steps:
        cfg_dict.setdefault("train", {})["steps_per_epoch"] = args.steps
    base = Config().to_dict()
    _deep_update(base, cfg_dict)
    return Config.from_dict(base)


def _deep_update(base: Dict[str, Any], new: Dict[str, Any]) -> None:
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v


def main(argv=None):
    """Train; returns the Trainer (its state, progress and output dir)."""
    parser = argparse.ArgumentParser(description="Train the tri-modal model")
    parser.add_argument("--config", help="YAML/JSON config file")
    parser.add_argument(
        "--set", nargs="*", metavar="KEY=VALUE",
        help="dotted config overrides, e.g. train.num_epochs=3",
    )
    parser.add_argument("--output-dir", help="output directory override")
    parser.add_argument(
        "--synthetic", action="store_true",
        help="use synthetic data (no dataset paths needed)",
    )
    parser.add_argument("--steps", type=int, help="steps per epoch override")
    parser.add_argument(
        "--force-new", action="store_true", help="ignore existing checkpoints"
    )
    from triad.cli.common import (
        add_platform_arg, apply_platform, enable_compile_cache,
    )
    add_platform_arg(parser)

    args = parser.parse_args(argv)
    apply_platform(args)
    enable_compile_cache()

    # Multi-host launches: bring up the JAX distributed runtime before
    # any backend touch (TRIAD_COORDINATOR/... env vars; no-op
    # single-process — parallel/distributed.py).
    from triad.parallel.distributed import initialize_from_env

    pid, pc = initialize_from_env()
    if pc > 1:
        print(f"distributed runtime up: process {pid}/{pc}")

    config = build_config(args)
    from triad.train.trainer import Trainer

    trainer = Trainer(config, force_new_training=args.force_new)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
