"""Shared CLI plumbing."""

from __future__ import annotations

import argparse
import hashlib
import os
import platform
from pathlib import Path

# The checkout's own compile cache (listed in .gitignore).
_REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def add_platform_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--platform",
        choices=("cpu", "cuda"),
        default=os.environ.get("TRIAD_PLATFORM"),
        help="force the JAX backend (default: JAX's own selection). "
        "Must take effect before any backend initializes. Also "
        "settable via TRIAD_PLATFORM.",
    )


def apply_platform(args: argparse.Namespace) -> None:
    """Call BEFORE anything touches a JAX backend."""
    platform_name = getattr(args, "platform", None)
    if platform_name:
        import jax

        jax.config.update("jax_platforms", platform_name)


def _host_fingerprint() -> str:
    """Short hash of the host's ISA: XLA:CPU cache entries are executables
    for the exact compile host, so a cache shared across machine types
    must not mix them."""
    finger = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    finger += " " + " ".join(sorted(line.split()[2:]))
                    break
    except OSError:
        finger += " " + platform.processor()
    return hashlib.sha256(finger.encode()).hexdigest()[:12]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself and
    nothing else is set). Otherwise the cache lives at a fixed path in
    the checkout, ``.jax_cache/<host ISA hash>``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(_REPO_CACHE / _host_fingerprint())
    jax.config.update("jax_compilation_cache_dir", path)
    return path
