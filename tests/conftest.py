"""Test environment: force an 8-device CPU mesh before JAX initializes.

Tests never need an accelerator: multi-device sharding runs on virtual
CPU devices, and the Pallas kernel runs in the interpreter (opted into
below). What needs the card is a phase of chip_smoke.py.
"""

import os

# XLA_FLAGS is read at backend init, so setting it here is early enough.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
# Parity tests compare against torch fp32, so force full-precision
# float32 matmuls.
jax.config.update("jax_default_matmul_precision", "highest")

from triad.cli.common import enable_compile_cache
from triad.ops.flash_attention import use_interpreter

# The suite is dominated by CPU compiles of jitted programs; the
# persistent cache makes repeat runs several times faster.
enable_compile_cache()
# The flash kernel compiles for a GPU only: here it runs in the Pallas
# interpreter.
use_interpreter(True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
