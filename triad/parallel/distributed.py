"""Multi-process (multi-host / multi-slice) runtime support.

The reference is single-GPU, single-process (SURVEY §2.6); the
single-host scale-out (one process driving every card of a host) needs
none of this. Going PAST one host — multi-slice (docs/MULTISLICE.md) or
any cluster where devices hang off several hosts — requires one JAX
process per host, all participating in every collective. This module is
that enablement:

  * ``initialize_from_env()`` — bring up the JAX distributed runtime
    from ``TRIAD_COORDINATOR`` / ``TRIAD_NUM_PROCESSES`` /
    ``TRIAD_PROCESS_ID`` (explicit, for CPU smoke tests and manual
    launches) or from a cluster environment JAX auto-detects (SLURM,
    Open MPI).
  * ``global_batch_from_local(mesh, pspec, local)`` — assemble a
    globally-sharded jax.Array from each process's host-local rows
    (``jax.make_array_from_process_local_data``); the multi-process
    analog of the trainer's single-process ``device_put(...,
    NamedSharding)``.
  * ``process_shard()`` — (process_index, process_count) for the data
    loaders: every process runs the SAME deterministic sampler (seed,
    epoch, batch) and decodes only its row-slice of each global batch,
    so order/resume semantics are bitwise-identical to single-process
    runs (the reference's mid-epoch-resume contract, train.py:914-926).

Correctness is pinned by scripts/multiproc_smoke.py (run as
tests/test_parallel.py::test_multiprocess_dp_matches_single_process):
2 CPU processes x 4 virtual devices each == the single-process
8-device mesh, loss bitwise-close, params in step.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_from_env() -> Tuple[int, int]:
    """Initialize jax.distributed when configured; return
    (process_index, process_count).

    Explicit configuration (all three or none):
      TRIAD_COORDINATOR   host:port of process 0
      TRIAD_NUM_PROCESSES total process count
      TRIAD_PROCESS_ID    this process's id (0-based)

    Without them and with ``TRIAD_AUTO_DISTRIBUTED`` set,
    ``jax.distributed.initialize()`` auto-detects the cluster
    environment; otherwise this is a no-op. Safe to call more than once (subsequent calls return the
    current state).
    """
    coord = os.environ.get("TRIAD_COORDINATOR")
    if coord:
        n = int(os.environ["TRIAD_NUM_PROCESSES"])
        pid = int(os.environ["TRIAD_PROCESS_ID"])
        try:
            jax.distributed.initialize(
                coordinator_address=coord, num_processes=n, process_id=pid
            )
        except RuntimeError as e:  # already initialized
            if "already" not in str(e).lower():
                raise
    elif os.environ.get("TRIAD_AUTO_DISTRIBUTED"):
        # Cluster schedulers JAX can read (SLURM, Open MPI). Opt-in —
        # unconditional auto-init would hang single-host CLI runs that
        # merely imported this module while a cluster env var leaked.
        try:
            jax.distributed.initialize()
        except RuntimeError as e:
            if "already" not in str(e).lower():
                raise
    return jax.process_index(), jax.process_count()


def process_shard() -> Optional[Tuple[int, int]]:
    """(process_index, process_count) when multi-process, else None —
    the loaders' row-slice selector."""
    if jax.process_count() > 1:
        return jax.process_index(), jax.process_count()
    return None


def coordination_barrier(name: str, timeout_ms: int = 3_600_000) -> None:
    """Rendezvous at the coordination-service barrier — plain gRPC to
    process 0's distributed-runtime service, NOT a device collective
    (no gloo/NCCL context required).

    Why it exists: the gloo CPU-collectives rendezvous does hardcoded
    ~30 s KeyValue lookups while building its full-mesh context at the
    FIRST collective. Per-process XLA compile time is skewed (a cold
    cache on a loaded 1-core machine measured minutes of skew), so
    process A can enter the first collective and exhaust
    the 30 s window while process B is still compiling. Processes that
    AOT-compile first and then meet here enter the first collective
    moments apart, which gloo's window always covers. No-op when
    single-process or the runtime has no client (e.g. tests that fake
    process_count).
    """
    if jax.process_count() == 1:
        return
    from jax._src import distributed as _dist

    client = getattr(_dist.global_state, "client", None)
    if client is None:
        return
    client.wait_at_barrier(name, timeout_in_ms=timeout_ms)


def fetch(x) -> np.ndarray:
    """Bring a (possibly globally-sharded) jax.Array to host as numpy.

    Single-process: plain np.asarray. Multi-process: arrays from a
    global-mesh jit span non-addressable devices, so gather the full
    value on every process (multihost_utils.process_allgather, tiled —
    returns the global array, not a stacked per-process copy).
    """
    if jax.process_count() == 1 or not isinstance(x, jax.Array):
        return np.asarray(x)
    if x.is_fully_addressable:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def put_global_tree(tree, shardings):
    """device_put for host pytrees where EVERY process holds the full
    (identical) value — state init, checkpoint restore.

    Single-process this is exactly ``jax.device_put(tree, shardings)``.
    Multi-process, ``device_put`` rejects shardings with non-addressable
    devices, so each leaf is assembled with
    ``jax.make_array_from_callback``: every process slices its own
    addressable shards out of its full host copy (identical across
    processes by construction — same seed, same host computation).
    """
    if jax.process_count() == 1:
        return jax.device_put(tree, shardings)

    def _leaf(x, s: NamedSharding):
        if isinstance(x, jax.Array) and jax.dtypes.issubdtype(
            x.dtype, jax.dtypes.prng_key
        ):
            # Typed PRNG keys: assemble the underlying uint32 data (the
            # key is replicated, so the P() spec applies at any rank)
            # and re-wrap with the same impl.
            impl = jax.random.key_impl(x)
            data = _leaf(jax.random.key_data(x), s)
            return jax.random.wrap_key_data(data, impl=impl)
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, s, lambda idx: x[idx])

    if isinstance(shardings, jax.sharding.Sharding):
        return jax.tree.map(lambda x: _leaf(x, shardings), tree)
    return jax.tree.map(_leaf, tree, shardings)


def global_batch_from_local(
    mesh: Mesh, pspec: P, local: np.ndarray
) -> jax.Array:
    """Globally-sharded array from this process's host-local rows.

    ``local`` holds global_batch/process_count rows (the loader's
    process_shard slice); the returned jax.Array has the full global
    shape, sharded over ``pspec``, with only this host's shards
    addressable — exactly what the pjit'd DP step consumes.
    """
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, pspec), np.asarray(local)
    )
