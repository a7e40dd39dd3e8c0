"""Checkpointing with the reference's resume-exactness contract.

The reference persists a monolithic torch dict (train.py:398-437): model,
4 optimizers + schedulers + per-group step counters, epoch / global step
/ mid-epoch batch offset, dataset segment, full RNG state, best loss,
config, and cached viz samples; autoresume picks the latest by filename
parse (train.py:382-396) and restores everything, then fast-forwards the
dataloaders batch-by-batch (train.py:914-926).

Equivalent here:
  * the whole ``TrainState`` pytree (params, 4-group AdamW moments +
    schedule counts, grad accumulator, global step, PRNG key) saved as
    one ``state.npz`` of flattened leaves, keyed by pytree path;
  * host-side progress (epoch, batch cursor, dataset segment, best loss,
    config, phase info) rides along in ``meta.json`` beside it;
  * each checkpoint is written into a temporary directory and renamed
    into place, so a crash never leaves arrays without their metadata
    or a half-written step that ``latest`` would pick;
  * data-order exactness needs no RNG blob: loaders derive their
    permutation from (seed, epoch) and jump to the batch cursor in O(1)
    (triad.data.pipeline), replacing the reference's
    torch/cuda/numpy/python RNG snapshot with a deterministic cursor;
  * ``latest`` = the highest step directory; ``best`` lives apart and is
    never garbage-collected (best-model semantics, train.py:434-437,
    1137-1140).

Layout::

    <directory>/ckpts/<step>/{state.npz, meta.json}
    <directory>/best/{state.npz, meta.json}
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import shutil
import uuid
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_STATE = "state.npz"
_META = "meta.json"


@dataclasses.dataclass
class HostProgress:
    """Host-side training cursor (reference train.py:469-473)."""

    epoch: int = 0
    global_step: int = 0
    current_batch_idx: int = 0
    dataset_segment: int = 0
    best_loss: float = float("inf")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HostProgress":
        return cls(**d)


def _is_key(x) -> bool:
    return jnp.issubdtype(x.dtype, jax.dtypes.prng_key)


def _to_host(x) -> np.ndarray:
    """A leaf as a host array (typed PRNG keys as their raw key data)."""
    if _is_key(x):
        x = jax.random.key_data(x)
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        x = multihost_utils.process_allgather(x, tiled=True)
    return np.asarray(x)


def _snapshot(tree: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Flattened host copy of ``tree``: arrays by index name, and the
    manifest {name: [pytree path, dtype]}. Dtypes numpy cannot store
    (bfloat16, float8) travel as same-width unsigned views."""
    arrays, manifest = {}, {}
    for i, (path, leaf) in enumerate(
        jax.tree_util.tree_flatten_with_path(tree)[0]
    ):
        arr = _to_host(leaf)
        name = f"a{i}"
        manifest[name] = [jax.tree_util.keystr(path), arr.dtype.name]
        if arr.dtype.kind not in "biuf" or arr.dtype.name == "bfloat16":
            arr = arr.view(f"u{arr.dtype.itemsize}")
        arrays[name] = arr
    return arrays, manifest


def _write(final: Path, arrays, manifest, meta) -> None:
    """Write one checkpoint directory atomically (rename into place)."""
    tmp = final.parent / f".tmp-{final.name}-{uuid.uuid4().hex}"
    tmp.mkdir(parents=True)
    with open(tmp / _STATE, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    (tmp / _META).write_text(json.dumps({**meta, "arrays": manifest}))
    if final.exists():
        trash = final.parent / f".old-{final.name}-{uuid.uuid4().hex}"
        os.rename(final, trash)
        os.rename(tmp, final)
        shutil.rmtree(trash)
    else:
        os.rename(tmp, final)


def _read(directory: Path, abstract_state: Any) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure, dtypes and shardings of
    ``abstract_state`` (a live state or jax.ShapeDtypeStruct tree)."""
    meta = json.loads((directory / _META).read_text())
    by_path = {path: (name, dtype) for name, (path, dtype)
               in meta.pop("arrays").items()}
    leaves, treedef = jax.tree_util.tree_flatten_with_path(abstract_state)
    out = []
    with np.load(directory / _STATE) as npz:
        for path, leaf in leaves:
            key = jax.tree_util.keystr(path)
            if key not in by_path:
                raise KeyError(f"checkpoint {directory} has no leaf {key}")
            name, dtype = by_path[key]
            arr = npz[name]
            if arr.dtype.name != dtype:
                arr = arr.view(jnp.dtype(dtype))
            if _is_key(leaf):
                out.append(jax.random.wrap_key_data(
                    arr, impl=jax.random.key_impl(leaf)
                ))
                continue
            arr = arr.astype(leaf.dtype)
            sharding = getattr(leaf, "sharding", None)
            if sharding is None:
                out.append(jnp.asarray(arr))
            else:
                out.append(jax.make_array_from_callback(
                    arr.shape, sharding, lambda idx, a=arr: a[idx]
                ))
    return jax.tree_util.tree_unflatten(treedef, out), meta


def _barrier(name: str) -> None:
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


class CheckpointManager:
    """Latest/best checkpoint management for TrainState + host progress.

    ``async_save=True`` returns from ``save`` once the arrays are copied
    to host memory; the file write overlaps the next train steps on a
    writer thread. Every read path (restore / latest_step) and ``close``
    drain in-flight saves first. With several processes, every process
    takes part in gathering the arrays and process 0 writes.
    """

    def __init__(
        self, directory: str, max_to_keep: int = 3, async_save: bool = False
    ):
        self.directory = Path(directory).resolve()
        self._ckpts = self.directory / "ckpts"
        self._ckpts.mkdir(parents=True, exist_ok=True)
        self._best_dir = self.directory / "best"
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._writer = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None

    # -- save -----------------------------------------------------------

    def save(
        self,
        step: int,
        train_state: Any,
        progress: HostProgress,
        config_dict: Dict[str, Any],
        extra: Optional[Dict[str, Any]] = None,
        is_best: bool = False,
    ) -> None:
        meta = {
            "step": int(step),
            "progress": progress.to_dict(),
            "config": config_dict,
            "extra": extra or {},
        }
        arrays, manifest = _snapshot(train_state)
        self.wait_until_finished()
        if jax.process_index() == 0:
            self._pending = self._writer.submit(
                self._commit, int(step), arrays, manifest, meta, is_best
            )
        if not self.async_save:
            self.wait_until_finished()
            _barrier(f"triad_ckpt_{step}")

    def _commit(self, step, arrays, manifest, meta, is_best) -> None:
        _write(self._ckpts / str(step), arrays, manifest, meta)
        if is_best:
            _write(self._best_dir, arrays, manifest, meta)
        for old in self._steps()[: -self.max_to_keep]:
            shutil.rmtree(self._ckpts / str(old))

    def wait_until_finished(self) -> None:
        """Block until any in-flight async save has committed (and raise
        its error, if it failed)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    # -- restore --------------------------------------------------------

    def _steps(self):
        return sorted(
            int(p.name) for p in self._ckpts.iterdir()
            if p.is_dir() and p.name.isdigit()
        )

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = self._steps()
        return steps[-1] if steps else None

    def _read_meta(self, step: int) -> Dict[str, Any]:
        meta = json.loads((self._ckpts / str(step) / _META).read_text())
        meta.pop("arrays")
        return meta

    def restore(
        self, abstract_state: Any, step: Optional[int] = None
    ) -> Tuple[Any, HostProgress, Dict[str, Any], Dict[str, Any]]:
        """Returns (train_state, progress, config_dict, extra).

        ``abstract_state`` is a shape/dtype/sharding skeleton of the
        TrainState (e.g. jax.eval_shape of the init fn, or a live state).
        """
        step = step if step is not None else self.latest_step()
        self.wait_until_finished()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._ckpts / str(step)
        if not path.is_dir():
            raise FileNotFoundError(f"no checkpoint for step {step} in {path}")
        state, meta = _read(path, abstract_state)
        # Config travels inside the checkpoint (train.py:427, 475-498):
        # the caller compares against its live config and warns.
        return (
            state,
            HostProgress.from_dict(meta["progress"]),
            meta["config"],
            meta.get("extra", {}),
        )

    def restore_best(self, abstract_state: Any):
        self.wait_until_finished()
        state, meta = _read(self._best_dir, abstract_state)
        return state, HostProgress.from_dict(meta["progress"]), meta["config"]

    def close(self) -> None:
        self.wait_until_finished()
        self._writer.shutdown(wait=True)


def read_run_meta(run_dir: str) -> Dict[str, Any]:
    """Latest checkpoint's metadata (progress/config/extra) of a run
    directory, without constructing a TrainState — the CLI entry points'
    config-discovery path (infer/eval/export)."""
    mgr = CheckpointManager(str(Path(run_dir) / "checkpoints"))
    try:
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {run_dir}")
        return mgr._read_meta(step)
    finally:
        mgr.close()


def warn_on_config_mismatch(
    saved: Dict[str, Any], live: Dict[str, Any], logger=print
) -> None:
    """Phase/config mismatch warnings on resume (train.py:475-498)."""
    keys = set(saved) | set(live)
    for k in sorted(keys):
        if saved.get(k) != live.get(k):
            logger(
                f"WARNING: config mismatch on resume: {k!r} "
                f"checkpoint={saved.get(k)!r} current={live.get(k)!r}"
            )
