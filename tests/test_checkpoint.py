"""Checkpoint manager tests: latest/best, metadata roundtrip, config
mismatch warnings (reference train.py:382-525 semantics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from triad.train.checkpoint import (
    CheckpointManager,
    HostProgress,
    warn_on_config_mismatch,
)


@pytest.fixture
def state():
    return {
        "params": {"w": jnp.arange(4.0), "temperature": jnp.asarray(1.5)},
        "step": jnp.asarray(3),
    }


def test_save_restore_latest(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path))
    prog = HostProgress(epoch=1, global_step=10, current_batch_idx=2,
                        dataset_segment=5, best_loss=3.5)
    mgr.save(10, state, prog, {"a": 1}, extra={"note": "x"})
    assert mgr.latest_step() == 10
    restored, p2, cfg, extra = mgr.restore(state)
    np.testing.assert_array_equal(
        np.asarray(restored["params"]["w"]), np.asarray(state["params"]["w"])
    )
    assert p2.epoch == 1 and p2.current_batch_idx == 2 and p2.dataset_segment == 5
    assert cfg == {"a": 1} and extra == {"note": "x"}


def test_best_kept_separately(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    prog = HostProgress(global_step=1, best_loss=5.0)
    mgr.save(1, state, prog, {}, is_best=True)
    # later (worse) checkpoints must not clobber best
    state2 = jax.tree.map(lambda x: x + 1, state)
    mgr.save(2, state2, HostProgress(global_step=2), {})
    mgr.save(3, state2, HostProgress(global_step=3), {})
    best, bp, _ = mgr.restore_best(state)
    np.testing.assert_array_equal(
        np.asarray(best["params"]["w"]), np.asarray(state["params"]["w"])
    )
    assert bp.best_loss == 5.0


def test_max_to_keep_gc(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, state, HostProgress(global_step=s), {})
    assert mgr.latest_step() == 3
    with pytest.raises(Exception):
        mgr.restore(state, step=1)  # garbage-collected


def test_config_mismatch_warning():
    msgs = []
    warn_on_config_mismatch({"a": 1, "b": 2}, {"a": 1, "b": 3, "c": 4},
                            logger=msgs.append)
    joined = " ".join(msgs)
    assert "'b'" in joined and "'c'" in joined and "'a'" not in joined


def test_async_save_then_restore(tmp_path, state):
    """async_save: save returns early; restore drains the in-flight
    write and gets the same state + meta (one atomic Composite save)."""
    mgr = CheckpointManager(str(tmp_path / "async"), async_save=True)
    prog = HostProgress(epoch=1, global_step=7, current_batch_idx=3)
    mgr.save(7, state, prog, {"train": {"seed": 1}}, extra={"k": "v"})
    restored, p2, cfg, extra = mgr.restore(state)
    assert p2.global_step == 7 and p2.current_batch_idx == 3
    assert cfg == {"train": {"seed": 1}} and extra == {"k": "v"}
    for a, b in zip(
        jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(restored)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    mgr.close()


def test_read_run_meta(tmp_path, state):
    from triad.train.checkpoint import read_run_meta

    run = tmp_path / "run"
    mgr = CheckpointManager(str(run / "checkpoints"))
    mgr.save(3, state, HostProgress(global_step=3), {"train": {"seed": 9}})
    mgr.close()
    meta = read_run_meta(str(run))
    assert meta["config"]["train"]["seed"] == 9
    assert meta["progress"]["global_step"] == 3
