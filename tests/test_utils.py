"""Debug/observability utility tests."""

import numpy as np
import jax.numpy as jnp

from triad.utils import (
    StepTimer,
    nonfinite_paths,
    skip_nonfinite_updates,
    tree_all_finite,
)


def test_tree_all_finite():
    good = {"a": jnp.ones(3), "b": {"c": jnp.zeros(2)}}
    assert bool(tree_all_finite(good))
    bad = {"a": jnp.ones(3), "b": {"c": jnp.array([1.0, np.nan])}}
    assert not bool(tree_all_finite(bad))


def test_nonfinite_paths():
    bad = {"a": jnp.ones(3), "b": {"c": jnp.array([np.inf, 1.0])}}
    assert nonfinite_paths(bad) == ["b/c"]


def test_skip_nonfinite_updates():
    updates = {"w": jnp.array([1.0, np.nan])}
    gated, ok = skip_nonfinite_updates(updates)
    assert not bool(ok)
    np.testing.assert_array_equal(np.asarray(gated["w"]), [0.0, 0.0])
    updates = {"w": jnp.array([1.0, 2.0])}
    gated, ok = skip_nonfinite_updates(updates)
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(gated["w"]), [1.0, 2.0])


def test_step_timer():
    t = StepTimer(window=4)
    t.tick()
    t.tick()
    m = t.metrics(clips_per_step=8)
    assert "step_time_ms" in m and m["clips_per_sec"] > 0
