"""Driver-style regression tests for ``__graft_entry__``.

``_dryrun_body`` once lost its ``return loss`` when the TP-comparison
leg landed, and nothing ran ``dryrun_multichip`` the way a fresh
interpreter does, so the dryrun failed even though both legs printed
matching losses. These tests execute that exact subprocess command, so
that class of regression cannot ship silently again.

The dryrun self-bootstraps onto a virtual 8-device CPU mesh and uses the
persistent compile cache (``__graft_entry__._dryrun_cache_dir``), so a
warm rerun takes seconds; the first run compiles the full train step on
CPU (~minutes), hence the generous timeout.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_driver_style(entry: str) -> subprocess.CompletedProcess:
    """Invoke ``__graft_entry__.{entry}`` exactly as the driver does: a
    fresh interpreter, repo root on sys.path, inherited environment."""
    env = dict(os.environ)
    # The driver runs from the launch environment, not pytest's
    # conftest-pinned one; drop the conftest's 8-device XLA flag so the
    # entry's own self-bootstrap path (the one the driver exercises) is
    # what gets tested.
    flags = " ".join(
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "host_platform_device_count" not in f
    )
    if flags:
        env["XLA_FLAGS"] = flags
    else:
        env.pop("XLA_FLAGS", None)
    env.pop("TRIAD_DRYRUN_CHILD", None)
    code = f"import __graft_entry__; __graft_entry__.{entry}"
    return subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=env,
        text=True,
        capture_output=True,
        timeout=1700,
    )


def test_dryrun_multichip_8_driver_style():
    proc = _run_driver_style("dryrun_multichip(8)")
    assert proc.returncode == 0, (
        f"driver multichip check would be RED (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout}\n--- stderr ---\n{proc.stderr}"
    )
    # All four legs must have actually run and reported finite losses:
    # DP (ZeRO-1), dp x tp, ZeRO-1 + ring negatives, FSDP.
    assert "dryrun_multichip(8) OK" in proc.stdout, proc.stdout
    assert "dp x tp) OK" in proc.stdout, proc.stdout
    assert "zero1+ring) OK" in proc.stdout, proc.stdout
    assert "fsdp) OK" in proc.stdout, proc.stdout


def test_dryrun_body_returns_loss():
    """The dp-vs-tp assert needs ``_dryrun_body`` to return its loss —
    guard the exact one-line regression from round 2 without paying a
    subprocess for it."""
    import inspect

    sys.path.insert(0, REPO)
    try:
        import __graft_entry__
    finally:
        sys.path.remove(REPO)
    src = inspect.getsource(__graft_entry__._dryrun_body)
    assert "return loss" in src
