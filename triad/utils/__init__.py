from triad.utils.debug import (
    enable_nan_debugging,
    nonfinite_paths,
    skip_nonfinite_updates,
    tree_all_finite,
)
from triad.utils.logging import MetricsLogger
from triad.utils.profiling import StepTimer, profile_trace

__all__ = [
    "MetricsLogger",
    "StepTimer",
    "enable_nan_debugging",
    "nonfinite_paths",
    "profile_trace",
    "skip_nonfinite_updates",
    "tree_all_finite",
]
