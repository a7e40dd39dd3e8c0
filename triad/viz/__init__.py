from triad.viz.heatmaps import (
    AudioVisualizer,
    TextVisualizer,
    denormalize_frame,
    overlay_heatmap,
    patches_to_heatmaps,
)

__all__ = [
    "AudioVisualizer",
    "TextVisualizer",
    "denormalize_frame",
    "overlay_heatmap",
    "patches_to_heatmaps",
]
