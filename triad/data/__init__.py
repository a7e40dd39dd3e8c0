from triad.data.audio import extract_audio, pad_or_trim, resample
from triad.data.packed import PackedAVDataset, pack_dataset
from triad.data.datasets import (
    AudioVisualDataset,
    FlatAudioVisualDataset,
    LocalCaptionDataset,
    SyntheticAVDataset,
    SyntheticTVDataset,
)
from triad.data.images import (
    augment_av_frame,
    augment_tv_image,
    clean_image,
    imagenet_normalize,
    load_image,
    resize_bilinear,
)
from triad.data.pipeline import AVLoader, Prefetcher, TVLoader, cycling
from triad.data.tokenizer import WordPieceTokenizer
from triad.data.video import load_video_frame

__all__ = [
    "AVLoader",
    "AudioVisualDataset",
    "PackedAVDataset",
    "pack_dataset",
    "FlatAudioVisualDataset",
    "LocalCaptionDataset",
    "Prefetcher",
    "SyntheticAVDataset",
    "SyntheticTVDataset",
    "TVLoader",
    "WordPieceTokenizer",
    "augment_av_frame",
    "augment_tv_image",
    "clean_image",
    "cycling",
    "extract_audio",
    "imagenet_normalize",
    "load_image",
    "load_video_frame",
    "pad_or_trim",
    "resample",
    "resize_bilinear",
]
