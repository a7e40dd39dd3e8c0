from triad.core.config import (
    Config,
    DataConfig,
    DistilBertConfig,
    HubertConfig,
    LossConfig,
    MeshConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
    ViTConfig,
)

__all__ = [
    "Config",
    "DataConfig",
    "DistilBertConfig",
    "HubertConfig",
    "LossConfig",
    "MeshConfig",
    "ModelConfig",
    "OptimConfig",
    "TrainConfig",
    "ViTConfig",
]
