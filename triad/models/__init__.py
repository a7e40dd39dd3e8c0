from triad.models.distilbert import DistilBertModel
from triad.models.hubert import HubertModel, normalize_waveform
from triad.models.layers import LoRADense, Mlp, ProjectionHead
from triad.models.multimodal import TriadModel, init_triad_model
from triad.models.vit import DinoViT

__all__ = [
    "DinoViT",
    "DistilBertModel",
    "HubertModel",
    "LoRADense",
    "Mlp",
    "ProjectionHead",
    "TriadModel",
    "init_triad_model",
    "normalize_waveform",
]
