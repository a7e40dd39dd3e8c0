"""triad — tri-modal dense grounding framework in JAX.

A from-scratch JAX/Pallas rebuild of the capabilities of SajayR/TRIAD:
DINOv2, HuBERT and
DistilBERT encoders projected into a shared 512-d token space, dense
patch x token similarity volumes with DenseAV-style max-mean aggregation,
temperature-scaled symmetric InfoNCE over (all-gathered) in-batch
negatives, a staged-unfreeze multi-group trainer with curriculum phases,
exact checkpoint/resume, 1000-way cross-modal retrieval, and dense
grounding heatmap visualization.

Layout:
  core/      typed configs, mesh/sharding setup, dtype policy, PRNG helpers
  models/    encoders (ViT-B/14+registers+LoRA, HuBERT, DistilBERT),
             projection heads, the combined TriadModel, HF weight porting
  ops/       loss math: similarity volumes, max-mean aggregation,
             regularizers, InfoNCE; the Pallas flash attention kernel
  parallel/  data-parallel train step over a jax.sharding.Mesh with
             all-gathered negatives
  data/      host-side pipeline: tokenizer, audio, image augmentation,
             datasets, prefetching fixed-shape batches
  train/     optimizers (4-group delayed OneCycle), jitted train steps,
             curriculum trainer, Orbax checkpointing
  eval/      vectorized 1000-way retrieval (R@1/5/10/20)
  viz/       grounding heatmaps / attention videos (host-side)
"""

__version__ = "0.1.0"
