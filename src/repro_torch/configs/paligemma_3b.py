"""paligemma-3b — SigLIP + gemma backbone [arXiv:2407.07726; hf].

Backbone only: the SigLIP vision tower is a STUB — input_specs() feeds
precomputed patch embeddings (n_prefix=256 patches) prefixed to the tokens.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, d_ff=16384, vocab=257216,
    head_dim=256, act="gelu", n_prefix=256, source="arXiv:2407.07726",
))
