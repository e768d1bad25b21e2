"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only: the EnCodec frontend is a STUB — input_specs() feeds
precomputed frame embeddings as a prefix (n_prefix frames) alongside the
token stream over the 2048-entry codebook vocabulary.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv=24, d_ff=6144, vocab=2048,
    act="gelu", n_prefix=64, source="arXiv:2306.05284",
))
