"""rwkv6-1.6b — Finch, data-dependent decay [arXiv:2404.05892; unverified]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv=32, d_ff=7168, vocab=65536,
    head_dim=64, mixer="rwkv6", act="relu2",  # rwkv channel-mix uses relu^2
    source="arXiv:2404.05892",
))
