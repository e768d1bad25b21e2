"""qwen3-1.7b — qk_norm + GQA [hf:Qwen/Qwen3-8B family; hf]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv=8, d_ff=6144, vocab=151936,
    qk_norm=True, head_dim=128, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-1.7B",
))
