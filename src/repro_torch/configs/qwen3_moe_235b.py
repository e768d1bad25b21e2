"""qwen3-moe-235b-a22b — 128 experts top-8 [hf:Qwen/Qwen3-235B-A22B; hf]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv=4, d_ff=1536, vocab=151936,
    head_dim=128, qk_norm=True, n_experts=128, top_k=8,
    rope_theta=1_000_000.0, source="hf:Qwen/Qwen3-235B-A22B",
))
