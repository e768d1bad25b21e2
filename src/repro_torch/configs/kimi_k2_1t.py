"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 + 1 shared
[arXiv:2501.kimi2; unverified, paper-table arch].

Deviation note (DESIGN.md §4): the spec table gives GQA kv=8 (not MLA) and
we make every layer MoE (the real model keeps the first layer dense).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv=8, d_ff=2048, vocab=163840,
    head_dim=112, n_experts=384, top_k=8, n_shared_experts=1,
    source="arXiv:2501.kimi2",
))
