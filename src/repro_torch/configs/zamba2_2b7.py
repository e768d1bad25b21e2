"""zamba2-2.7b — Mamba2 backbone + shared attention block [arXiv:2411.15242; hf].

54 Mamba2 (SSD) blocks; ONE shared transformer block (attn kv=32 + MLP)
applied every 6 layers (weights reused each application, Zamba-style).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv=32, d_ff=10240, vocab=32000,
    head_dim=80, mixer="mamba2", ssm_state=64, attn_every=6,
    source="arXiv:2411.15242",
))
