"""codeqwen1.5-7b — qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B; hf]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=32, d_ff=13440, vocab=92416,
    rope_theta=1_000_000.0, source="hf:Qwen/CodeQwen1.5-7B",
))
