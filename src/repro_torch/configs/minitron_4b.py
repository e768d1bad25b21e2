"""minitron-4b — pruned nemotron [arXiv:2407.14679; hf]. squared-ReLU MLP."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv=8, d_ff=9216, vocab=256000,
    act="relu2", source="arXiv:2407.14679",
))
