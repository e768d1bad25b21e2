"""Architecture configs: one module per assigned arch + registry.

A copy of ``repro.configs`` (which the port may not import):
``tests/test_torch_models.py`` pins every field of every registered config
to the reference's.
"""
from repro_torch.configs.base import (ArchConfig, ShapeSpec, SHAPES, get_arch,
                                      list_archs, register, reduced)
from repro_torch.configs import (rwkv6_1b6, codeqwen15_7b, minitron_4b,
                                 qwen3_1b7, olmo_1b, musicgen_medium,
                                 qwen3_moe_235b, kimi_k2_1t, paligemma_3b,
                                 zamba2_2b7)  # noqa: F401
