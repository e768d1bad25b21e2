"""ArchConfig + input-shape registry for the 10 assigned architectures
(a copy of ``repro.configs.base``, pinned to it by the tests)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

_REGISTRY: Dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    qk_norm: bool = False
    norm: str = "rmsnorm"      # rmsnorm | ln_nonparam
    act: str = "swiglu"        # swiglu | gelu | relu2
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # attention schedule: skip fully-future KV blocks (beyond-paper perf)
    block_skip: bool = True
    # MoE decode-mode global dispatch (G=1) — §Perf hillclimb 2
    moe_decode_global: bool = True
    # chunkwise-parallel SSD chunk length (0 = per-step scan) — hillclimb 3
    ssd_chunk: int = 0
    # recurrent mixers
    mixer: str = "attn"        # attn | rwkv6 | mamba2
    ssm_state: int = 0
    attn_every: int = 0        # hybrid: shared attn block every k layers
    # modality frontend stub (audio/vlm): prefix embeddings via input_specs()
    n_prefix: int = 0
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is feasible (SSM/hybrid)."""
        return self.mixer in ("rwkv6", "mamba2")

    def param_count(self) -> int:
        """Total parameters (embeddings + blocks + head)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.mixer == "rwkv6":
            mix = 6 * d * d + 2 * d          # r,k,v,g,o,decay (+ channel-mix in d_ff)
            ffn = 3 * d * f
            block = mix + ffn
        elif self.mixer == "mamba2":
            di = 2 * d
            block = d * (2 * di + 2 * self.ssm_state + di // 64) + di * d
            if self.attn_every:
                # one shared transformer block (attn + mlp), counted once
                shared = (2 * d * self.n_heads * self.hd
                          + 2 * d * self.n_kv * self.hd + 3 * d * f)
                emb += shared
        else:
            attn = d * self.hd * (self.n_heads * 2) + d * self.hd * self.n_kv * 2
            nglu = 3 if self.act == "swiglu" else 2
            if self.is_moe:
                ffn = (self.n_experts * 3 * d * f
                       + d * self.n_experts
                       + self.n_shared_experts * nglu * d * f)
            else:
                ffn = nglu * d * f
            block = attn + ffn
        return emb + L * block

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        total = self.param_count()
        all_experts = L * self.n_experts * 3 * d * f
        active = L * self.top_k * 3 * d * f
        return total - all_experts + active


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    return _REGISTRY[name]


def list_archs():
    return sorted(_REGISTRY)


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) — long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k-context decode skipped (DESIGN.md §4)"
    return True, ""


def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 128,
            vocab: int = 512, d_ff: Optional[int] = None,
            n_experts: Optional[int] = None) -> ArchConfig:
    """Smoke-test config of the same family (small widths, few experts)."""
    hd = 32
    n_heads = max(2, d_model // hd)
    ratio = max(1, cfg.n_heads // max(1, cfg.n_kv))
    n_kv = max(1, n_heads // ratio)
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv=n_kv,
        head_dim=hd,
        d_ff=d_ff if d_ff is not None else d_model * 3,
        vocab=vocab,
        n_experts=(n_experts if n_experts is not None
                   else (8 if cfg.is_moe else 0)),
        top_k=min(cfg.top_k, 2) if cfg.is_moe else 0,
        # dropless at smoke scale so decode == forward exactly
        capacity_factor=4.0 if cfg.is_moe else cfg.capacity_factor,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        n_prefix=min(cfg.n_prefix, 8) if cfg.n_prefix else 0,
        dtype="float32",
    )
