"""Model assembly: params init, full-seq forward, loss, cached decode step.

The counterpart of ``repro/models/model.py`` for the dense attention
families (``mixer == "attn"`` without experts: qwen3, codeqwen, minitron,
olmo, musicgen's and paligemma's backbones with their prefix stubs).  MoE
layers, the recurrent mixers and the hybrid's shared block are not ported
yet (ROADMAP.md Queue 1 item 12b) and raise.

The parameter tree is the reference's, so a checkpoint written by either
package has the same leaves: ``embed`` (V, D), ``blocks`` with a leading
layer axis (``ln1``, ``attn`` {wq, wk, wv, wo[, q_norm, k_norm]}, ``ln2``,
``mlp`` {w_up, w_down[, w_gate]}), ``ln_f`` and, unless tied, ``lm_head``
(D, V).  The layer loop indexes the stacked leaves; ``remat=True`` wraps
each block in ``torch.utils.checkpoint`` where the reference uses
``jax.checkpoint``.  ``init_params`` draws from an explicit
``torch.Generator`` (the same shapes, dtypes and scales, not JAX's bits);
``params_from_numpy`` carries the reference's own parameters across.

Entry points take ``device=`` (default ``"cuda"``) and raise without a
card; nothing falls back to the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import resolve_device
from repro_torch.core.tree import map_tree
from repro_torch.distributed import sharding
from repro_torch.models import attention, layers

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

_LATER = ("is not ported yet (ROADMAP.md Queue 1 item 12b): the port's "
          "model covers mixer='attn' without experts")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a family this model does not cover yet."""
    if cfg.is_moe:
        raise NotImplementedError(f"MoE ({cfg.name}) {_LATER}")
    if cfg.mixer != "attn":
        raise NotImplementedError(f"mixer {cfg.mixer!r} ({cfg.name}) {_LATER}")
    if cfg.attn_every:
        raise NotImplementedError(f"the shared attention block ({cfg.name}) "
                                  f"{_LATER}")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                device="cuda") -> Dict[str, Any]:
    """Random parameters in the reference's tree, shapes, dtypes and scales,
    drawn from ``generator`` (on its own device) and placed on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    g = generator
    params: Dict[str, Any] = {
        "embed": layers.init_embed(g, cfg.vocab, d, dt, dev),
        "blocks": {
            "ln1": _stacked_norm(cfg, dt, dev),
            "attn": attention.init_attn(g, d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                        cfg.qk_norm, dt, dev, L),
            "ln2": _stacked_norm(cfg, dt, dev),
            "mlp": layers.init_mlp(g, d, f, cfg.act, dt, dev, layers=L),
        },
        "ln_f": layers.norm_params(cfg.norm, d, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.normal(g, (d, cfg.vocab), dt,
                                          float(1.0 / np.sqrt(d)), dev)
    return params


def _stacked_norm(cfg: ArchConfig, dt, dev) -> torch.Tensor:
    p = layers.norm_params(cfg.norm, cfg.d_model, dt, dev)
    return p.expand(cfg.n_layers, *p.shape).contiguous()


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        # bf16: an ml_dtypes array, or its 16-bit patterns (no tree carried
        # here holds uint16 values)
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays (the reference's parameters or AdamW state as
    ``np.asarray`` gives them; bf16 as ``ml_dtypes`` arrays or uint16 bit
    patterns) as the port's tree of tensors on ``device``: the same keys,
    shapes, dtypes and bits."""
    dev = resolve_device(device)
    return map_tree(lambda a: _leaf_from_numpy(a, dev), tree)


# --------------------------------------------------------------------------
# full-sequence forward (train / prefill)
# --------------------------------------------------------------------------


def _block_fwd(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    h = layers.apply_norm(cfg.norm, x, p["ln1"])
    x = x + attention.attention(
        p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        block_skip=cfg.block_skip)
    h = layers.apply_norm(cfg.norm, x, p["ln2"])
    return x + layers.mlp(p["mlp"], h, cfg.act)


def layer_params(blocks, i: int):
    """Layer ``i``'s leaves of the stacked ``blocks`` tree (views)."""
    return map_tree(lambda a: a[i], blocks)


def _layer_stack(cfg: ArchConfig, params, x: torch.Tensor,
                 remat: bool) -> torch.Tensor:
    check_supported(cfg)
    for i in range(cfg.n_layers):
        p_i = layer_params(params["blocks"], i)
        if remat:
            x = checkpoint(lambda x, p_i=p_i: _block_fwd(cfg, p_i, x), x,
                           use_reentrant=False)
        else:
            x = _block_fwd(cfg, p_i, x)
        x = sharding.constrain(x, "dp", None, None)
    return x


def embed_inputs(cfg: ArchConfig, params, tokens: torch.Tensor,
                 prefix_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = F.embedding(tokens, params["embed"])
    x = sharding.constrain(x, "dp", None, None)
    if cfg.n_prefix and prefix_emb is not None:
        x = torch.cat([prefix_emb.to(x.dtype), x], dim=1)
    return x


def head(cfg: ArchConfig, params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(cfg: ArchConfig, params, tokens: torch.Tensor,
            prefix_emb: Optional[torch.Tensor] = None,
            remat: bool = False) -> torch.Tensor:
    """tokens: (B, S) int -> logits (B, S(+prefix), vocab)."""
    x = embed_inputs(cfg, params, tokens, prefix_emb)
    x = _layer_stack(cfg, params, x, remat)
    x = layers.apply_norm(cfg.norm, x, params["ln_f"])
    return x @ head(cfg, params)


def loss_fn(cfg: ArchConfig, params, tokens, labels, prefix_emb=None,
            remat: bool = True, seq_chunk: int = 512) -> torch.Tensor:
    """Next-token cross entropy over sequence chunks, so the float32
    (B, S, vocab) softmax intermediate never materialises whole."""
    x = embed_inputs(cfg, params, tokens, prefix_emb)
    x = _layer_stack(cfg, params, x, remat)
    x = layers.apply_norm(cfg.norm, x, params["ln_f"])
    if cfg.n_prefix:
        x = x[:, cfg.n_prefix:]
    w = head(cfg, params)
    B, S, D = x.shape
    n_chunks = max(1, S // seq_chunk)
    if S % n_chunks:
        raise ValueError(f"sequence {S} does not split into {n_chunks} "
                         f"chunks of {seq_chunk}")
    c = S // n_chunks
    labels = labels.long()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        logits = (x[:, i * c:(i + 1) * c] @ w).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, i * c:(i + 1) * c, None])[..., 0]
        total = total + torch.sum(logz - gold)
    return total / (B * S)


# --------------------------------------------------------------------------
# cached decode
# --------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device="cuda") -> Dict[str, Any]:
    """The KV cache: ``k`` and ``v`` of (L, B, max_seq, n_kv, hd) and the
    next position ``pos`` (a Python int)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv, cfg.hd)
    return {"pos": 0,
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def decode_step(cfg: ArchConfig, params, cache: Dict[str, Any],
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  tokens: (B, 1) -> (logits (B, 1, vocab), cache).
    The cache's K/V rows at ``pos`` are written in place; the returned
    cache holds the same tensors and ``pos + 1``."""
    check_supported(cfg)
    pos = int(cache["pos"])
    x = F.embedding(tokens, params["embed"])
    x = sharding.constrain(x, "dp", None, None)
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        h = layers.apply_norm(cfg.norm, x, p["ln1"])
        o, _, _ = attention.decode_attention(
            p["attn"], h, cache["k"][i], cache["v"][i], pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
            qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta)
        x = x + o
        h = layers.apply_norm(cfg.norm, x, p["ln2"])
        x = x + layers.mlp(p["mlp"], h, cfg.act)
    x = layers.apply_norm(cfg.norm, x, params["ln_f"])
    logits = x @ head(cfg, params)
    return logits, dict(cache, pos=pos + 1)
