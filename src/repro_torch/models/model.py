"""Model assembly: params init, full-seq forward, loss, cached decode step.

The counterpart of ``repro/models/model.py`` for the ten registered
architectures:

  * dense GQA transformers (qwen3, codeqwen, minitron, olmo, and the
    backbones of musicgen and paligemma with their prefix stubs);
  * MoE transformers (qwen3-moe, kimi-k2: token-choice top-k with an
    optional shared expert, ``models/moe.py``);
  * RWKV6 (attention-free: the wkv mixer and the token-shift channel mix,
    ``models/ssm.py``);
  * the Mamba2 hybrid (zamba2: SSD blocks and ONE shared attention + MLP
    block applied after every ``attn_every``-th layer, its weights reused).

The parameter tree is the reference's, so a checkpoint written by either
package has the same leaves: ``embed`` (V, D), ``blocks`` with a leading
layer axis (``ln1`` and, by family, ``attn`` {wq, wk, wv, wo[, q_norm,
k_norm]} + ``ln2`` + ``mlp`` or ``moe``; ``rwkv`` + ``ln2`` + ``cmix``;
``mamba``), ``ln_f``, ``lm_head`` unless tied, and the unstacked
``shared_block`` of a hybrid.  The layer loop indexes the stacked leaves;
``remat=True`` wraps each block in ``torch.utils.checkpoint`` where the
reference uses ``jax.checkpoint``.  The reference's ``unroll=True`` probe
path has no counterpart: the port's layer and chunk loops are Python loops
already.  ``init_params`` draws from an explicit ``torch.Generator`` (the
same shapes, dtypes and scales, not JAX's bits); ``params_from_numpy``
carries the reference's own parameters across.

Entry points take ``device=`` (default ``"cuda"``) and raise without a
card; nothing falls back to the CPU.

In a mesh member's program (``distributed.spmd``, ``launch.steps.
member_step``) the same functions take the member's blocks of the leaves
``sharding.param_specs`` splits over ``model`` and compute its share, as
the reference's program computes each device's under its specs and
activation constraints: the embedding's columns looked up and gathered,
each block's heads, hidden units, experts or channels (``layers``,
``attention``, ``moe``, ``ssm``), and the head: ``lm_head``'s vocabulary
block, whose loss is the vocab-parallel cross entropy (an all-reduce of
the maximum, the sum of exponentials and the target logit, in the same
chunks), and whose prefill and decode logits are all-gathered whole; or,
tied, the embedding's columns, whose partial logits are all-reduced.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import resolve_device
from repro_torch.core.tree import map_tree
from repro_torch.distributed import sharding, spmd
from repro_torch.models import attention, layers, moe, ssm

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _init_blocks(cfg: ArchConfig, g: torch.Generator, dt, dev
                 ) -> Dict[str, Any]:
    """Every block's parameters, stacked on a leading layer axis."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    p: Dict[str, Any] = {"ln1": _stacked_norm(cfg, dt, dev)}
    if cfg.mixer == "attn":
        p["attn"] = attention.init_attn(g, d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                        cfg.qk_norm, dt, dev, L)
        p["ln2"] = _stacked_norm(cfg, dt, dev)
        if cfg.is_moe:
            p["moe"] = moe.init_moe(g, d, f, cfg.n_experts,
                                    cfg.n_shared_experts, cfg.act, dt, dev,
                                    n_layers=L)
        else:
            p["mlp"] = layers.init_mlp(g, d, f, cfg.act, dt, dev, layers=L)
    elif cfg.mixer == "rwkv6":
        p["rwkv"] = ssm.init_rwkv6(g, d, cfg.n_heads, dt, dev, n_layers=L)
        p["ln2"] = _stacked_norm(cfg, dt, dev)
        p["cmix"] = ssm.init_rwkv6_channel_mix(g, d, f, dt, dev, n_layers=L)
    elif cfg.mixer == "mamba2":
        p["mamba"] = ssm.init_mamba2(g, d, head_dim=cfg.hd,
                                     ssm_state=cfg.ssm_state, dtype=dt,
                                     device=dev, n_layers=L)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator, *,
                device="cuda") -> Dict[str, Any]:
    """Random parameters in the reference's tree, shapes, dtypes and scales,
    drawn from ``generator`` (on its own device) and placed on ``device``."""
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]
    d = cfg.d_model
    g = generator
    params: Dict[str, Any] = {
        "embed": layers.init_embed(g, cfg.vocab, d, dt, dev),
        "blocks": _init_blocks(cfg, g, dt, dev),
        "ln_f": layers.norm_params(cfg.norm, d, dt, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.normal(g, (d, cfg.vocab), dt,
                                          float(1.0 / np.sqrt(d)), dev)
    if cfg.attn_every:      # the hybrid's one shared transformer block
        params["shared_block"] = {
            "ln1": layers.norm_params(cfg.norm, d, dt, dev),
            "attn": attention.init_attn(g, d, cfg.n_heads, cfg.n_kv, cfg.hd,
                                        cfg.qk_norm, dt, dev),
            "ln2": layers.norm_params(cfg.norm, d, dt, dev),
            "mlp": layers.init_mlp(g, d, cfg.d_ff, "swiglu", dt, dev),
        }
    return params


def abstract_params(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree's shapes and dtypes as ``meta`` tensors, with
    nothing allocated or drawn (the reference's ``jax.eval_shape`` of
    ``init_params``): what the sharding specs read of a full-width model."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = init_params(cfg, torch.Generator(), device="cpu")
    return map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), fake)


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


def _shared_fwd(cfg: ArchConfig, sb, x: torch.Tensor) -> torch.Tensor:
    """The hybrid's shared attention + SwiGLU block (no qk-norm, as the
    reference applies it)."""
    h = layers.apply_norm(cfg.norm, x, sb["ln1"])
    x = x + attention.attention(
        sb["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, block_skip=cfg.block_skip)
    h = layers.apply_norm(cfg.norm, x, sb["ln2"])
    return x + layers.mlp(sb["mlp"], h, "swiglu", cfg.d_ff)


def _block_fwd(cfg: ArchConfig, p, x: torch.Tensor, shared,
               layer_idx: int) -> torch.Tensor:
    h = layers.apply_norm(cfg.norm, x, p["ln1"])
    if cfg.mixer == "attn":
        x = x + attention.attention(
            p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.hd, qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
            block_skip=cfg.block_skip)
        h = layers.apply_norm(cfg.norm, x, p["ln2"])
        if cfg.is_moe:
            return x + moe.moe_ffn(
                p["moe"], h, n_experts=cfg.n_experts, top_k=cfg.top_k,
                capacity_factor=cfg.capacity_factor, act=cfg.act,
                shared_ff=cfg.d_ff * cfg.n_shared_experts)
        return x + layers.mlp(p["mlp"], h, cfg.act, cfg.d_ff)
    if cfg.mixer == "rwkv6":
        o, _ = ssm.rwkv6_mix(p["rwkv"], h, n_heads=cfg.n_heads)
        x = x + o
        h = layers.apply_norm(cfg.norm, x, p["ln2"])
        return x + ssm.rwkv6_channel_mix(p["cmix"], h, d_ff=cfg.d_ff)
    o, _ = ssm.mamba2_mix(p["mamba"], h, head_dim=cfg.hd,
                          ssm_state=cfg.ssm_state, ssd_chunk=cfg.ssd_chunk)
    x = x + o
    if cfg.attn_every and (layer_idx + 1) % cfg.attn_every == 0:
        x = _shared_fwd(cfg, shared, x)
    return x


def layer_params(blocks, i: int):
    """Layer ``i``'s leaves of the stacked ``blocks`` tree (views)."""
    return map_tree(lambda a: a[i], blocks)


def _layer_stack(cfg: ArchConfig, params, x: torch.Tensor,
                 remat: bool) -> torch.Tensor:
    shared = params.get("shared_block")
    # one unbind a stacked leaf: its backward stacks the layers' gradients
    # once, where indexing each layer apart would add a zero-filled
    # gradient of the whole stack a layer (traffic quadratic in depth)
    per_layer = map_tree(torch.unbind, params["blocks"])
    for i in range(cfg.n_layers):
        p_i = map_tree(lambda layers, i=i: layers[i], per_layer)
        if remat:
            x = checkpoint(
                lambda x, p_i=p_i, i=i: _block_fwd(cfg, p_i, x, shared, i),
                x, use_reentrant=False)
        else:
            x = _block_fwd(cfg, p_i, x, shared, i)
        x = sharding.constrain(x, "dp", None, None)
    return x


def embed_inputs(cfg: ArchConfig, params, tokens: torch.Tensor,
                 prefix_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = layers.embed_lookup(tokens, params["embed"], cfg.d_model)
    x = sharding.constrain(x, "dp", None, None)
    if cfg.n_prefix and prefix_emb is not None:
        x = torch.cat([prefix_emb.to(x.dtype), x], dim=1)
    return x


def head(cfg: ArchConfig, params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _vocab_split(cfg: ArchConfig, w: torch.Tensor) -> bool:
    """Whether the head ``w`` is a member's block of the vocabulary."""
    return not cfg.tie_embeddings and w.shape[-1] != cfg.vocab


def logits(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    """``x @ head`` over the whole vocabulary; a member's vocabulary block
    is all-gathered, a member's tied columns all-reduced."""
    w = head(cfg, params)
    if _vocab_split(cfg, w):
        return spmd.gather_from(spmd.copy_to(x) @ w, -1)
    if w.shape[0] != cfg.d_model:               # tied, D over model
        cols = spmd.block(cfg.d_model)
        return spmd.reduce_from(spmd.copy_to(x)[..., cols] @ w)
    return x @ w


def forward(cfg: ArchConfig, params, tokens: torch.Tensor,
            prefix_emb: Optional[torch.Tensor] = None,
            remat: bool = False) -> torch.Tensor:
    """tokens: (B, S) int -> logits (B, S(+prefix), vocab)."""
    x = embed_inputs(cfg, params, tokens, prefix_emb)
    x = _layer_stack(cfg, params, x, remat)
    x = layers.apply_norm(cfg.norm, x, params["ln_f"])
    return logits(cfg, params, x)


def _vocab_parallel_xent(x, w, labels, vocab: int) -> torch.Tensor:
    """The summed cross entropy of one chunk against a member's vocabulary
    block ``w``: the maximum, the sum of exponentials and the target logit
    all-reduced over ``model``."""
    lg = (spmd.copy_to(x) @ w).float()
    m = spmd.all_max(torch.amax(lg, dim=-1))
    se = spmd.reduce_from(torch.sum(torch.exp(lg - m[..., None]), dim=-1))
    logz = m + torch.log(se)
    blk = spmd.block(vocab)
    local = labels - blk.start
    mine = (local >= 0) & (local < w.shape[-1])
    gold = torch.gather(lg, -1, torch.where(mine, local, 0)[..., None])
    gold = spmd.reduce_from(torch.where(mine, gold[..., 0], 0.0))
    return torch.sum(logz - gold)


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
    split = _vocab_split(cfg, w)
    B, S, D = x.shape
    n_chunks = max(1, S // seq_chunk)
    if S % n_chunks:
        raise ValueError(f"sequence {S} does not split into {n_chunks} "
                         f"chunks of {seq_chunk}")
    c = S // n_chunks
    labels = labels.long()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        xi, li = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if split:
            total = total + _vocab_parallel_xent(xi, w, li, cfg.vocab)
            continue
        lg = logits(cfg, params, xi).float()
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, li[..., None])[..., 0]
        total = total + torch.sum(logz - gold)
    return total / (B * S)


# --------------------------------------------------------------------------
# cached decode
# --------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device="cuda") -> Dict[str, Any]:
    """The decode cache, as the reference builds it, and the next position
    ``pos`` (a Python int): K/V of (L, B, max_seq, n_kv, hd) for attention;
    ``wkv`` (L, B, H, hd, hd) float32 and the token-shift rows ``x_att`` /
    ``x_ffn`` (L, B, D) for RWKV6; ``ssm`` (L, B, H, hd, N) float32 and
    ``conv`` (L, B, CONV_K - 1, 2D) for Mamba2, plus K/V for each of the
    shared block's ``n_layers // attn_every`` applications."""
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]
    L, d = cfg.n_layers, cfg.d_model

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv(n):
        return {"k": zeros((n, batch, max_seq, cfg.n_kv, cfg.hd)),
                "v": zeros((n, batch, max_seq, cfg.n_kv, cfg.hd))}

    cache: Dict[str, Any] = {"pos": 0}
    if cfg.mixer == "attn":
        cache.update(kv(L))
    elif cfg.mixer == "rwkv6":
        H, hd = cfg.n_heads, d // cfg.n_heads
        cache["wkv"] = zeros((L, batch, H, hd, hd), torch.float32)
        cache["x_att"] = zeros((L, batch, d))
        cache["x_ffn"] = zeros((L, batch, d))
    elif cfg.mixer == "mamba2":
        di = 2 * d
        H = di // cfg.hd
        cache["ssm"] = zeros((L, batch, H, cfg.hd, cfg.ssm_state),
                             torch.float32)
        cache["conv"] = zeros((L, batch, ssm.CONV_K - 1, di))
        if cfg.attn_every:
            cache.update(kv(cfg.n_layers // cfg.attn_every))
    return cache


def decode_step(cfg: ArchConfig, params, cache: Dict[str, Any],
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  tokens: (B, 1) -> (logits (B, 1, vocab), cache).
    The cache's tensors are written in place (K/V rows at ``pos``, the
    recurrent states whole); the returned cache holds the same tensors and
    ``pos + 1``."""
    pos = int(cache["pos"])
    x = layers.embed_lookup(tokens, params["embed"], cfg.d_model)
    x = sharding.constrain(x, "dp", None, None)
    shared = params.get("shared_block")
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        h = layers.apply_norm(cfg.norm, x, p["ln1"])
        if cfg.mixer == "attn":
            o, _, _ = attention.decode_attention(
                p["attn"], h, cache["k"][i], cache["v"][i], pos,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
                qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta)
            x = x + o
            h = layers.apply_norm(cfg.norm, x, p["ln2"])
            if cfg.is_moe:
                x = x + moe.moe_ffn(
                    p["moe"], h, n_experts=cfg.n_experts, top_k=cfg.top_k,
                    capacity_factor=cfg.capacity_factor, act=cfg.act,
                    decode_global=cfg.moe_decode_global,
                    shared_ff=cfg.d_ff * cfg.n_shared_experts)
            else:
                x = x + layers.mlp(p["mlp"], h, cfg.act, cfg.d_ff)
        elif cfg.mixer == "rwkv6":
            o, (wkv, xa) = ssm.rwkv6_mix(
                p["rwkv"], h, n_heads=cfg.n_heads,
                state=(cache["wkv"][i], cache["x_att"][i]))
            cache["wkv"][i].copy_(wkv)
            cache["x_att"][i].copy_(xa)
            x = x + o
            h = layers.apply_norm(cfg.norm, x, p["ln2"])
            o, xf = ssm.rwkv6_channel_mix(p["cmix"], h,
                                          x_last=cache["x_ffn"][i],
                                          d_ff=cfg.d_ff)
            cache["x_ffn"][i].copy_(xf)
            x = x + o
        else:
            o, (hst, cst) = ssm.mamba2_mix(
                p["mamba"], h, head_dim=cfg.hd, ssm_state=cfg.ssm_state,
                state=(cache["ssm"][i], cache["conv"][i]))
            cache["ssm"][i].copy_(hst)
            cache["conv"][i].copy_(cst)
            x = x + o
            if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
                app = i // cfg.attn_every
                h = layers.apply_norm(cfg.norm, x, shared["ln1"])
                o, _, _ = attention.decode_attention(
                    shared["attn"], h, cache["k"][app], cache["v"][app], pos,
                    n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
                    rope_theta=cfg.rope_theta)
                x = x + o
                h = layers.apply_norm(cfg.norm, x, shared["ln2"])
                x = x + layers.mlp(shared["mlp"], h, "swiglu", cfg.d_ff)
    x = layers.apply_norm(cfg.norm, x, params["ln_f"])
    return logits(cfg, params, x), dict(cache, pos=pos + 1)
