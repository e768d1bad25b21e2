"""GQA attention: chunked causal attention for train/prefill, cached decode.

The counterpart of ``repro/models/attention.py``, in plain PyTorch ops (the
reference's attention is plain ``jnp`` too, not a Pallas kernel).  It
computes what the reference computes, in the same precision:

  * ``attention``: queries scaled in float32, scores and an online softmax
    in float32 over KV chunks of ``KV_CHUNK`` (``_attend_chunk``), queries
    in chunks of ``Q_CHUNK``, KV chunks wholly in the future of a query
    chunk skipped (``block_skip``); the output cast to the input's dtype
    before ``wo``.  Chunks run in a Python loop, so the skip saves the work,
    as the reference's ``unroll=True`` path does; the ``(S, S)`` score
    matrix never materialises past one chunk.
  * ``decode_attention``: one token against the whole cache, scores in
    float32, masked beyond ``pos``; the new K/V row written into the cache
    in place (the reference returns updated copies).

GQA maps query head ``h`` to KV head ``h // (n_heads // n_kv)`` in both, as
``jnp.repeat`` and the decode reshape do.  ``scaled_dot_product_attention``
is not used: it would change where the softmax rounds.

In a mesh member's program (``distributed.spmd``), where ``wq`` is the
member's block of columns (the reference's spec splits ``wq``, ``wk``,
``wv`` by columns and ``wo`` by rows over ``model``), the member computes
the query heads its block of the inner dimension touches, and the KV
heads they read (:func:`_member_heads`).  A block that cuts a head (a KV
head split across members where ``n_kv`` is smaller than ``model``, as
qwen3-1.7B's at 16 members) is projected on the member's own columns and
all-gathered; its output rows meet the member's rows of ``wo`` and the
partial sums are all-reduced.  Decode against a cache whose heads are over
``model`` attends to the member's heads; against one whose sequence is
over ``model`` (``sharding.cache_spec``, where ``n_kv`` does not divide)
each member takes every head over its positions and the members' partial
softmaxes are combined in float32: an all-reduce of the maximum, then of
the sums (the reference's online softmax, ``_attend_chunk``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import spmd
from repro_torch.models import layers

KV_CHUNK = 1024
Q_CHUNK = 2048

NEG_INF = -1e30


def _divisor_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target."""
    d = min(n, target)
    while n % d:
        d -= 1
    return d


def init_attn(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
              head_dim: int, qk_norm: bool, dtype: torch.dtype, device,
              n_layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One attention block's parameters, ``n_layers`` stacked on a leading
    axis (None: one block, unstacked)."""
    L = () if n_layers is None else (n_layers,)
    s = float(1.0 / np.sqrt(d))
    p = {
        "wq": layers.normal(gen, L + (d, n_heads * head_dim), dtype, s,
                            device),
        "wk": layers.normal(gen, L + (d, n_kv * head_dim), dtype, s, device),
        "wv": layers.normal(gen, L + (d, n_kv * head_dim), dtype, s, device),
        "wo": layers.normal(gen, L + (n_heads * head_dim, d), dtype,
                            float(1.0 / np.sqrt(n_heads * head_dim)), device),
    }
    if qk_norm:
        p["q_norm"] = torch.ones(L + (head_dim,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones(L + (head_dim,), dtype=dtype, device=device)
    return p


def _project_qkv(p, x, n_heads, n_kv, head_dim, qk_norm, positions,
                 rope_theta):
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, S, n_kv, head_dim)
    v = (x @ p["wv"]).reshape(B, S, n_kv, head_dim)
    if qk_norm:
        q = layers.rmsnorm(q, p["q_norm"])
        k = layers.rmsnorm(k, p["k_norm"])
    q = layers.apply_rope(q, positions, rope_theta)
    k = layers.apply_rope(k, positions, rope_theta)
    return q, k, v


def _attend_chunk(carry, q32, kci, vci, kv_pos, q_pos, causal):
    """One (q-chunk, kv-chunk) online-softmax update."""
    m, l, acc = carry
    s = torch.einsum("bhqd,bhkd->bhqk", q32, kci.float())
    if causal:
        mask = q_pos[:, None] >= kv_pos[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p_ = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p_, dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p_, vci.float())
    return m_new, l_new, acc_new


def _flash_qchunk(q, k, v, q_start: int, causal: bool, block_skip: bool):
    """Online softmax over KV chunks for one Q chunk.  q: (B, H, Sq, hd);
    k/v: (B, H, Skv, hd), GQA-expanded; ``q_start`` the absolute position
    of q[0]."""
    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    kv_chunk = _divisor_chunk(Skv, KV_CHUNK)
    n_kv_chunks = Skv // kv_chunk
    scale = 1.0 / np.sqrt(hd)
    q32 = q.float() * float(scale)
    dev = q.device
    q_pos = q_start + torch.arange(Sq, device=dev)
    carry = (torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev),
             torch.zeros((B, H, Sq), dtype=torch.float32, device=dev),
             torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=dev))
    n_live = n_kv_chunks
    if causal and block_skip:
        # chunks wholly in the future contribute nothing: skip them
        n_live = min(n_kv_chunks, (q_start + Sq - 1) // kv_chunk + 1)
    for ci in range(n_live):
        sl = slice(ci * kv_chunk, (ci + 1) * kv_chunk)
        kv_pos = ci * kv_chunk + torch.arange(kv_chunk, device=dev)
        carry = _attend_chunk(carry, q32, k[:, :, sl], v[:, :, sl], kv_pos,
                              q_pos, causal)
    m, l, acc = carry
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _member_heads(n_heads: int, n_kv: int, head_dim: int):
    """``(h0, h1, k0, k1, c0, c1)``: this member's block ``[c0, c1)`` of
    the attention's inner dimension (``n_heads * head_dim``, over
    ``model``), the query heads ``[h0, h1)`` it touches and the KV heads
    ``[k0, k1)`` they read."""
    blk = spmd.block(n_heads * head_dim)
    c0, c1 = blk.start, blk.stop
    h0, h1 = c0 // head_dim, -(-c1 // head_dim)
    rep = n_heads // n_kv
    return h0, h1, h0 // rep, (h1 - 1) // rep + 1, c0, c1


def _member_cols(xc: torch.Tensor, w: torch.Tensor, whole: int, lo: int,
                 hi: int) -> torch.Tensor:
    """Columns ``[lo, hi)`` of ``xc @ W`` for a member holding ``w``: its
    block of W's columns (all-gathered where the block is not those
    columns), or all of W (replicated: its columns taken)."""
    if w.shape[-1] == whole:
        return xc @ spmd.copy_to(w)[..., lo:hi]
    y = xc @ w
    blk = spmd.block(whole)
    if (blk.start, blk.stop) == (lo, hi):
        return y
    return spmd.gather_split(y, -1)[..., lo:hi]


def _member_attention(p, x, n_heads, n_kv, head_dim, qk_norm, rope_theta,
                      causal, block_skip):
    """:func:`attention` for a member holding its block of ``wq``'s
    columns (module docstring)."""
    B, S, D = x.shape
    h0, h1, k0, k1, c0, c1 = _member_heads(n_heads, n_kv, head_dim)
    xc = spmd.copy_to(x)
    hd = head_dim
    q = _member_cols(xc, p["wq"], n_heads * hd, h0 * hd, h1 * hd)
    k = _member_cols(xc, p["wk"], n_kv * hd, k0 * hd, k1 * hd)
    v = _member_cols(xc, p["wv"], n_kv * hd, k0 * hd, k1 * hd)
    q = q.reshape(B, S, h1 - h0, hd)
    k = k.reshape(B, S, k1 - k0, hd)
    v = v.reshape(B, S, k1 - k0, hd)
    if qk_norm:
        q = layers.rmsnorm(q, spmd.copy_to(p["q_norm"]))
        k = layers.rmsnorm(k, spmd.copy_to(p["k_norm"]))
    positions = torch.arange(S, device=x.device, dtype=torch.int32)[None, :]
    q = layers.apply_rope(q, positions, rope_theta)
    k = layers.apply_rope(k, positions, rope_theta)
    rep = n_heads // n_kv
    kv_of = torch.arange(h0, h1, device=x.device) // rep - k0
    o = _attend(q, k.index_select(2, kv_of), v.index_select(2, kv_of),
                causal, block_skip)
    o = o[..., c0 - h0 * hd:c1 - h0 * hd]
    return spmd.reduce_from(o @ p["wo"])


def _attend(q, k, v, causal, block_skip):
    """(B, S, H, hd) queries against GQA-expanded keys and values ->
    (B, S, H * hd)."""
    B, S, H, hd = q.shape
    q = q.transpose(1, 2)          # (B, H, S, hd)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    q_chunk = S if S <= Q_CHUNK else _divisor_chunk(S, Q_CHUNK)
    o = torch.cat([_flash_qchunk(q[:, :, i:i + q_chunk], k, v, i, causal,
                                 block_skip)
                   for i in range(0, S, q_chunk)], dim=2)
    return o.transpose(1, 2).reshape(B, S, H * hd)


def attention(p, x: torch.Tensor, *, n_heads: int, n_kv: int, head_dim: int,
              qk_norm: bool = False, rope_theta: float = 10000.0,
              causal: bool = True, block_skip: bool = True) -> torch.Tensor:
    """Full-sequence attention (training / prefill).  x: (B, S, D)."""
    if p["wq"].shape[-1] != n_heads * head_dim:
        return _member_attention(p, x, n_heads, n_kv, head_dim, qk_norm,
                                 rope_theta, causal, block_skip)
    B, S, D = x.shape
    positions = torch.arange(S, device=x.device, dtype=torch.int32)[None, :]
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, qk_norm,
                           positions, rope_theta)
    rep = n_heads // n_kv
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    return _attend(q, k, v, causal, block_skip) @ p["wo"]


def decode_attention(p, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, *, n_heads: int,
                     n_kv: int, head_dim: int, qk_norm: bool = False,
                     rope_theta: float = 10000.0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode.  x: (B, 1, D); cache: (B, Smax, n_kv, hd).

    Writes the token's K/V at ``pos`` into the cache in place and returns
    ``(out (B, 1, D), cache_k, cache_v)``.  A member's cache block holds
    its KV heads, or its positions of every head (module docstring).
    """
    if spmd.tp() > 1:
        return _member_decode(p, x, cache_k, cache_v, pos, n_heads, n_kv,
                              head_dim, qk_norm, rope_theta)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, qk_norm,
                           positions, rope_theta)
    Smax = cache_k.shape[1]
    if not 0 <= pos < Smax:
        raise IndexError(f"decode position {pos} outside a cache of {Smax}")
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    rep = n_heads // n_kv
    # scores against the full cache, masked beyond pos
    q_ = q.reshape(B, n_kv, rep, head_dim)
    s = torch.einsum("bkrd,bskd->bkrs", q_.float(),
                     cache_k.float()) / float(np.sqrt(head_dim))
    mask = (torch.arange(Smax, device=x.device) <= pos)[None, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrs,bskd->bkrd", w, cache_v.float())
    o = o.reshape(B, 1, n_heads * head_dim).to(x.dtype)
    return o @ p["wo"], cache_k, cache_v


def _whole_cols(x: torch.Tensor, w: torch.Tensor, whole: int) -> torch.Tensor:
    """``x @ W`` whole, from a member's block of W's columns (gathered) or
    all of W."""
    y = x @ w
    return y if w.shape[-1] == whole else spmd.all_gather(y, "model", -1)


def _member_decode(p, x, cache_k, cache_v, pos, n_heads, n_kv, head_dim,
                   qk_norm, rope_theta):
    """:func:`decode_attention` in a member's program (module
    docstring).  No gradient."""
    B = x.shape[0]
    hd = head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    heads = cache_k.shape[2] != n_kv          # the cache's heads over model
    if heads:
        h0, h1, k0, k1, c0, c1 = _member_heads(n_heads, n_kv, hd)
        if (k1 - k0) != cache_k.shape[2] or p["wk"].shape[-1] == n_kv * hd:
            raise ValueError(f"a cache block of {cache_k.shape[2]} KV heads "
                             f"for heads {h0}-{h1} of {n_heads}")
        q = x @ p["wq"]
        k, v = x @ p["wk"], x @ p["wv"]
        nh, nk = h1 - h0, k1 - k0
    else:                                    # its positions of every head
        q = _whole_cols(x, p["wq"], n_heads * hd)
        k = _whole_cols(x, p["wk"], n_kv * hd)
        v = _whole_cols(x, p["wv"], n_kv * hd)
        nh, nk = n_heads, n_kv
    q = q.reshape(B, 1, nh, hd)
    k = k.reshape(B, 1, nk, hd)
    v = v.reshape(B, 1, nk, hd)
    if qk_norm:
        q = layers.rmsnorm(q, p["q_norm"])
        k = layers.rmsnorm(k, p["k_norm"])
    q = layers.apply_rope(q, positions, rope_theta)
    k = layers.apply_rope(k, positions, rope_theta)
    S_blk = cache_k.shape[1]
    lo = 0 if heads else spmd.tp_rank() * S_blk
    if not 0 <= pos < (S_blk if heads else S_blk * spmd.tp()):
        raise IndexError(f"decode position {pos} outside the cache")
    if lo <= pos < lo + S_blk:
        cache_k[:, pos - lo] = k[:, 0].to(cache_k.dtype)
        cache_v[:, pos - lo] = v[:, 0].to(cache_v.dtype)
    q_ = q.reshape(B, nk, nh // nk, hd)
    s = torch.einsum("bkrd,bskd->bkrs", q_.float(),
                     cache_k.float()) / float(np.sqrt(hd))
    mask = (lo + torch.arange(S_blk, device=x.device) <= pos)
    s = torch.where(mask[None, None, None, :], s, NEG_INF)
    if heads:
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkrs,bskd->bkrd", w, cache_v.float())
        o = o.reshape(B, 1, nh * hd).to(x.dtype)
        return spmd.all_reduce(o @ p["wo"], "model"), cache_k, cache_v
    m = spmd.all_reduce(torch.amax(s, dim=-1), "model", op="max")
    e = torch.exp(s - m[..., None])
    l_ = spmd.all_reduce(torch.sum(e, dim=-1), "model")
    acc = spmd.all_reduce(torch.einsum("bkrs,bskd->bkrd", e,
                                       cache_v.float()), "model")
    o = (acc / l_[..., None]).reshape(B, 1, n_heads * hd).to(x.dtype)
    wo = p["wo"]
    if wo.shape[-2] != n_heads * hd:         # the member's rows of wo
        blk = spmd.block(n_heads * hd)
        return (spmd.all_reduce(o[..., blk] @ wo, "model"), cache_k,
                cache_v)
    return o @ wo, cache_k, cache_v
