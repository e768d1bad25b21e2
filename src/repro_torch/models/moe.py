"""Token-choice top-k MoE with capacity and sort-based dispatch.

The counterpart of ``repro/models/moe.py``, in plain PyTorch ops (the
reference's MoE is plain ``jnp`` too, not a Pallas kernel).  Tokens are
reshaped into ``(G, T, D)`` with ``G = sharding.dp_groups(B)`` (1 without a
mesh; 1 in decode with ``decode_global``), and each group is dispatched on
its own by the static-shape sort trick (``_dispatch_group``): top-k of the
float32 router logits, a stable argsort of the flat expert ids, each
assignment's rank within its expert, and an ``(E, C)`` table of token
indices with assignments of rank >= C dropped.  The experts are SwiGLU
(``silu(gate) * up``, whatever ``act`` is), gathered from a padded
``(T + 1, D)`` token table and scattered back with an index add.

Top-k is a stable descending sort: ``lax.top_k`` returns equal logits
lowest index first, and ``torch.topk`` promises no order among them, so a
tie at the k-th place could send a token to another expert (and route the
remat recompute apart from the forward).

In a mesh member's program (``distributed.spmd``) holding its block of
the experts (``E / model`` of them, the reference's ``expert`` spec), the
member routes its tokens as every member does (the router is replicated),
computes only its experts' ``(G, E / model, C, D)`` slots, and the
combine's partial sums are all-reduced over ``model``, as the
reference's constraints place the slots and the output
(``repro/models/moe.py:113-143``).  A decode step's global dispatch
(``decode_global``) routes the whole batch as one group: the member
all-gathers the tokens over the axes the batch is split over and keeps
its rows of the output.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding, spmd
from repro_torch.models import layers


def _expert_normal(gen: torch.Generator, lead: tuple, shape: tuple,
                   dtype: torch.dtype, scale: float, device) -> torch.Tensor:
    """``layers.normal`` of ``lead + shape``, drawn one leading index at a
    time into the stacked tensor: a full-width expert leaf is 805 M elements
    a layer, so a draw of all layers at once would hold several times the
    leaf in float32."""
    out = torch.empty(lead + shape, dtype=dtype, device=device)
    for idx in np.ndindex(*lead):
        out[idx] = layers.normal(gen, shape, dtype, scale, device)
    return out


def init_moe(gen: torch.Generator, d: int, f_expert: int, n_experts: int,
             n_shared: int, act: str, dtype: torch.dtype, device,
             n_layers: Optional[int] = None) -> Dict[str, object]:
    """The reference's tree and scales: ``router`` (d, E); ``w_up`` and
    ``w_gate`` (E, d, f); ``w_down`` (E, f, d); ``shared`` (an MLP of
    width ``f * n_shared``) where ``n_shared``.  ``n_layers``: a leading
    axis of that many stacked blocks."""
    lead = () if n_layers is None else (n_layers,)
    s_in = float(1.0 / np.sqrt(d))
    s_out = float(1.0 / np.sqrt(f_expert))
    E = n_experts
    p: Dict[str, object] = {
        "router": layers.normal(gen, lead + (d, E), dtype, s_in, device),
        "w_up": _expert_normal(gen, lead, (E, d, f_expert), dtype, s_in,
                               device),
        "w_gate": _expert_normal(gen, lead, (E, d, f_expert), dtype, s_in,
                                 device),
        "w_down": _expert_normal(gen, lead, (E, f_expert, d), dtype, s_out,
                                 device),
    }
    if n_shared:
        p["shared"] = layers.init_mlp(gen, d, f_expert * n_shared, act, dtype,
                                      device, layers=n_layers)
    return p


def top_k(logits: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest values in
    descending order and their indices, equal values lowest index first."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _dispatch_group(xt: torch.Tensor, router: torch.Tensor, E: int, K: int,
                    C: int):
    """One group's dispatch.  xt: (T, D) -> (token_of_slot (E, C) int32,
    gate_of_slot (E, C) float32); an empty slot holds token T and gate 0."""
    T = xt.shape[0]
    logits = (xt @ router).float()                           # (T, E)
    gates, ids = top_k(logits, K)                            # (T, K)
    gates = torch.softmax(gates, dim=-1)
    flat_ids = ids.reshape(-1)                               # (T*K,)
    order = torch.argsort(flat_ids, stable=True)             # group by expert
    sorted_ids = flat_ids[order]
    # bincount's output length depends on the data, so it has no ``meta``
    # kernel: the dry-run counts this program on ``meta`` tensors
    counts = torch.zeros(E, dtype=torch.int64, device=xt.device).index_add_(
        0, flat_ids, torch.ones_like(flat_ids))
    offsets = torch.cumsum(counts, 0) - counts               # exclusive
    rank = torch.arange(T * K, device=xt.device) - offsets[sorted_ids]
    slot = torch.where(rank < C, sorted_ids * C + rank,
                       torch.full_like(rank, E * C))         # drop slot E*C
    tok = (order // K).to(torch.int32)
    gate_flat = gates.reshape(-1)[order]
    dev = xt.device
    token_of_slot = torch.full((E * C + 1,), T, dtype=torch.int32,
                               device=dev).index_put((slot,), tok)
    gate_of_slot = torch.zeros((E * C + 1,), dtype=torch.float32,
                               device=dev).index_put((slot,), gate_flat)
    return token_of_slot[:-1].reshape(E, C), gate_of_slot[:-1].reshape(E, C)


def _expert_w(p, key: str, dtype: torch.dtype) -> torch.Tensor:
    """An expert weight; an int8 ``{"q", "s"}`` leaf
    (:func:`quantize_expert_weights`) is expanded at use."""
    w = p[key]
    if isinstance(w, dict):
        return w["q"].to(dtype) * w["s"].to(dtype)
    return w


def quantize_expert_weights(p_moe):
    """Serve-time transform: per-(expert, out-channel) int8 weights,
    ``{"q": int8, "s": float32 (..., 1, out)}``; ``torch.round`` rounds half
    to even, as ``jnp.round``."""
    out = dict(p_moe)
    for key in ("w_up", "w_gate", "w_down"):
        w = p_moe[key].float()
        amax = torch.amax(torch.abs(w), dim=-2, keepdim=True)
        s = amax / 127.0 + 1e-12
        q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
        out[key] = {"q": q, "s": s.float()}
    return out


def abstract_quantize_expert_weights(p_moe):
    """:func:`quantize_expert_weights`' shapes and dtypes as ``meta``
    tensors, with nothing allocated or computed (the dry-run's ``quantx``
    variant)."""
    out = dict(p_moe)
    for key in ("w_up", "w_gate", "w_down"):
        shape = tuple(p_moe[key].shape)
        out[key] = {"q": torch.empty(shape, dtype=torch.int8, device="meta"),
                    "s": torch.empty(shape[:-2] + (1,) + shape[-1:],
                                     dtype=torch.float32, device="meta")}
    return out


def moe_ffn(p, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, act: str = "swiglu",
            decode_global: bool = True,
            shared_ff: Optional[int] = None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  ``shared_ff``: the shared expert's
    whole hidden width (``layers.mlp``'s ``d_ff``)."""
    whole_batch = x.shape[1] == 1 and decode_global
    if whole_batch:              # one global group: every member's tokens
        x = spmd.gather_batch(x)
    B, S, D = x.shape
    E, K = n_experts, top_k
    # decode (S == 1) dispatches globally: per-group dispatch at a few
    # tokens would pad every group to 8 slots on every expert
    G = sharding.dp_groups(B) if (S > 1 or not decode_global) else 1
    T = (B * S) // G                                         # tokens a group
    xg_in = sharding.constrain(x.reshape(G, T, D),
                               "dp" if G > 1 else None, None, None)
    C = int(np.ceil(T * K / E * capacity_factor))
    C = max(8, min(C, T))
    tables = [_dispatch_group(xg_in[g], p["router"], E, K, C)
              for g in range(G)]
    token_of_slot = torch.stack([t for t, _ in tables])      # (G, E, C)
    gate_of_slot = torch.stack([s for _, s in tables])

    pad = torch.zeros((G, 1, D), dtype=x.dtype, device=x.device)
    xt_pad = torch.cat([xg_in, pad], dim=1)                  # (G, T+1, D)
    w_up = p["w_up"]["q"] if isinstance(p["w_up"], dict) else p["w_up"]
    split = w_up.shape[-3] != E          # this member's block of experts
    if split:
        mine = spmd.block(E)
        E = mine.stop - mine.start
        xt_pad = spmd.copy_to(xt_pad)
        token_of_slot = token_of_slot[:, mine]
        gate_of_slot = spmd.copy_to(gate_of_slot)[:, mine]
    tos = token_of_slot.reshape(G, E * C).long()
    xg = xt_pad[torch.arange(G, device=x.device)[:, None], tos]
    xg = xg.reshape(G, E, C, D)
    xg = sharding.constrain(xg, "dp" if G > 1 else None, "model", None,
                            None)
    up = torch.einsum("gecd,edf->gecf", xg, _expert_w(p, "w_up", x.dtype))
    gate_h = torch.einsum("gecd,edf->gecf", xg,
                          _expert_w(p, "w_gate", x.dtype))
    h = F.silu(gate_h) * up
    y = torch.einsum("gecf,efd->gecd", h, _expert_w(p, "w_down", x.dtype))
    y = y * gate_of_slot[..., None].to(y.dtype)              # (G, E, C, D)
    out = torch.stack([
        torch.zeros((T + 1, D), dtype=y.dtype, device=x.device).index_add(
            0, tos[g], y[g].reshape(E * C, D))[:T]
        for g in range(G)])                                  # (G, T, D)
    if split:
        out = spmd.reduce_from(out)
    out = sharding.constrain(out, "dp", None, None)
    if "shared" in p:
        out = out + layers.mlp(p["shared"], xg_in, act, shared_ff)
    out = out.reshape(B, S, D).to(x.dtype)
    return spmd.batch_block(out) if whole_batch else out
