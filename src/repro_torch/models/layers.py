"""Shared layers: norms, rotary, MLPs, embeddings (plain functions on tensors).

The counterpart of ``repro/models/layers.py``.  Each function computes what
the reference's does, in the same dtypes: norms and rotary in float32 and
cast back to the input's dtype, matmuls in the parameters' dtype.  Init
functions draw from an explicit ``torch.Generator`` (the reference's shapes,
dtypes and scales; not JAX's random bits): a normal sample is drawn in
float32 on the generator's device, cast to the parameter dtype and scaled
in it, as ``jax.random.normal(key, shape, dtype) * s`` scales in ``dtype``.

In a mesh member's program (``distributed.spmd``) a function given the
member's block of a leaf split over ``model`` computes the member's share:
the MLP column-parallel into ``w_up`` / ``w_gate`` and row-parallel out of
``w_down``, its partial sums all-reduced (:func:`mlp`, told the whole
width); the embedding looked up in the member's columns and all-gathered
(:func:`embed_lookup`).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd

# Activations ----------------------------------------------------------------


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.relu(x))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"gelu": _gelu, "silu": F.silu, "relu2": _relu2}[name]


# Norms ----------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True)
                        + eps)
    return (x * scale.float()).to(dt)


def ln_nonparam(x: torch.Tensor, _unused=None,
                eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm (no scale/bias)."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt)


def norm_fn(kind: str):
    return {"rmsnorm": rmsnorm, "ln_nonparam": ln_nonparam}[kind]


def norm_params(kind: str, d: int, dtype: torch.dtype,
                device) -> torch.Tensor:
    if kind == "rmsnorm":
        return torch.ones((d,), dtype=dtype, device=device)
    # non-parametric: a placeholder leaf
    return torch.zeros((0,), dtype=dtype, device=device)


def apply_norm(kind: str, x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p)
    return ln_nonparam(x)


# Rotary ---------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    """float64, as the reference computes them before its float32 cast."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=32)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """The float32 frequencies on ``device``, uploaded once: an upload from
    pageable memory waits for the device, so one a call would stall every
    decode step's layers."""
    return torch.tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                        device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = _rope_freqs_on(x.shape[-1], float(theta), x.device)
    ang = positions[..., :, None].float() * freqs       # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# Init -----------------------------------------------------------------------


def normal(gen: torch.Generator, shape, dtype: torch.dtype, scale: float,
           device) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype) * scale``: a standard normal
    drawn in float32 on the generator's device, cast to ``dtype``, scaled in
    ``dtype``, on ``device``."""
    z = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (z.to(device=device, dtype=dtype) * scale)


def uniform(gen: torch.Generator, shape, dtype: torch.dtype,
            device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)``: [0, 1) drawn in float32
    on the generator's device, cast to ``dtype``, on ``device``."""
    z = torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                   device=gen.device)
    return z.to(device=device, dtype=dtype)


# MLPs -----------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, f: int, act: str,
             dtype: torch.dtype, device, layers: Optional[int] = None
             ) -> Dict[str, torch.Tensor]:
    """``layers``: a leading axis of that many stacked blocks."""
    lead = () if layers is None else (layers,)
    s_in = float(1.0 / np.sqrt(d))
    s_out = float(1.0 / np.sqrt(f))
    p = {"w_up": normal(gen, lead + (d, f), dtype, s_in, device),
         "w_down": normal(gen, lead + (f, d), dtype, s_out, device)}
    if act == "swiglu":
        p["w_gate"] = normal(gen, lead + (d, f), dtype, s_in, device)
    return p


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str,
        d_ff: Optional[int] = None) -> torch.Tensor:
    """``d_ff``: the hidden width of the whole MLP; where ``p`` holds a
    member's block of it (``w_up`` narrower), the member computes its
    columns and the rows of ``w_down`` they meet, and the partial sums are
    all-reduced over ``model`` (in a member's program the width must be
    given)."""
    if d_ff is None and spmd.tp() > 1:
        raise ValueError("an MLP in a tensor-parallel member's program "
                         "needs its whole width, d_ff")
    split = d_ff is not None and p["w_up"].shape[-1] != d_ff
    if split:
        x = spmd.copy_to(x)
    up = x @ p["w_up"]
    if act == "swiglu":
        up = F.silu(x @ p["w_gate"]) * up
    else:
        up = act_fn(act)(up)
    y = up @ p["w_down"]
    return spmd.reduce_from(y) if split else y


# Embedding ------------------------------------------------------------------


def init_embed(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype,
               device) -> torch.Tensor:
    return normal(gen, (vocab, d), dtype, 0.02, device)


def embed_lookup(tokens: torch.Tensor, embed: torch.Tensor,
                 d_model: int) -> torch.Tensor:
    """``embed``'s rows of ``tokens``; a member's block of the columns
    (``d_model`` over ``model``) is looked up and all-gathered."""
    x = F.embedding(tokens, embed)
    return x if embed.shape[-1] == d_model else spmd.gather_from(x, -1)

