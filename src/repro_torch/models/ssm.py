"""Recurrent token mixers: RWKV6 (Finch) and Mamba2 (SSD), with their
decode states.

The counterpart of ``repro/models/ssm.py``, in plain PyTorch ops (the
reference's mixers are plain ``jnp``, not Pallas kernels).

RWKV6 (data-dependent decay, arXiv:2404.05892), per head with K = V =
head_dim::

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    w_t = exp(-exp(w_base + x_t W_decay))

plus token-shift interpolation of the inputs.  Mamba2 / SSD
(arXiv:2405.21060), per head with state N = ssm_state::

    h_t = a_t h_{t-1} + dt_t (x_t ⊗ B_t)
    y_t = h_t C_t + D x_t,   a_t = exp(-dt_t exp(A_log))

with a short causal convolution on the input path and SiLU gating.  The
recurrences run in float32 as Python loops over time (the reference's
``lax.scan`` is a loop too); ``ssd_chunk > 0`` selects the chunkwise SSD
form, whose chunk loop is a Python loop as well.  Casts sit where the
reference places them.

In a mesh member's program (``distributed.spmd``) holding its blocks of
the leaves split over ``model`` (``sharding.param_specs``), each mixer
computes the member's heads: RWKV6's ``w_r``, ``w_k``, ``w_v``, ``w_g``
and ``w_decay`` column-parallel and ``w_o`` row-parallel, its channel mix
``w_ck`` / ``w_cr`` column-parallel and ``w_cv`` row-parallel, the decode
state's token-shift rows kept as the member's columns; Mamba2's packed
``in_proj`` (z, x, B, C and dt in one projection, its columns over
``model`` cutting across them) all-gathered so that each member takes its
channels of z and x, its heads of dt, and B and C whole, its channels of
``conv_w`` and rows of ``out_proj``, and the gated RMSNorm over all
channels summed over the members.  The recurrences' loops are unchanged.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd
from repro_torch.models import layers

# --------------------------------------------------------------------------
# RWKV6
# --------------------------------------------------------------------------


def init_rwkv6(gen: torch.Generator, d: int, n_heads: int,
               dtype: torch.dtype, device,
               n_layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The reference's tree and scales; ``n_layers``: a leading axis of
    that many stacked blocks."""
    lead = () if n_layers is None else (n_layers,)
    hd = d // n_heads
    s = float(1.0 / np.sqrt(d))
    p = {k: layers.normal(gen, lead + (d, d), dtype, s, device)
         for k in ("w_r", "w_k", "w_v", "w_g", "w_o")}
    # jax.random.normal(k, shape, dtype) * s * 0.1 scales twice in dtype
    p["w_decay"] = layers.normal(gen, lead + (d, d), dtype, s, device) * 0.1
    p["decay_base"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
    p["bonus_u"] = torch.zeros(lead + (n_heads, hd), dtype=dtype,
                               device=device)
    p["mix"] = layers.uniform(gen, lead + (5, d), dtype, device)
    return p


def _token_shift(x: torch.Tensor,
                 x_prev_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x shifted right by one step; x: (B, S, D), x_prev_last: (B, D) or
    None (zeros)."""
    if x_prev_last is None:
        pad = torch.zeros_like(x[:, :1])
    else:
        pad = x_prev_last[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _member_heads(n_heads: int, width: int) -> slice:
    """This member's heads where ``width`` (of ``n_heads`` heads) is split
    over ``model`` on whole heads."""
    if n_heads % spmd.tp():
        raise NotImplementedError(
            f"{n_heads} heads over model={spmd.tp()}: a member's block of "
            f"{width} channels would cut a head")
    return spmd.block(n_heads)


def _own_cols(x: Optional[torch.Tensor], D: int) -> Optional[torch.Tensor]:
    """A token-shift row whole: a member's block of its columns (the
    decode cache's) all-gathered."""
    if x is None or x.shape[-1] == D:
        return x
    return spmd.all_gather(x, "model", -1)


def _like(x_last: torch.Tensor, like: Optional[torch.Tensor]):
    """The new token-shift row in ``like``'s layout: the member's columns
    where the state it was given held them."""
    if like is None or like.shape[-1] == x_last.shape[-1]:
        return x_last
    return x_last[..., spmd.block(x_last.shape[-1])]


def rwkv6_mix(p, x: torch.Tensor, *, n_heads: int, state=None):
    """x: (B, S, D); state: None or (S_wkv (B, H, hd, hd) float32, x_last
    (B, D)).  Returns (out (B, S, D), (S_wkv, x_last)).  A member's state
    holds its heads and its columns of x_last."""
    B, S, D = x.shape
    H = n_heads
    hd = D // H
    x_last = None if state is None else state[1]
    xs = _token_shift(x, _own_cols(x_last, D))
    mix = p["mix"]
    split = p["w_r"].shape[-1] != D
    base, bonus = p["decay_base"], p["bonus_u"]
    if split:                 # every projection reads this member's share
        heads = _member_heads(H, D)
        cols = spmd.block(D)
        H = heads.stop - heads.start
        x0, x, xs, mix = x, spmd.copy_to(x), spmd.copy_to(xs), \
            spmd.copy_to(mix)
        base = spmd.copy_to(base)[..., cols]
        bonus = spmd.copy_to(bonus)[..., heads, :]

    def lerp(i):
        return x + (xs - x) * mix[i]

    r = (lerp(0) @ p["w_r"]).reshape(B, S, H, hd)
    k = (lerp(1) @ p["w_k"]).reshape(B, S, H, hd)
    v = (lerp(2) @ p["w_v"]).reshape(B, S, H, hd)
    g = F.silu(lerp(3) @ p["w_g"])
    decay = (base + lerp(4) @ p["w_decay"]).reshape(B, S, H, hd)
    w = torch.exp(-torch.exp(decay.float()))                 # (B,S,H,hd)
    u = bonus.float()[None, :, :, None]
    Scur = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                        device=x.device) if state is None else state[0])
    r, k, v = r.float(), k.float(), v.float()
    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B,H,K,V)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], Scur + u * kv))
        Scur = w[:, t, :, :, None] * Scur + kv
    o = torch.stack(outs, dim=1).reshape(B, S, H * hd).to(x.dtype)
    if split:
        return (spmd.reduce_from((o * g) @ p["w_o"]),
                (Scur, _like(x0[:, -1], x_last)))
    return (o * g) @ p["w_o"], (Scur, x[:, -1])


def init_rwkv6_channel_mix(gen: torch.Generator, d: int, f: int,
                           dtype: torch.dtype, device,
                           n_layers: Optional[int] = None
                           ) -> Dict[str, torch.Tensor]:
    lead = () if n_layers is None else (n_layers,)
    s = float(1.0 / np.sqrt(d))
    return {
        "w_ck": layers.normal(gen, lead + (d, f), dtype, s, device),
        "w_cv": layers.normal(gen, lead + (f, d), dtype,
                              float(1.0 / np.sqrt(f)), device),
        "w_cr": layers.normal(gen, lead + (d, d), dtype, s, device),
        "mix2": layers.uniform(gen, lead + (2, d), dtype, device),
    }


def rwkv6_channel_mix(p, x: torch.Tensor,
                      x_last: Optional[torch.Tensor] = None,
                      d_ff: Optional[int] = None):
    """r ⊙ (W_v · relu(W_k · lerp_k)^2), with token shift.  Returns out,
    and the new x_last as well when called with one (decode).  ``d_ff``:
    the whole hidden width, where ``p`` may hold a member's block of it
    (``w_ck`` and ``w_cv``) and of ``w_cr``'s columns."""
    D = x.shape[-1]
    if d_ff is None and spmd.tp() > 1:
        raise ValueError("a channel mix in a tensor-parallel member's "
                         "program needs its whole width, d_ff")
    xs = _token_shift(x, _own_cols(x_last, D))
    xk = x + (xs - x) * p["mix2"][0]
    xr = x + (xs - x) * p["mix2"][1]
    k_split = d_ff is not None and p["w_ck"].shape[-1] != d_ff
    r_split = p["w_cr"].shape[-1] != D
    k = torch.square(torch.relu(
        (spmd.copy_to(xk) if k_split else xk) @ p["w_ck"]))
    kv = k @ p["w_cv"]
    r = torch.sigmoid((spmd.copy_to(xr) if r_split else xr) @ p["w_cr"])
    if k_split:
        kv = spmd.reduce_from(kv)
    if r_split:
        r = spmd.gather_from(r, -1)
    out = r * kv
    if x_last is None:
        return out
    return out, _like(x[:, -1], x_last)


# --------------------------------------------------------------------------
# Mamba2 (SSD)
# --------------------------------------------------------------------------

CONV_K = 4


def init_mamba2(gen: torch.Generator, d: int, *, head_dim: int = 64,
                ssm_state: int = 64, expand: int = 2,
                dtype: torch.dtype = torch.bfloat16, device="cuda",
                n_layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    lead = () if n_layers is None else (n_layers,)
    di = d * expand
    H = di // head_dim
    N = ssm_state
    s = float(1.0 / np.sqrt(d))

    def const(shape, value):
        return torch.full(lead + shape, value, dtype=dtype, device=device)

    return {
        "in_proj": layers.normal(gen, lead + (d, 2 * di + 2 * N + H), dtype,
                                 s, device),
        "conv_w": layers.normal(gen, lead + (CONV_K, di), dtype, 0.5, device),
        "A_log": const((H,), 0.0),
        "D": const((H,), 1.0),
        "dt_bias": const((H,), 0.0),
        "out_proj": layers.normal(gen, lead + (di, d), dtype,
                                  float(1.0 / np.sqrt(di)), device),
        "norm_z": const((di,), 1.0),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal convolution.  x: (B, S, C), w: (K, C), state:
    (B, K-1, C).  The taps sum as ``0 + t0 + t1 + t2 + t3`` in x's dtype,
    the reference's order (in bf16 the order changes the result)."""
    B, S, C = x.shape
    if conv_state is None:
        pad = torch.zeros((B, CONV_K - 1, C), dtype=x.dtype, device=x.device)
    else:
        pad = conv_state
    xp = torch.cat([pad, x], dim=1)                          # (B, S+K-1, C)
    out = sum(xp[:, i:i + S] * w[i] for i in range(CONV_K))
    return out, xp[:, -(CONV_K - 1):]


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as ``lax.logaddexp``
    computes it, ``max(x, 0) + log1p(exp(-|x|))``, with its custom
    derivative ``exp(x - out)``."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return grad * torch.exp(x - out)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def _ssd_chunked(xin, a, Bv, Cv, dt, h0, chunk: int):
    """Chunkwise-parallel SSD (Mamba2 paper §6): the same recurrence, the
    state touched once a chunk and the within-chunk work as matmuls.

    xin: (B, S, H, P); a, dt: (B, S, H); Bv, Cv: (B, S, N); h0: (B, H, P,
    N) float32.  Returns (y (B, S, H, P) float32, h_fin)."""
    B, S, H, P = xin.shape
    N = Bv.shape[-1]
    c = min(chunk, S)
    while S % c:
        c -= 1
    nc = S // c
    u = (dt[..., None] * xin.float()).reshape(B, nc, c, H, P)
    la = torch.log(torch.clamp(a, min=1e-30)).reshape(B, nc, c, H)
    cum = torch.cumsum(la, dim=2)                            # (B,nc,c,H)
    Bc = Bv.reshape(B, nc, c, N)
    Cc = Cv.reshape(B, nc, c, N)

    # within a chunk: y_t += sum_{s<=t} exp(cum_t - cum_s) (C_t.B_s) u_s
    scores = torch.einsum("bktn,bksn->bkts", Cc, Bc)         # head-independent
    ldiff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,t,s,H)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xin.device))
    L = torch.where(mask[None, None, :, :, None], torch.exp(ldiff),
                    torch.zeros((), dtype=ldiff.dtype, device=xin.device))
    y_intra = torch.einsum("bkts,bktsh,bkshp->bkthp", scores, L, u)

    # across chunks: the carried state contributes C_t exp(cum_t) h_in, and
    # h_out = exp(cum_last) h_in + sum_s exp(cum_last - cum_s) u_s B_s
    dec_out = torch.exp(cum[:, :, -1:, :] - cum)             # (B,nc,c,H)
    uB = torch.einsum("bksh,bkshp,bksn->bkhpn", dec_out, u, Bc)
    a_tot = torch.exp(cum[:, :, -1])                         # (B,nc,H)
    h = h0
    ys = []
    for kc in range(nc):
        ys.append(torch.einsum("btn,bhpn,bth->bthp", Cc[:, kc], h,
                               torch.exp(cum[:, kc])))
        h = a_tot[:, kc, :, None, None] * h + uB[:, kc]
    y = y_intra + torch.stack(ys, dim=1)                     # (B,nc,c,H,P)
    return y.reshape(B, S, H, P), h


def mamba2_mix(p, x: torch.Tensor, *, head_dim: int = 64,
               ssm_state: int = 64, expand: int = 2, state=None,
               ssd_chunk: int = 0):
    """x: (B, S, D); state: None or (ssm (B, H, P, N) float32, conv (B,
    K-1, di)).  Returns (out (B, S, D), (ssm, conv)).  ``ssd_chunk > 0``
    takes the chunkwise SSD path (for S > 1)."""
    B, S, D = x.shape
    di = D * expand
    H = di // head_dim
    P, N = head_dim, ssm_state
    split = p["conv_w"].shape[-1] != di
    if split:
        return _member_mamba2(p, x, head_dim, ssm_state, expand, state,
                              ssd_chunk)
    proj = x @ p["in_proj"]                                  # (B,S,2di+2N+H)
    z, xin, Bmat, Cmat, dt = torch.split(proj, [di, di, N, N, H], dim=-1)
    conv_state = None if state is None else state[1]
    xin, conv_new = _causal_conv(xin, p["conv_w"], conv_state)
    xin = F.silu(xin).reshape(B, S, H, P)
    dt = _softplus(dt.float() + p["dt_bias"].float())
    a = torch.exp(-dt * torch.exp(p["A_log"].float()))       # (B,S,H)
    Bv = Bmat.float()                                        # (B,S,N)
    Cv = Cmat.float()
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if state is None else state[0])
    y, h = _ssm_scan(xin, a, Bv, Cv, dt, h, ssd_chunk)
    y = y + p["D"].float()[None, None, :, None] * xin.float()
    y = y.reshape(B, S, di).to(x.dtype)
    y = y * F.silu(z)
    y = layers.rmsnorm(y, p["norm_z"])
    return y @ p["out_proj"], (h, conv_new)


def _ssm_scan(xin, a, Bv, Cv, dt, h, ssd_chunk: int):
    """The SSD recurrence over time: (y (B, S, H, P) float32, h)."""
    B, S = xin.shape[:2]
    if ssd_chunk and S > 1:
        return _ssd_chunked(xin, a, Bv, Cv, dt, h, ssd_chunk)
    x32 = xin.float()
    ys = []
    for t in range(S):
        upd = (dt[:, t, :, None, None] * x32[:, t, :, :, None]
               * Bv[:, t, None, None, :])                    # (B,H,P,N)
        h = a[:, t, :, None, None] * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cv[:, t]))
    return torch.stack(ys, dim=1), h                         # (B,S,H,P)


def _member_mamba2(p, x, head_dim, ssm_state, expand, state, ssd_chunk):
    """:func:`mamba2_mix` for a member holding its block of the channels
    (module docstring): the state its heads and its channels of the
    convolution rows."""
    B, S, D = x.shape
    di = D * expand
    H = di // head_dim
    P, N = head_dim, ssm_state
    heads = _member_heads(H, di)
    cols = spmd.block(di)
    Hm, dm = heads.stop - heads.start, cols.stop - cols.start
    width = 2 * di + 2 * N + H
    if p["in_proj"].shape[-1] != width:      # its columns: gather them
        proj = spmd.gather_split(spmd.copy_to(x) @ p["in_proj"], -1)
    else:
        proj = spmd.copy_to(x @ p["in_proj"])
    z = proj[..., cols]
    xin = proj[..., di + cols.start:di + cols.stop]
    Bmat = proj[..., 2 * di:2 * di + N]
    Cmat = proj[..., 2 * di + N:2 * di + 2 * N]
    dt = proj[..., 2 * di + 2 * N + heads.start:2 * di + 2 * N + heads.stop]
    conv_state = None if state is None else state[1]
    xin, conv_new = _causal_conv(xin, p["conv_w"], conv_state)
    xin = F.silu(xin).reshape(B, S, Hm, P)
    own = {k: spmd.copy_to(p[k])[heads] for k in ("dt_bias", "A_log", "D")}
    dt = _softplus(dt.float() + own["dt_bias"].float())
    a = torch.exp(-dt * torch.exp(own["A_log"].float()))     # (B,S,Hm)
    h = (torch.zeros((B, Hm, P, N), dtype=torch.float32, device=x.device)
         if state is None else state[0])
    y, h = _ssm_scan(xin, a, Bmat.float(), Cmat.float(), dt, h, ssd_chunk)
    y = y + own["D"].float()[None, None, :, None] * xin.float()
    y = y.reshape(B, S, dm).to(x.dtype)
    y = y * F.silu(z)
    # the gated RMSNorm over every channel: the members' sums of squares
    y32 = y.float()
    ss = spmd.psum(torch.sum(torch.square(y32), dim=-1, keepdim=True))
    y32 = y32 * torch.rsqrt(ss / di + 1e-6)
    y = (y32 * spmd.copy_to(p["norm_z"])[cols].float()).to(y.dtype)
    return spmd.reduce_from(y @ p["out_proj"]), (h, conv_new)
