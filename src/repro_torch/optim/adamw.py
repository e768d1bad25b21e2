"""AdamW with optional int8 block-quantized moments.

The counterpart of ``repro/optim/adamw.py``: moments stored as int8 with a
float32 scale a block of ``QBLOCK`` (the second moment in the sqrt domain)
and dequantized on use, in the reference's order of float32 operations;
``torch.round`` rounds half to even, as ``jnp.round`` does.  The state is
``{"step": int32 0-d tensor, "m": tree, "v": tree}`` on the parameters'
device, each moment a float32 tensor or ``{"q": int8 (nb, QBLOCK), "s":
float32 (nb, 1)}``: the reference's tree, so a checkpoint of either has the
same leaves (``models.model.params_from_numpy`` carries one across).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.core.tree import leaves, map_tree

QBLOCK = 128


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    compress_moments: bool = False   # int8 + per-block scale


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA and the card's
    ``sqrtf`` give it.  The CPU's vectorised float32 square root (MKL's
    VML) is an ulp low on some inputs, and which ones depends on where an
    element falls in the vector loop (a slice of a tensor can get other
    bits than the same elements of the whole), so on the CPU it is taken in
    float64 and rounded once, which is exact for a float32 input."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _quantize(x: torch.Tensor, sqrt_domain: bool = False):
    """int8 block quantization; the second moment in the sqrt domain."""
    flat = x.reshape(-1)
    if sqrt_domain:
        flat = _sqrt(torch.clamp(flat, min=0.0))
    pad = (-flat.shape[0]) % QBLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, QBLOCK)
    # a true division, as on the CPU: the card multiplies by the reciprocal
    # of a Python number, one ulp apart from the reference's scale at times
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / \
        torch.full((), 127.0, device=blocks.device) + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
                sqrt_domain: bool = False) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    if sqrt_domain:
        flat = torch.square(flat)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    def zeros_like_moment(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.compress_moments:
            q, s = _quantize(z)
            return {"q": q, "s": s}
        return z

    device = next(leaves(params)).device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": map_tree(zeros_like_moment, params),
            "v": map_tree(zeros_like_moment, params)}   # sqrt-domain int8


def bias_corrections(step: torch.Tensor, cfg: AdamWConfig):
    """``(step + 1, 1 - b1^(step+1), 1 - b2^(step+1))`` of the state's
    step counter, on its device."""
    step = step + 1
    stepf = step.float()
    return (step, 1.0 - torch.pow(cfg.b1, stepf),
            1.0 - torch.pow(cfg.b2, stepf))


@torch.no_grad()
def update_leaf(p, g, m, v, b1c, b2c, cfg: AdamWConfig):
    """One leaf's update: ``(new p, new m, new v)``.  ``p`` and ``g`` may be
    a block of a parameter (a ZeRO-1 member's: a region of its index space,
    or a flat range of whole ``QBLOCK`` blocks for an int8 moment, the last
    one ending at the parameter's end), ``m`` and ``v`` that block's
    moments: every operation is elementwise or a block's own, so a block's
    update equals the same elements of the whole leaf's, bit for bit."""
    # the reference's operations in its order; each float32 transient is
    # dropped once used, so a leaf's update holds a few leaf-sized float32
    # tensors at a time (an MoE expert leaf is 3.2 GB of them)
    g = g.float()
    if cfg.compress_moments:
        m_f = _dequantize(m["q"], m["s"], p.shape)
        v_f = _dequantize(v["q"], v["s"], p.shape, sqrt_domain=True)
    else:
        m_f, v_f = m, v
    m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
    v_f = cfg.b2 * v_f + (1 - cfg.b2) * torch.square(g)
    del g
    if cfg.compress_moments:
        new_m, new_v = _quantize(m_f), _quantize(v_f, sqrt_domain=True)
        new_m, new_v = ({"q": new_m[0], "s": new_m[1]},
                        {"q": new_v[0], "s": new_v[1]})
    else:
        new_m, new_v = m_f, v_f
    mh = m_f / b1c
    del m_f
    vh = v_f / b2c
    del v_f
    step_dir = mh / (_sqrt(vh) + cfg.eps)
    del mh, vh
    p32 = p.float()
    p32 = p32 - cfg.lr * (step_dir + cfg.weight_decay * p32)
    return p32.to(p.dtype), new_m, new_v


@torch.no_grad()
def apply(params, grads, state, cfg: AdamWConfig):
    """One AdamW update: ``(new_params, new_state)``; nothing is updated in
    place."""
    step, b1c, b2c = bias_corrections(state["step"], cfg)

    # the parameters' structure leads: a compressed moment's {"q", "s"}
    # reaches ``update_leaf`` whole, and each leaf of ``out`` is a (p, m,
    # v) tuple
    out = map_tree(lambda p, g, m, v: update_leaf(p, g, m, v, b1c, b2c, cfg),
                   params, grads, state["m"], state["v"])
    new_p, new_m, new_v = (map_tree(lambda o, i=i: o[i], out)
                           for i in range(3))
    return new_p, {"step": step, "m": new_m, "v": new_v}
