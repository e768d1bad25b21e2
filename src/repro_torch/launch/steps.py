"""Step functions: train, prefill, serve.

The counterpart of ``repro/launch/steps.py`` on one device.  PyTorch runs
eagerly, so ``build_*`` returns the step itself (the reference's are jitted
by their callers).  The DiLoCo inner step (``build_pod_inner_step``) runs
the train step once a pod, the pods sharing one device.  The step
shardings (``batch_shardings``, ``train_shardings``, ``serve_shardings``)
give the reference's placements of every input, parameter, optimizer and
cache leaf on a mesh, from shapes alone (``input_specs``,
``abstract_train_state``: ``meta`` tensors); running the steps under
them needs a mesh for the model's steps (ROADMAP.md Queue 1 item 11c).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.tree import leaves, rebuild
from repro_torch.distributed import sharding
from repro_torch.models import layers, model
from repro_torch.optim import adamw


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Every model input of ``shape`` as a ``meta`` tensor (no
    allocation): ``tokens`` (and ``labels`` to train) and a prefix model's
    ``prefix_emb``; one token a row to decode."""
    B, S = shape.global_batch, shape.seq_len

    def meta(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": meta(B, 1)}
    specs = {"tokens": meta(B, S)}
    if shape.kind == "train":
        specs["labels"] = meta(B, S)
    if cfg.n_prefix:
        specs["prefix_emb"] = meta(B, cfg.n_prefix, cfg.d_model,
                                   dtype=model.DTYPES[cfg.dtype])
    return specs


def batch_shardings(cfg: ArchConfig, shape: ShapeSpec, mesh):
    """Each input's leading (batch) dimension over ``sharding.batch_spec``'s
    axes."""
    spec = sharding.batch_spec(mesh, shape.global_batch)
    bax = spec[0] if len(spec) else None
    return {k: sharding.NamedSharding(
                mesh, sharding.P(bax, *([None] * (v.dim() - 1))))
            for k, v in input_specs(cfg, shape).items()}


def abstract_train_state(cfg: ArchConfig,
                         opt_cfg: Optional[adamw.AdamWConfig] = None):
    """(params, AdamW state) as ``meta`` tensors."""
    params = model.abstract_params(cfg)
    return params, adamw.init(params, opt_cfg or adamw.AdamWConfig())


def train_shardings(cfg: ArchConfig, shape: ShapeSpec, mesh,
                    opt_cfg: Optional[adamw.AdamWConfig] = None):
    """((params, optimizer state, batch), (params, optimizer state, loss))
    shardings of a train step on ``mesh``."""
    params, opt_state = abstract_train_state(cfg, opt_cfg)
    p_sh = sharding.param_shardings(params, mesh)
    o_sh = sharding.opt_shardings(opt_state, params, mesh)
    b_sh = batch_shardings(cfg, shape, mesh)
    return (p_sh, o_sh, b_sh), (p_sh, o_sh,
                                sharding.NamedSharding(mesh, sharding.P()))


def serve_shardings(cfg: ArchConfig, shape: ShapeSpec, mesh):
    """((params, cache, batch), (logits, cache)) shardings of a decode step
    on ``mesh``."""
    p_sh = sharding.param_shardings(model.abstract_params(cfg), mesh)
    c_sh = {k: sharding.NamedSharding(mesh, v) for k, v in
            sharding.cache_spec(mesh, cfg, shape.global_batch).items()}
    b_sh = batch_shardings(cfg, shape, mesh)
    return (p_sh, c_sh, b_sh), (sharding.NamedSharding(mesh, sharding.P()),
                                c_sh)


def build_train_step(cfg: ArchConfig,
                     opt_cfg: Optional[adamw.AdamWConfig] = None,
                     remat: bool = True, grad_compressor=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
    the loss and its gradients (``remat``: each block recomputed in the
    backward pass), the optional ``grad_compressor`` on the gradient tree,
    then AdamW.  The step returns new parameter tensors and leaves its
    inputs as they were."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params, opt_state, batch):
        flat = list(leaves(params))
        live = [p.detach().requires_grad_() for p in flat]
        loss = model.loss_fn(cfg, rebuild(params, live), batch["tokens"],
                             batch["labels"], batch.get("prefix_emb"),
                             remat=remat)
        # a leaf the loss does not read (a non-parametric norm's
        # placeholder) has a zero gradient, as jax.grad gives it
        got = torch.autograd.grad(loss, live, allow_unused=True)
        grads = rebuild(params, [torch.zeros_like(p) if g is None else g
                                 for p, g in zip(flat, got)])
        if grad_compressor is not None:
            grads = grad_compressor(grads)
        params, opt_state = adamw.apply(params, grads, opt_state, opt_cfg)
        return params, opt_state, loss.detach()

    return train_step


def build_pod_inner_step(cfg: ArchConfig,
                         opt_cfg: Optional[adamw.AdamWConfig] = None,
                         remat: bool = True, grad_compressor=None):
    """DiLoCo inner step: the train step run once a pod over trees whose
    leaves carry a leading ``(n_pods,)`` member axis (params, optimizer
    state and batch), so each pod trains on its own with no cross-pod
    collective a step; pods reconcile only through the compressed outer
    sync (``distributed.diloco.make_outer_sync``).  ``grad_compressor``
    composes: ``distributed.collectives.make_wire_compressor()`` pushes
    every pod's gradients through the int8 bitpack wire and its decode."""
    from repro_torch.distributed import diloco
    return diloco.make_inner_step(
        build_train_step(cfg, opt_cfg, remat=remat,
                         grad_compressor=grad_compressor))


def build_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, batch) -> (B, 1, vocab)`` next-token logits."""

    @torch.no_grad()
    def prefill_step(params, batch):
        x = model.embed_inputs(cfg, params, batch["tokens"],
                               batch.get("prefix_emb"))
        x = model._layer_stack(cfg, params, x, remat=False)
        x = layers.apply_norm(cfg.norm, x, params["ln_f"])
        return x[:, -1:] @ model.head(cfg, params)

    return prefill_step


def build_serve_step(cfg: ArchConfig):
    """``serve_step(params, cache, batch) -> (logits, cache)``: one decode
    step."""

    @torch.no_grad()
    def serve_step(params, cache, batch):
        return model.decode_step(cfg, params, cache, batch["tokens"])

    return serve_step
