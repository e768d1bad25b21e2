"""Step functions: train, prefill, serve.

The counterpart of ``repro/launch/steps.py`` on one device.  PyTorch runs
eagerly, so ``build_*`` returns the step itself (the reference's are jitted
by their callers).  The DiLoCo inner step (``build_pod_inner_step``) runs
the train step once a pod, the pods sharing one device.  The step
shardings (``batch_shardings``, ``train_shardings``, ``serve_shardings``)
need a mesh for the model's steps, not ported yet (ROADMAP.md Queue 1 item
11b): they raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import leaves, rebuild
from repro_torch.models import layers, model
from repro_torch.optim import adamw

_MESH = ("{} needs a mesh for the model's steps, not ported yet (ROADMAP.md "
         "Queue 1 item 11b): the port trains and serves on one device")


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


def batch_shardings(cfg: ArchConfig, shape, mesh):
    raise NotImplementedError(_MESH.format("batch_shardings"))


def train_shardings(cfg: ArchConfig, shape, mesh, opt_cfg=None):
    raise NotImplementedError(_MESH.format("train_shardings"))


def serve_shardings(cfg: ArchConfig, shape, mesh):
    raise NotImplementedError(_MESH.format("serve_shardings"))


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
