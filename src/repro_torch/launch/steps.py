"""Step functions: train, prefill, serve, and the same steps under a mesh.

The counterpart of ``repro/launch/steps.py``.  PyTorch runs eagerly, so
``build_*`` returns the step itself (the reference's are jitted by their
callers).  The DiLoCo inner step (``build_pod_inner_step``) runs the train
step once a pod, the pods sharing one device.  The step shardings
(``batch_shardings``, ``train_shardings``, ``serve_shardings``) give the
reference's placements of every input, parameter, optimizer and cache
leaf on a mesh, from shapes alone (``input_specs``,
``abstract_train_state``: ``meta`` tensors).

:func:`sharded_step` is the reference's ``jax.jit(step, in_shardings=...,
out_shardings=...)`` under ``sharding.use_mesh(mesh, policy)``, on a
``launch.mesh.Mesh`` whose members share one device:

* Storage stays partitioned.  Between steps each member keeps only its own
  blocks (``sharding.ShardedTensor``): the parameters split over ``model``
  by ``param_specs``, the moments over ``model`` and ``data`` by
  ``opt_specs`` (ZeRO-1), the batch and the decode cache over the DP axes
  by ``batch_spec`` and ``cache_spec``.  Plain tensors given to the step
  are placed first; a shape the placement cannot split raises.
* The collectives are explicit.  At the step's start the members' blocks
  are all-gathered (``ShardedTensor.full``: one ``torch.cat``-like copy in
  member order, as ``plan.gather_member_tables`` lays tables).  Forward and
  backward run as one batched pass over the DP members' batch blocks,
  concatenated in member order: on a shared device that is every DP
  member's work in one launch, what the reference's program computes, and
  the MoE's per-group routing sees every member's tokens in its
  ``(G, T, D)`` layout, G from ``sharding.dp_groups``.  The loss is the
  mean over the global batch.
* The gradient goes through the optional ``grad_compressor`` whole, leaf by
  leaf, as the reference applies it inside its global program, and is then
  reduce-scattered: the batched pass has already summed it over the DP
  members, so each member takes the region of its ZeRO-1 optimizer block.
* AdamW runs member by member on each member's own ZeRO-1 block
  (``adamw.update_leaf``): a region of the parameter's index space, or,
  for an int8 moment (``{"q": (nb, 128), "s": (nb, 1)}`` split over
  ``data`` on ``nb``), a flat range of whole blocks of the parameter, the
  last one ending at its end.  Replicas over ``pod`` compute their copy, as
  the reference's devices do.  The updated regions are all-gathered over
  ``data`` back to the ``param_specs`` layout.
* Outputs are placed by ``out_shardings`` (None: returned whole); the
  decode cache is gathered and placed afresh each call, and the parameters
  are gathered each call: no gathered copy is kept between calls.

On a shared device the step's values are the unsharded step's, bit for
bit, except where the mesh changes the computation itself (the MoE's G).
Splitting the compute over ``model`` (column and row tensor parallelism,
vocab-parallel cross entropy) and a device for each DP member change no
result on one device and wait for meshes over distinct devices (ROADMAP.md
Queue 1 item 11c).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.tree import leaves, map_tree, rebuild
from repro_torch.distributed import sharding
from repro_torch.models import layers, model
from repro_torch.optim import adamw
from repro_torch.roofline import count


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
    inputs as they were.  Its parts, ``train_step.loss_and_grads(params,
    batch) -> (loss, grads)`` and ``train_step.opt_cfg``, are what
    :func:`sharded_step` runs under a mesh."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def loss_and_grads(params, batch):
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
        return loss.detach(), grads

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch)
        params, opt_state = adamw.apply(params, grads, opt_state, opt_cfg)
        return params, opt_state, loss

    train_step.loss_and_grads = loss_and_grads
    train_step.opt_cfg = opt_cfg
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


# --------------------------------------------------------------------------
# the steps under a mesh
# --------------------------------------------------------------------------


def _first_sharding(tree):
    if isinstance(tree, sharding.NamedSharding):
        return tree
    if isinstance(tree, (dict, list, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            found = _first_sharding(v)
            if found is not None:
                return found
    return None


def _blocks(sh, shape) -> int:
    """The distinct blocks ``sh`` splits a tensor of ``shape`` into."""
    n = 1
    for k in sh._splits(len(shape)):
        n *= k
    return n


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


def _member_updates(p: torch.Tensor, g: torch.Tensor, m, v, corrections,
                    opt_cfg: adamw.AdamWConfig, p_sh, n_dp: int):
    """ZeRO-1: each member's AdamW update of its own optimizer block of one
    parameter leaf (module docstring), for the members ``corrections``
    holds (each member's bias corrections, from its own step counter).
    ``p`` and ``g`` are the gathered parameter and the whole gradient;
    ``m`` and ``v`` the leaf's moments (a ``ShardedTensor``, or ``{"q",
    "s"}`` of them); ``p_sh`` the parameter's sharding; ``n_dp`` the DP
    members whose gradients are reduced.  Returns the updated parameter,
    whole (each region written once, by its first member), and the members'
    new moment shards.

    Records the leaf's collectives with ``roofline.count``, the result
    bytes one member receives: the gradient's reduction to the member's
    region (a reduce-scatter, or an all-reduce where the regions do not
    split the leaf) and the updated regions' all-gather back to the
    parameter's block, where the regions split it finer."""
    new_p = torch.empty_like(p)
    int8 = isinstance(m, dict)
    ref = m["q"] if int8 else m
    regions = ref.sharding.member_indices(ref.shape)
    n = p.numel()
    spans = []
    for idx in regions:
        if int8:
            rows = idx[0]
            spans.append((slice(rows.start * adamw.QBLOCK,
                                min(rows.stop * adamw.QBLOCK, n)),))
        else:
            spans.append(idx)
    distinct = len({tuple((s.start, s.stop) for s in r) for r in spans})
    if n_dp > 1:
        extent = [sl.stop - sl.start for sl in spans[0]]
        count.collective("reduce-scatter" if distinct > 1 else "all-reduce",
                         _nbytes(extent, g.dtype), g.device)
    if distinct > _blocks(p_sh, p.shape):
        count.collective("all-gather",
                         _nbytes(p_sh.shard_shape(p.shape), p.dtype),
                         p.device)
    seen = set()
    new_m, new_v = [], []
    for k in corrections:
        region = spans[k]
        if int8:
            lo, hi = region[0].start, region[0].stop
            p_k, g_k = p.reshape(-1)[lo:hi], g.reshape(-1)[lo:hi]
            m_k = {key: m[key].shards[k] for key in ("q", "s")}
            v_k = {key: v[key].shards[k] for key in ("q", "s")}
        else:
            p_k, g_k = p[region], g[region]
            m_k, v_k = m.shards[k], v.shards[k]
        out_p, out_m, out_v = adamw.update_leaf(p_k, g_k, m_k, v_k,
                                                *corrections[k], opt_cfg)
        key = tuple((s.start, s.stop) for s in region)
        if key not in seen:
            seen.add(key)
            if int8:
                new_p.view(-1)[region[0]] = out_p
            else:
                new_p[region] = out_p
        new_m.append(out_m)
        new_v.append(out_v)
    return new_p, new_m, new_v


def _moment(shards: list, like):
    """Members' new moment shards as the tree ``like`` has them."""
    if isinstance(like, dict):
        return {key: sharding.ShardedTensor(
                    [s[key] for s in shards], like[key].sharding,
                    like[key].shape, shards[0][key].dtype)
                for key in like}
    return sharding.ShardedTensor(shards, like.sharding, like.shape,
                                  shards[0].dtype)


def _zero1_apply(params, grads, opt_state, opt_cfg: adamw.AdamWConfig,
                 p_sh, n_dp: int, members=None):
    """AdamW member by member on the ZeRO-1 blocks of ``opt_state`` (placed
    under ``opt_shardings``): ``(params whole, new opt_state placed)``.
    ``p_sh``: the parameters' shardings; ``n_dp``: the DP members whose
    gradients are reduced.  ``members``: only these members' updates, and
    their new states (a step counter and moment tree a member) in place of
    the placed state."""
    counter = opt_state["step"]
    ks = range(len(counter.shards)) if members is None else members
    steps, corrections = [], {}
    for k in ks:                            # each member its own copy
        st, b1c, b2c = adamw.bias_corrections(counter.shards[k], opt_cfg)
        steps.append(st)
        corrections[k] = (b1c, b2c)

    def update(p, g, m, v, sh):
        whole, ms, vs = _member_updates(p, g, m, v, corrections, opt_cfg,
                                        sh, n_dp)
        if members is not None:
            return whole, ms, vs
        return whole, _moment(ms, m), _moment(vs, v)

    # the parameters' structure leads: an int8 moment's {"q", "s"} reaches
    # ``update`` whole, as in ``adamw.apply``
    out = map_tree(update, params, grads, opt_state["m"], opt_state["v"],
                   p_sh)
    new_p, new_m, new_v = (map_tree(lambda o, i=i: o[i], out)
                           for i in range(3))
    if members is not None:
        return new_p, [{"step": st,
                        "m": map_tree(lambda x, j=j: x[j], new_m),
                        "v": map_tree(lambda x, j=j: x[j], new_v)}
                       for j, st in enumerate(steps)]
    step = sharding.ShardedTensor(steps, counter.sharding, counter.shape,
                                  counter.dtype)
    return new_p, {"step": step, "m": new_m, "v": new_v}


def _dp_members(batch) -> int:
    """The DP members a placed batch is split over."""
    x = next(leaves(batch))
    return _blocks(x.sharding, x.shape) \
        if isinstance(x, sharding.ShardedTensor) else 1


def _record_gather(tree) -> None:
    """Record, with ``roofline.count``, an all-gather of each placed leaf of
    ``tree`` split into more than one block: its global bytes, what each
    member receives."""
    for x in leaves(tree):
        if isinstance(x, sharding.ShardedTensor) and \
                _blocks(x.sharding, x.shape) > 1:
            count.collective("all-gather", _nbytes(x.shape, x.dtype),
                             x.device)


def sharded_step(step: Callable, in_shardings,
                 out_shardings=None) -> Callable:
    """``step`` run under the mesh of ``in_shardings`` (module docstring):
    the counterpart of ``jax.jit(step, in_shardings=in_shardings,
    out_shardings=out_shardings)`` traced under ``sharding.use_mesh(mesh,
    policy)``.  ``in_shardings``: a tuple, one tree of ``NamedSharding`` s
    an argument of ``step`` (None: that argument as it is);
    ``out_shardings``: a tree like the step's outputs (None: the outputs
    whole, on the mesh's device).  The step runs under the sharding
    policy current when this is called, as a jitted step keeps the one it
    was traced under.  A train step of :func:`build_train_step` runs its
    optimizer member by member on the ZeRO-1 blocks, so its ``opt_state``
    must be placed by ``opt_shardings``; any other step runs whole on the
    gathered inputs."""
    mesh = _first_sharding(in_shardings).mesh
    mesh.member_device()
    policy = sharding.current_policy()
    train = getattr(step, "loss_and_grads", None)

    def run(*args):
        if len(args) != len(in_shardings):
            raise TypeError(f"{len(args)} arguments for "
                            f"{len(in_shardings)} in_shardings")
        placed = [sharding.place(a, s) for a, s in zip(args, in_shardings)]
        with sharding.use_mesh(mesh, policy):
            if train is None:
                out = step(*sharding.gather(placed))
            else:
                params, opt_state, batch = placed
                _record_gather(params)
                full = sharding.gather(params)
                loss, grads = train(full, sharding.gather(batch))
                new_p, new_o = _zero1_apply(full, grads, opt_state,
                                            step.opt_cfg, in_shardings[0],
                                            _dp_members(batch))
                del full, grads
                out = (new_p, new_o, loss)
        return sharding.gather(out) if out_shardings is None \
            else sharding.place(out, out_shardings)

    return run


def _dp_block(x, member: int, dp_axes):
    """``x``'s block of ``member`` with only the DP axes split: what the
    member computes on, since compute is not split over ``model``.  A
    placed leaf whose own block is smaller is gathered over its other axes
    (an all-gather recorded with ``roofline.count``: the block's bytes);
    other leaves as they are."""
    if isinstance(x, dict):
        return {k: _dp_block(v, member, dp_axes) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_dp_block(v, member, dp_axes) for v in x)
    if not isinstance(x, sharding.ShardedTensor):
        return x
    kept = sharding.P(*(tuple(a for a in ((part,) if isinstance(part, str)
                                          else part or ()) if a in dp_axes)
                        or None for part in x.sharding.spec))
    dp_sh = sharding.NamedSharding(x.sharding.mesh, kept)
    if _blocks(dp_sh, x.shape) == _blocks(x.sharding, x.shape):
        return x.shards[member]
    want = dp_sh.member_indices(x.shape)[member]
    shape = dp_sh.shard_shape(x.shape)
    count.collective("all-gather", _nbytes(shape, x.dtype), x.device)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    seen = set()
    for idx, shard in zip(x.sharding.member_indices(x.shape), x.shards):
        key = tuple((s.start, s.stop) for s in idx)
        if key in seen or any(s.start < w.start or s.stop > w.stop
                              for s, w in zip(idx, want)):
            continue
        seen.add(key)
        out[tuple(slice(s.start - w.start, s.stop - w.start)
                  for s, w in zip(idx, want))] = shard
    return out


def member_step(step: Callable, in_shardings, member: int = 0) -> Callable:
    """Member ``member``'s share of ``sharded_step(step, in_shardings)``:
    the program one member runs where each member holds a device of its
    own, with compute not split over ``model`` (ROADMAP.md Queue 1 item
    11c).  It takes the placed arguments and reads only the member's
    blocks: each argument is gathered to the member's DP block (the
    parameters whole, a decode cache's heads over ``model``; the batch is
    the member's own block), the step runs on that block without a mesh
    (the MoE's one group is the member's tokens, as each of the
    reference's DP groups is a device's), and a train step of
    :func:`build_train_step` then reduces its gradient to the member's
    ZeRO-1 region, updates it and gathers the regions back.  Every
    collective is recorded with ``roofline.count``, the result bytes the
    member receives.  Returns the step's outputs for the member: a train
    step's ``(params whole, {"step", "m", "v"} of the member, loss)``.
    The dry-run (``launch/dryrun.py``) counts this program on ``meta``
    tensors."""
    mesh = _first_sharding(in_shardings).mesh
    with sharding.use_mesh(mesh, sharding.current_policy()):
        dp_axes = sharding.dp_axes(mesh)
    train = getattr(step, "loss_and_grads", None)

    def run(*placed):
        if train is None:
            return step(*_dp_block(placed, member, dp_axes))
        params, opt_state, batch = placed
        full = _dp_block(params, member, dp_axes)
        loss, grads = train(full, _dp_block(batch, member, dp_axes))
        new_p, (state,) = _zero1_apply(full, grads, opt_state, step.opt_cfg,
                                       in_shardings[0], _dp_members(batch),
                                       members=(member,))
        return new_p, state, loss

    return run
