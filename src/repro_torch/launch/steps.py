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

:func:`member_step` is the other form of the same program: what one
member runs where it holds a device of its own, in a process of its own
(``launch.mesh.spawn``, collectives over a ``torch.distributed`` process
group), or on ``meta`` tensors in the dry-run.  It takes only the
member's blocks and computes only the member's share: under ``tp`` its
``model`` share of every split leaf (column and row tensor parallelism,
the vocab-parallel cross entropy, experts over ``model``; ``models``),
under both policies its DP block of the batch, and its ZeRO-1 region of
the optimizer.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.tree import leaves, map_tree, rebuild
from repro_torch.distributed import sharding, spmd
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

    def grads_of(params, batch):
        flat = list(leaves(params))
        live = [p.detach().requires_grad_() for p in flat]
        loss = model.loss_fn(cfg, rebuild(params, live), batch["tokens"],
                             batch["labels"], batch.get("prefix_emb"),
                             remat=remat)
        # a leaf the loss does not read (a non-parametric norm's
        # placeholder) has a zero gradient, as jax.grad gives it
        got = torch.autograd.grad(loss, live, allow_unused=True)
        return loss.detach(), rebuild(
            params, [torch.zeros_like(p) if g is None else g
                     for p, g in zip(flat, got)])

    def loss_and_grads(params, batch):
        loss, grads = grads_of(params, batch)
        if grad_compressor is not None:
            grads = grad_compressor(grads)
        return loss, grads

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch)
        params, opt_state = adamw.apply(params, grads, opt_state, opt_cfg)
        return params, opt_state, loss

    train_step.loss_and_grads = loss_and_grads
    train_step.grads_of = grads_of
    train_step.grad_compressor = grad_compressor
    train_step.opt_cfg = opt_cfg
    train_step.kind = "train"
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
        return model.logits(cfg, params, x[:, -1:])

    prefill_step.kind = "prefill"
    return prefill_step


def build_serve_step(cfg: ArchConfig):
    """``serve_step(params, cache, batch) -> (logits, cache)``: one decode
    step."""

    @torch.no_grad()
    def serve_step(params, cache, batch):
        return model.decode_step(cfg, params, cache, batch["tokens"])

    serve_step.kind = "serve"
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
                 p_sh, n_dp: int):
    """AdamW member by member on the ZeRO-1 blocks of ``opt_state`` (placed
    under ``opt_shardings``): ``(params whole, new opt_state placed)``.
    ``p_sh``: the parameters' shardings; ``n_dp``: the DP members whose
    gradients are reduced."""
    counter = opt_state["step"]
    steps, corrections = [], {}
    for k in range(len(counter.shards)):     # each member its own copy
        st, b1c, b2c = adamw.bias_corrections(counter.shards[k], opt_cfg)
        steps.append(st)
        corrections[k] = (b1c, b2c)

    def update(p, g, m, v, sh):
        whole, ms, vs = _member_updates(p, g, m, v, corrections, opt_cfg,
                                        sh, n_dp)
        return whole, _moment(ms, m), _moment(vs, v)

    # the parameters' structure leads: an int8 moment's {"q", "s"} reaches
    # ``update`` whole, as in ``adamw.apply``
    out = map_tree(update, params, grads, opt_state["m"], opt_state["v"],
                   p_sh)
    new_p, new_m, new_v = (map_tree(lambda o, i=i: o[i], out)
                           for i in range(3))
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


def _zero1_dim(p_spec, m_spec, ndim: int):
    """The dimension ZeRO-1 splits over ``data`` in the moment's spec and
    not in the parameter's (None: the moment lies as its parameter)."""
    for d in range(ndim):
        pa = spmd.axes_of(p_spec[d] if d < len(p_spec) else None)
        ma = spmd.axes_of(m_spec[d] if d < len(m_spec) else None)
        if "data" in ma and "data" not in pa:
            return d
    return None


def _dp_reduce(g: torch.Tensor, member, dim) -> torch.Tensor:
    """The DP members' mean of ``g``, this member's ZeRO-1 block of it
    along ``dim`` over ``data`` (None: whole): reduce-scattered over
    ``data`` where the batch is split over it, its block taken where not,
    and all-reduced over the batch's other axes."""
    n_dp = 1
    for a in member.batch_axes:
        n_dp *= member.size(a)
        if a == "data" and dim is not None:
            g = spmd.reduce_scatter(g, "data", dim)
        else:
            g = spmd.all_reduce(g, a)
    if dim is not None and "data" not in member.batch_axes:
        size = g.shape[dim] // member.size("data")
        g = g.narrow(dim, member.coord("data") * size, size)
    return g / n_dp if n_dp > 1 else g


def _qblock_aligned(region, shape) -> bool:
    """Whether a block of a leaf meets the wire's quantization blocks (of
    the leaf's flat values) only whole: its runs in flat order start and
    end on ``QBLOCK`` boundaries."""
    from repro_torch.optim import grad_compress as gc
    last = next((d for d in reversed(range(len(shape)))
                 if (region[d].start, region[d].stop) != (0, shape[d])),
                None)
    if last is None:
        return True
    inner = 1
    for n in shape[last + 1:]:
        inner *= int(n)
    run = (region[last].stop - region[last].start) * inner
    return all(v % gc.QBLOCK == 0 for v in (run, region[last].start * inner,
                                             int(shape[last]) * inner))


def _wire(g: torch.Tensor, compressor, region, spec, shape):
    """The gradient wire on a member's block ``g`` (its region of the
    leaf, under ``spec``): as the whole leaf's wire gives it, where the
    block meets the quantization blocks whole; else the leaf is gathered,
    compressed and the block taken."""
    if compressor is None:
        return g
    if _qblock_aligned(region, shape):
        return compressor(g)
    whole = compressor(spmd.relayout(g, spec, sharding.P()))
    return spmd.relayout(whole, sharding.P(), spec)


def _member_leaf(p, g, m, v, p_sh, m_sh, member, corrections, opt_cfg,
                 compressor):
    """One leaf's ZeRO-1 update in a member's program: ``(the member's new
    parameter block, new m, new v)`` (module docstring)."""
    pspec = p_sh.spec
    if isinstance(m, dict):           # int8: flat blocks of the whole leaf
        return _member_leaf_int8(p, g, m, v, p_sh, m_sh, member,
                                 corrections, opt_cfg, compressor)
    shape = _global_shape(p, pspec, member)
    dim = _zero1_dim(pspec, m_sh.spec, len(shape))
    g = _dp_reduce(g, member, dim)
    region = m_sh.member_indices(shape)[member.index]
    g = _wire(g, compressor, region, m_sh.spec, shape)
    if dim is not None:
        size = p.shape[dim] // member.size("data")
        p_r = p.narrow(dim, member.coord("data") * size, size)
    else:
        p_r = p
    new_p, new_m, new_v = adamw.update_leaf(p_r, g, m, v, *corrections,
                                            opt_cfg)
    if dim is not None:
        new_p = spmd.all_gather(new_p, "data", dim)
    return new_p, new_m, new_v


def _member_leaf_int8(p, g, m, v, p_sh, m_sh, member, corrections, opt_cfg,
                      compressor):
    """:func:`_member_leaf` for int8 moments (``{"q": (nb, QBLOCK), "s"}``
    over ``data`` on ``nb``, never over ``model``): the member's region is
    a flat range of whole blocks of the whole leaf, so the gradient and the
    parameter are gathered over ``model`` first and the updated range is
    gathered back over ``data``."""
    pspec = p_sh.spec
    shape = _global_shape(p, pspec, member)
    n = int(np.prod(shape))
    Q = adamw.QBLOCK
    nb = -(-n // Q)
    qspec = m_sh["q"].spec
    split = spmd.axes_of(qspec[0] if len(qspec) else None) == ("data",)
    flat = spmd.relayout(g, pspec, sharding.P()).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, nb * Q - n))
    flat = _dp_reduce(flat, member, 0 if split else None)
    rows = nb // member.size("data") if split else nb
    lo = member.coord("data") * rows * Q if split else 0
    hi = min(lo + rows * Q, n)
    region = (slice(lo, hi),)
    g_r = _wire(flat[:hi - lo], compressor, region, sharding.P(), (n,))
    p_r = spmd.relayout(p, pspec, sharding.P()).reshape(-1)[lo:hi]
    new_p, new_m, new_v = adamw.update_leaf(p_r, g_r, m, v, *corrections,
                                            opt_cfg)
    if split:
        new_p = spmd.all_gather(torch.nn.functional.pad(
            new_p, (0, rows * Q - (hi - lo))), "data", 0)[:n]
    return (spmd.relayout(new_p.reshape(shape), sharding.P(), pspec),
            new_m, new_v)


def _global_shape(block: torch.Tensor, spec, member) -> tuple:
    """The global shape of a tensor whose member block is ``block`` under
    ``spec``."""
    out = []
    for d, n in enumerate(block.shape):
        k = 1
        for a in spmd.axes_of(spec[d] if d < len(spec) else None):
            k *= member.size(a)
        out.append(int(n) * k)
    return tuple(out)


def _member_train(step, params, opt_state, batch, p_sh, o_sh, member):
    """A train step of :func:`build_train_step` in a member's program:
    ``(new parameter blocks, {"step", "m", "v"} blocks, loss)``."""
    loss, grads = step.grads_of(params, batch)
    n_dp = 1
    for a in member.batch_axes:
        n_dp *= member.size(a)
        loss = spmd.all_reduce(loss, a)
    loss = loss / n_dp if n_dp > 1 else loss
    st, b1c, b2c = adamw.bias_corrections(opt_state["step"], step.opt_cfg)

    def update(p, g, m, v, psh, msh):
        return _member_leaf(p, g, m, v, psh, msh, member, (b1c, b2c),
                            step.opt_cfg, step.grad_compressor)

    # the parameters' structure leads: an int8 moment's {"q", "s"} (and
    # its shardings) reach ``update`` whole
    out = map_tree(update, params, grads, opt_state["m"], opt_state["v"],
                   p_sh, o_sh["m"])
    del grads
    new_p, new_m, new_v = (map_tree(lambda o, i=i: o[i], out)
                           for i in range(3))
    return new_p, {"step": st, "m": new_m, "v": new_v}, loss.detach()


def _relayout_tree(tree, have, want):
    """Each tensor leaf of ``tree`` moved from its block under ``have`` (a
    tree of ``NamedSharding`` s) to its block under ``want``."""
    if isinstance(tree, dict):
        return {k: _relayout_tree(v, have[k], want[k])
                for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor) or want is None:
        return tree
    return spmd.relayout(tree, have.spec, want.spec)


def member_step(step: Callable, in_shardings, out_shardings=None, *,
                member) -> Callable:
    """The program one member of ``in_shardings``' mesh runs where each
    member holds a device of its own: the reference's program under
    ``sharding.use_mesh(mesh, policy)`` split as XLA splits it, for a step
    of :func:`build_train_step`, :func:`build_prefill_step` or
    :func:`build_serve_step`.  ``member``: a ``distributed.spmd.Member``
    of that mesh (``Member.join`` in a process of a world; on ``meta``,
    ``Member.counting``, which the dry-run counts), whose policy the
    program follows.

    The returned function takes the member's blocks of the arguments
    under ``in_shardings`` (plain tensors: a parameter's block under
    ``param_specs``, the batch's rows over the DP axes ``batch_spec``
    splits it over, the cache's block under ``cache_spec``, a moment's
    ZeRO-1 block under ``opt_specs``) and returns the member's blocks of
    the outputs under ``out_shardings`` (None: as the member holds them,
    the logits over the batch's DP axes).  Under ``tp`` the member holds
    and computes only its ``model`` share of every split leaf (``models``:
    heads, hidden units, experts, vocabulary, channels; the
    collectives of ``distributed.spmd`` over ``model``); under ``dp`` the
    ``model`` axis joins data parallelism and the weights are whole.  The
    MoE's one group is the member's tokens, as each of the reference's DP
    groups is a device's (a decode step's global dispatch gathers the
    batch).

    A train step then reduces its gradient over the batch's DP axes to the
    member's ZeRO-1 region (a reduce-scatter over ``data`` on the
    dimension ``opt_specs`` splits, an all-reduce over ``pod``; the mean
    over the DP members) in the gradient's dtype, puts it through the
    step's ``grad_compressor`` as ``build_train_step`` does (the region's values are the whole leaf's: it is compressed on
    its own where it meets the wire's quantization blocks whole, else the
    leaf is gathered first), runs AdamW on the region and all-gathers the
    updated regions over ``data`` back to the member's parameter block; an
    int8 moment's region, a flat range of whole blocks of the leaf, is
    updated on the leaf gathered over ``model``.  The loss is the DP
    members' mean, all-reduced.  A split leaf's gradient stays the
    member's; a replicated leaf's (the norms, the router) is the whole
    gradient on every member, the reference's.  Every collective is
    recorded with ``roofline.count``."""
    kind = getattr(step, "kind", None)
    if kind not in ("train", "prefill", "serve"):
        raise TypeError("member_step runs the steps of build_train_step, "
                        "build_prefill_step and build_serve_step")
    mesh = _first_sharding(in_shardings).mesh
    if dict(mesh.shape) != member.shape:
        raise ValueError(f"{member} is not a member of {mesh}")
    tokens_sh = in_shardings[-1]["tokens"]
    bentry = tokens_sh.spec[0] if len(tokens_sh.spec) else None
    member = member.with_batch(spmd.axes_of(bentry))

    def run(*blocks):
        with spmd.use(member):
            if kind == "train":
                params, opt_state, batch = blocks
                p, o, loss = _member_train(step, params, opt_state, batch,
                                           in_shardings[0], in_shardings[1],
                                           member)
                if out_shardings is None:
                    return p, o, loss
                return (_relayout_tree(p, in_shardings[0],
                                       out_shardings[0]),
                        _relayout_tree(o, in_shardings[1],
                                       out_shardings[1]), loss)
            out = step(*blocks)
            logits = out if kind == "prefill" else out[0]
            have = sharding.NamedSharding(mesh, sharding.P(bentry))
            want = out_shardings if kind == "prefill" else (
                None if out_shardings is None else out_shardings[0])
            if want is not None:
                logits = spmd.relayout(logits, have.spec, want.spec)
            if kind == "prefill":
                return logits
            cache = out[1]
            if out_shardings is not None:
                cache = _relayout_tree(cache, in_shardings[1],
                                       out_shardings[1])
            return logits, cache

    return run
