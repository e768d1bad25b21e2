"""Roofline terms against one NVIDIA H100 SXM, and the port's analytic
bounds.

The counterpart of ``repro/roofline/analysis.py``::

    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

The reference reads its counts from ``compiled.cost_analysis()`` and
parses collective bytes out of XLA's optimized HLO; the port has no
compiler and no HLO, so :func:`analyze` reads the record of
``roofline.count.count_costs`` (the ops the port's program dispatches, and
the result bytes its explicit collective sites report), and the HLO parser
has no counterpart.

The analytic bounds (:func:`decode_bound_ms`, :func:`matmul_bound`,
:func:`decode_step_bytes`, :func:`train_step_bound`) give the least time
of a decode launch, a dequant matmul, a decode step and a train step from
shapes alone: each input read once and each output written once over
``HBM_BW``, operations over ``PEAK_FLOPS``.  ``chip_smoke.py`` prints
every measured time beside them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# NVIDIA H100 SXM5 80 GB, NVIDIA's H100 Tensor Core GPU data sheet (dense
# rates, no sparsity, at the full 700 W power limit)
PEAK_FLOPS = 989e12       # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12          # device memory bytes/s
# NVLink 4: 18 links of 25 GB/s a direction, one direction of one GPU; the
# card's counterpart of the reference's ICI_BW (it has no ICI)
LINK_BW = 450e9


@dataclasses.dataclass
class Roofline:
    flops: float                  # per device
    hbm_bytes: float              # per device
    coll_bytes: float             # per device
    coll_by_op: Dict[str, int]
    model_flops: float            # global useful FLOPs (6ND / 2ND)
    n_chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs summed over chips)."""
        total = self.flops * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on achievable MFU given the dominant term."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / self.n_chips / PEAK_FLOPS) / self.t_bound

    def to_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "coll_by_op": self.coll_by_op,
            "model_flops": self.model_flops,
            "n_chips": self.n_chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_ratio,
            "mfu_bound": self.mfu_bound,
        }


def analyze(counts, model_flops: float, n_chips: int) -> Roofline:
    """The roofline of one device's counts (a ``count.Costs``: ``flops``,
    ``bytes``, ``coll`` by kind)."""
    return Roofline(
        flops=float(counts.flops),
        hbm_bytes=float(counts.bytes),
        coll_bytes=float(sum(counts.coll.values())),
        coll_by_op={k: int(v) for k, v in counts.coll.items()},
        model_flops=model_flops,
        n_chips=n_chips,
    )


def model_flops_for(cfg, shape) -> float:
    """6·N_active·tokens for train, 2·N_active·tokens for inference."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


# --------------------------------------------------------------------------
# the analytic bounds
# --------------------------------------------------------------------------

# LUT bytes a chunk: tdeflate's i16 + i8 pairs for litlen and distance,
# huffman's one pair
LUT_BYTES = {"tdeflate": 2 * (2 + 1) * 4096, "huffman": (2 + 1) * 4096}


def decode_bound_ms(codec: str, comp_bytes: int, n: int, chunk_elems: int,
                    width: int) -> float:
    """Least time for one decode of n rows, at the card's memory rate: each
    input read once (the compressed bytes; out_lens, except for bitpack,
    which does not read them; the per-chunk LUTs of tdeflate and huffman),
    the (n, chunk_elems) output written once."""
    read = comp_bytes + (0 if codec == "bitpack" else 4 * n)
    read += LUT_BYTES.get(codec, 0) * n
    return (read + n * chunk_elems * width) / HBM_BW * 1e3


def matmul_bound(m: int, n: int, k: int, x_bytes: int):
    """(least ms, what bounds it) of one y = x @ (q * s): the larger of x,
    q (one byte a weight) and s read once and y written once over the
    memory rate, and 2*m*n*k operations over the dense bf16 tensor-core
    peak."""
    moved = m * k * x_bytes + k * n + 4 * n + m * n * x_bytes
    by_bytes = moved / HBM_BW * 1e3
    by_ops = 2 * m * n * k / PEAK_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations"


def tree_bytes(tree) -> int:
    from repro_torch.core.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def shared_apps(cfg) -> int:
    """Applications of the hybrid's shared block in one pass."""
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def decode_step_bytes(cfg, params, cache, batch: int):
    """The least bytes of one decode step: every block weight and the head
    read once (an MoE's every expert: each computes its slots; the hybrid's
    shared block once an application, since its ~210 MB outlive the 50 MB
    L2), ``batch`` rows of the embedding, the attention caches read whole
    (every position is scored), the recurrent states read and written.
    Returns (total, weights, attention caches, recurrent states)."""
    emb = params["embed"]
    weights = (tree_bytes(params) - emb.numel() * emb.element_size()
               + batch * emb.shape[1] * emb.element_size())
    if shared_apps(cfg):
        weights += (shared_apps(cfg) - 1) * tree_bytes(params["shared_block"])
    kv = sum(cache[k].numel() * cache[k].element_size()
             for k in ("k", "v") if k in cache)
    state = sum(2 * cache[k].numel() * cache[k].element_size()
                for k in ("wkv", "x_att", "x_ffn", "ssm", "conv")
                if k in cache)
    return weights + kv + state, weights, kv, state


def train_step_bound(cfg, params, batch: int, seq: int):
    """The least time of one training step on this card, in ms, what bounds
    it, and its FLOP and bytes, from the parameter tree.  Operations: 6
    FLOP a parameter a token for the matmuls a token passes through
    (forward and backward; an untied embedding table is gathered, not
    multiplied; an MoE token through its ``top_k`` experts, not all of
    them and not the capacity padding; the hybrid's shared block once an
    application) plus causal attention's scores and weighted sum (3 x 2 x
    B x H x hd x S(S+1) FLOP an attention layer or application, forward
    and backward), at the bf16 peak.  Bytes: every parameter read and
    written once, with its two int8 moments and their float32 scales (one
    a block of 128), and a recurrent mixer's state read and written once a
    layer in each of the three passes (forward, the remat recompute,
    backward)."""
    from repro_torch.core.tree import leaves
    n = sum(t.numel() for t in leaves(params))
    per_token = n - (0 if cfg.tie_embeddings else params["embed"].numel())
    if cfg.is_moe:
        moe = params["blocks"]["moe"]
        experts = sum(moe[k].numel() for k in ("w_up", "w_gate", "w_down"))
        per_token -= experts - experts * cfg.top_k // cfg.n_experts
    if shared_apps(cfg):
        per_token += (shared_apps(cfg) - 1) * sum(
            t.numel() for t in leaves(params["shared_block"]))
    attn_layers = (cfg.n_layers if cfg.mixer == "attn"
                   else shared_apps(cfg))
    flops = (6 * per_token * batch * seq
             + 6 * attn_layers * batch * cfg.n_heads * cfg.hd * seq
             * (seq + 1))
    param_bytes = params["embed"].element_size()
    nbytes = 2 * n * (param_bytes + 2 * (1 + 4 / 128))
    if cfg.mixer == "rwkv6":
        hd = cfg.d_model // cfg.n_heads
        nbytes += 3 * 2 * 4 * cfg.n_layers * batch * cfg.n_heads * hd * hd
    elif cfg.mixer == "mamba2":
        nbytes += (3 * 2 * 4 * cfg.n_layers * batch
                   * (2 * cfg.d_model // cfg.hd) * cfg.hd * cfg.ssm_state)
    flop_ms = flops / PEAK_FLOPS * 1e3
    byte_ms = nbytes / HBM_BW * 1e3
    if flop_ms >= byte_ms:
        return flop_ms, "operations", flops, nbytes
    return byte_ms, "bytes", flops, nbytes
