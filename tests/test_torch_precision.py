"""How far bf16 rounding moves the recurrent families' logits, in both
packages: the same model (``reduced()`` widths, the registered depth
schedule: zamba2's shared block every sixth layer) in float32, in bf16 on
the same weights, and in float32 on row 0 alone, at growing depth.

At random init the RWKV6 and Mamba2 stacks carry a rounding through every
layer and do not damp it, so bf16's distance from float32 grows with
depth until it reaches the logits' own size; the reference does the same
as the port.  That is why ``chip_smoke.py`` holds these families' bf16
decode to ``forward`` only loosely and their float32 decode tightly.

Run as a script for the table at depth (CPU, a minute or two)::

    PYTHONPATH=src python tests/test_torch_precision.py --width 256 \\
        --depths 2,6,12,24,54 [--decode]
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model as rmodel
from repro_torch import configs as pconfigs
from repro_torch.core.tree import map_tree
from repro_torch.models import model

ARCHS = ["rwkv6-1.6b", "zamba2-2.7b"]


def _cfg(configs, arch: str, depth: int, width: int):
    base = configs.get_arch(arch)
    return dataclasses.replace(
        configs.reduced(base, n_layers=depth, d_model=width, vocab=512),
        attn_every=base.attn_every)


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, vocab, (4, 32)).astype(
        np.int32)


def port_row(arch: str, depth: int, width: int,
             decode: bool = False) -> dict:
    """The port's (max |logit|, |row 0 alone - batched| in float32, |bf16
    forward - float32 forward|), weights drawn from seed 0; with
    ``decode``, also |``decode_step`` over the 32 positions - forward| in
    float32."""
    cfg = _cfg(pconfigs, arch, depth, width)
    p = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p16 = map_tree(lambda t: t.to(torch.bfloat16), p)
    tok = torch.from_numpy(_tokens(cfg.vocab))
    with torch.no_grad():
        full = model.forward(cfg, p, tok)
        alone = model.forward(cfg, p, tok[:1])
        half = model.forward(dataclasses.replace(cfg, dtype="bfloat16"), p16,
                             tok).float()
        row = {"logit": float(full.abs().max()),
               "alone": float((alone - full[:1]).abs().max()),
               "bf16": float((half - full).abs().max())}
        if decode:
            cache = model.init_cache(cfg, 4, 40, device="cpu")
            dec = []
            for i in range(tok.shape[1]):
                lg, cache = model.decode_step(cfg, p, cache, tok[:, i:i + 1])
                dec.append(lg)
            row["decode"] = float((torch.cat(dec, 1) - full).abs().max())
    return row


def reference_row(arch: str, depth: int, width: int, alone: bool = True,
                  decode: bool = False) -> dict:
    """The same numbers from the JAX package, weights from its key 0
    (without ``alone``, no row 0 alone: one program fewer to compile)."""
    cfg = _cfg(rconfigs, arch, depth, width)
    p = rmodel.init_params(cfg, jax.random.key(0))
    p16 = jax.tree.map(lambda t: t.astype(jnp.bfloat16), p)
    tok = jnp.asarray(_tokens(cfg.vocab))
    fwd = jax.jit(rmodel.forward, static_argnums=0)
    full = fwd(cfg, p, tok)
    one = fwd(cfg, p, tok[:1]) if alone else full[:1]
    half = fwd(dataclasses.replace(cfg, dtype="bfloat16"), p16,
               tok).astype(jnp.float32)
    row = {"logit": float(jnp.abs(full).max()),
           "alone": float(jnp.abs(one - full[:1]).max()),
           "bf16": float(jnp.abs(half - full).max())}
    if decode:
        step = jax.jit(lambda c, t: rmodel.decode_step(cfg, p, c, t))
        cache = rmodel.init_cache(cfg, 4, 40)
        dec = []
        for i in range(tok.shape[1]):
            lg, cache = step(cache, tok[:, i:i + 1])
            dec.append(lg)
        row["decode"] = float(jnp.abs(jnp.concatenate(dec, 1) - full).max())
    return row


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_rounding_grows_with_depth_alike_in_both_packages(arch):
    """At 2 and 12 layers (width 128): in each package bf16's distance
    from float32 grows at least threefold with depth, the port's lies
    within a factor of 3 of the reference's at each depth (different
    random draws of the same distributions), and float32 moves the port's
    row 0 alone by less than 1e-3."""
    rows = {d: (port_row(arch, d, 128),
                reference_row(arch, d, 128, alone=False)) for d in (2, 12)}
    for d, (got, want) in rows.items():
        assert 1 / 3 < got["bf16"] / want["bf16"] < 3, (d, got, want)
        assert got["alone"] < 1e-3, (d, got)
    for i in range(2):
        assert rows[12][i]["bf16"] > 3 * rows[2][i]["bf16"], rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--depths", default="2,6,12,24,54")
    ap.add_argument("--decode", action="store_true",
                    help="also decode_step against forward in float32")
    args = ap.parse_args()
    print("arch depth package max|logit| f32-row0-alone bf16-vs-f32"
          + (" f32-decode-vs-forward" if args.decode else ""))
    for arch in ARCHS:
        for d in (int(x) for x in args.depths.split(",")):
            for name, fn in (("port", port_row), ("reference",
                                                  reference_row)):
                r = fn(arch, d, args.width, decode=args.decode)
                print(f"{arch} {d} {name} {r['logit']:.3f} "
                      f"{r['alone']:.3e} {r['bf16']:.3e}"
                      + (f" {r['decode']:.3e}" if args.decode else ""),
                      flush=True)


if __name__ == "__main__":
    main()
