"""The port's MoE block (``repro_torch.models.moe``) held to the JAX
package's (``repro.models.moe``) on the CPU, in float32.

Routing tables (``_dispatch_group``) must equal the reference's exactly on
inputs whose logits both packages compute exactly: the token of every
(expert, slot), capacity drops and planted ties included; the gates
within one float32 ulp (``softmax``'s ``exp`` is another implementation).  ``moe_ffn`` within ``rtol=1e-4, atol=1e-5`` (the
forward tolerance of ``tests/test_torch_models.py``).  Weights are the
reference's ``init_moe`` carried across by ``params_from_numpy``; inputs
come from numpy with a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as rmoe
from repro_torch.models import model, moe

D, F, E = 64, 48, 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carried(n_shared=0, act="swiglu", seed=0):
    rp = rmoe.init_moe(jax.random.key(seed), D, F, E, n_shared, act,
                       jnp.float32)
    return rp, model.params_from_numpy(_np(rp), "cpu")


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64)).max(initial=0)


def _tables(xt, router, K, C):
    want = rmoe._dispatch_group(jnp.asarray(xt), jnp.asarray(router), E, K,
                                C)
    got = moe._dispatch_group(torch.from_numpy(xt), torch.from_numpy(router),
                              E, K, C)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("case", ["dropless", "drops", "ties"])
def test_dispatch_tables_equal_the_reference(case):
    """Dyadic inputs, so the router's logits are exact in both packages
    whatever order their matmuls sum in, and the tables compare the
    dispatch alone.  ``dropless``: C = T; ``drops``: C = 8 of 64 tokens
    top-2, so most experts overflow and the assignments past C fall into
    the drop slot; ``ties``: small integers, so the logits tie at the k-th
    place in half the rows or more and the order among equal logits decides
    each route (lowest expert first, as ``lax.top_k``)."""
    rng = np.random.default_rng({"dropless": 1, "drops": 2, "ties": 3}[case])
    T, K = 64, 2
    if case == "ties":
        xt = rng.integers(-1, 2, (T, 4)).astype(np.float32)
        router = rng.integers(-1, 2, (4, E)).astype(np.float32)
        srt = -np.sort(-(xt @ router), axis=1)
        assert (srt[:, K - 1] == srt[:, K]).mean() >= 0.5   # planted ties
    else:
        xt = (rng.integers(-64, 65, (T, D)) / 32).astype(np.float32)
        router = (rng.integers(-64, 65, (D, E)) / 256).astype(np.float32)
    C = {"dropless": T, "drops": 8, "ties": T}[case]
    (tw, gw), (tg, gg) = _tables(xt, router, K, C)
    assert tg.dtype == np.int32 and gg.dtype == np.float32
    assert tg.shape == gg.shape == (E, C)
    np.testing.assert_array_equal(tg, tw)
    assert _ulps(gg, gw) <= 1
    routed = np.bincount(tw[tw < T], minlength=T)
    if case == "drops":
        assert routed.sum() < T * K            # drops happened
    else:
        assert routed.sum() == T * K


def test_top_k_breaks_ties_lowest_index_first():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    vals, ids = moe.top_k(x, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
    assert ids.tolist() == [[1, 2, 4], [0, 1, 2]]


@pytest.mark.parametrize("S,cf,decode_global,n_shared", [
    (16, 1.25, True, 0),       # forward: G = 1, capacity 1.25 (drops)
    (16, 4.0, True, 1),        # kimi-k2's shared expert, dropless
    (1, 1.25, True, 0),        # decode, global dispatch
    (1, 1.25, False, 0),       # decode, per-group dispatch
])
def test_moe_ffn_matches_reference(S, cf, decode_global, n_shared):
    rp, pp = _carried(n_shared=n_shared)
    x = np.random.default_rng(S).standard_normal((4, S, D)).astype(
        np.float32)
    kw = dict(n_experts=E, top_k=2, capacity_factor=cf, act="swiglu",
              decode_global=decode_global)
    want = rmoe.moe_ffn(rp, jnp.asarray(x), **kw)
    got = moe.moe_ffn(pp, torch.from_numpy(x), **kw)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_quantized_expert_weights_match_reference():
    """``quantize_expert_weights``: ``q`` equal, ``s`` within one ulp; the
    ``{"q", "s"}`` leaves cross by ``params_from_numpy`` as int8 and
    float32, and ``moe_ffn`` expands them at use (``_expert_w``) as the
    reference does."""
    rp, pp = _carried(seed=4)
    rq = rmoe.quantize_expert_weights(rp)
    pq = moe.quantize_expert_weights(pp)
    carried = model.params_from_numpy(_np(rq), "cpu")
    for key in ("w_up", "w_gate", "w_down"):
        want = _np(rq[key])
        assert want["q"].dtype == np.int8
        np.testing.assert_array_equal(pq[key]["q"].numpy(), want["q"])
        assert pq[key]["s"].dtype == torch.float32
        assert pq[key]["s"].shape == want["s"].shape
        assert _ulps(pq[key]["s"].numpy(), want["s"]) <= 1
        assert carried[key]["q"].dtype == torch.int8
        assert torch.equal(carried[key]["q"], pq[key]["q"])
    x = np.random.default_rng(6).standard_normal((2, 8, D)).astype(
        np.float32)
    kw = dict(n_experts=E, top_k=2, capacity_factor=4.0)
    want = rmoe.moe_ffn(rq, jnp.asarray(x), **kw)
    got = moe.moe_ffn(carried, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_init_moe_has_the_reference_tree():
    want = _np(rmoe.init_moe(jax.random.key(0), D, F, E, 1, "swiglu",
                             jnp.float32))
    got = moe.init_moe(torch.Generator().manual_seed(0), D, F, E, 1,
                       "swiglu", torch.float32, "cpu", n_layers=3)
    flat_w = {k: v for k, v in want.items() if k != "shared"}
    for k, v in flat_w.items():
        assert tuple(got[k].shape) == (3,) + v.shape, k
        assert float(got[k].std()) == pytest.approx(float(v.std()),
                                                     rel=0.1), k
    assert sorted(got["shared"]) == sorted(want["shared"])
    for k, v in want["shared"].items():
        assert tuple(got["shared"][k].shape) == (3,) + v.shape, k
