"""The port's model stack (``repro_torch.configs``, ``models/{layers,
attention,moe,ssm,model}.py``) held to the JAX package on the CPU, for
every registered family: dense, MoE (qwen3-moe, kimi-k2 with its shared
expert), RWKV6 and the Mamba2 hybrid (zamba2, its shared block applied
after every second layer at ``reduced()``).

Both packages compute on the same weights: the reference's
``init_params`` draws them and ``model.params_from_numpy`` carries them
across; inputs come from numpy with a seed.  Sizes are ``reduced()``
(2 layers, d_model 128, vocab 512, float32; MoE: 8 experts, top-2,
dropless capacity).  Tolerances: forward logits ``rtol=1e-4, atol=1e-5``;
the loss and its gradients ``rtol=1e-4, atol=1e-6``, but for the
hybrid's gradients an ``atol`` of 1e-4 of each leaf's largest magnitude
(``GRAD_SCALE_ATOL``); decode against the reference's decode and the
port's own forward ``2e-4`` (the reference test's); float32 sums run in
another order in the two frameworks, nothing else differs.  The hybrid's
floor: torch's CPU float32 matmul (MKL) rounds its ``in_proj`` more
coarsely than XLA's dot (computing that matmul alone in float64 brings
the port to the reference's distance from a float64 run), and the Mamba2
recurrence carries the difference into every gradient upstream of it, a
few times the reference's own float32 error, beyond ``atol=1e-6`` on
leaves such as ``A_log`` and ``embed``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import base as rbase
from repro.models import attention as rattention
from repro.models import layers as rlayers
from repro.models import model as rmodel
from repro_torch import configs as pconfigs
from repro_torch.configs import base as pbase
from repro_torch.models import attention, layers, model

DENSE = ["codeqwen1.5-7b", "minitron-4b", "musicgen-medium", "olmo-1b",
         "paligemma-3b", "qwen3-1.7b"]
# the MoE, recurrent and hybrid families
FAMILIES = ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "rwkv6-1.6b",
            "zamba2-2.7b"]
GRAD_SCALE_ATOL = {"zamba2-2.7b": 1e-4}   # the module docstring says why
CPU = "cpu"


def _cfgs(arch, **kw):
    return (rconfigs.reduced(rconfigs.get_arch(arch), **kw),
            pconfigs.reduced(pconfigs.get_arch(arch), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carried(rcfg, seed=0):
    """(reference params, the port's copy of them on the CPU)."""
    rp = rmodel.init_params(rcfg, jax.random.key(seed))
    return rp, model.params_from_numpy(_np(rp), CPU)


def _tokens(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _prefix(cfg, B, seed=3):
    if not cfg.n_prefix:
        return None
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.n_prefix, cfg.d_model)).astype(
        np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------------------
# configs: the copy pinned to the reference
# --------------------------------------------------------------------------


def test_config_copy_is_pinned_to_the_reference():
    """Every field of every registered config, the shapes, the reduced
    configs and the parameter counts equal the reference's."""
    assert pconfigs.list_archs() == rconfigs.list_archs()
    assert len(pconfigs.list_archs()) == 10
    for name in rconfigs.list_archs():
        r, p = rconfigs.get_arch(name), pconfigs.get_arch(name)
        assert dataclasses.asdict(p) == dataclasses.asdict(r), name
        assert p.param_count() == r.param_count(), name
        assert p.active_param_count() == r.active_param_count(), name
        assert (p.hd, p.is_moe, p.sub_quadratic) == \
            (r.hd, r.is_moe, r.sub_quadratic), name
        for kw in ({}, {"n_layers": 4, "d_model": 256, "vocab": 2048},
                   {"n_layers": 12, "d_model": 768, "vocab": 32768,
                    "d_ff": 2304}):
            assert dataclasses.asdict(pconfigs.reduced(p, **kw)) == \
                dataclasses.asdict(rconfigs.reduced(r, **kw)), (name, kw)
        for s in rbase.SHAPES.values():
            assert pbase.shape_applicable(p, pbase.SHAPES[s.name]) == \
                rbase.shape_applicable(r, s)
    assert {k: dataclasses.asdict(v) for k, v in pbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rbase.SHAPES.items()}
    fields = [f.name for f in dataclasses.fields(rbase.ArchConfig)]
    assert [f.name for f in dataclasses.fields(pbase.ArchConfig)] == fields


def test_qwen3_full_width_counts():
    """The configuration the card serves: 2.03 B parameters at 28 layers,
    823 M with the depth cut to 4."""
    cfg = pconfigs.get_arch("qwen3-1.7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.n_kv,
            cfg.d_ff, cfg.vocab) == (28, 2048, 16, 128, 8, 6144, 151936)
    assert round(cfg.param_count() / 1e9, 2) == 2.03
    cut = dataclasses.replace(cfg, n_layers=4)
    assert cut.param_count() // 10**6 == 823


# --------------------------------------------------------------------------
# layers and attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "ln_nonparam"])
def test_norm_fn_matches_reference(kind):
    """``norm_fn`` names the same norm in both packages: each applied to
    the same input and scale agrees within 1e-5."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    assert layers.norm_fn(kind) is getattr(layers, kind)
    np.testing.assert_allclose(
        layers.norm_fn(kind)(_t(x), _t(scale)).numpy(),
        np.asarray(rlayers.norm_fn(kind)(jnp.asarray(x),
                                         jnp.asarray(scale))),
        rtol=1e-5, atol=1e-6)
    with pytest.raises(KeyError):
        layers.norm_fn("layernorm")


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_layers_match_reference(act):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm(_t(x), _t(scale)).numpy(),
        np.asarray(rlayers.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        layers.ln_nonparam(_t(x)).numpy(),
        np.asarray(rlayers.ln_nonparam(jnp.asarray(x))), rtol=1e-5,
        atol=1e-6)
    q = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    np.testing.assert_allclose(
        layers.apply_rope(_t(q), _t(pos.copy()), 1e6).numpy(),
        np.asarray(rlayers.apply_rope(jnp.asarray(q), jnp.asarray(pos),
                                      1e6)), rtol=1e-5, atol=1e-5)
    rp = rlayers.init_mlp(jax.random.key(2), 64, 96, act, jnp.float32)
    pp = model.params_from_numpy(_np(rp), CPU)
    np.testing.assert_allclose(
        layers.mlp(pp, _t(x), act).numpy(),
        np.asarray(rlayers.mlp(rp, jnp.asarray(x), act)), rtol=1e-4,
        atol=1e-5)


@pytest.mark.parametrize("S", [40, 2304])
def test_attention_matches_reference(S):
    """Full-sequence GQA attention with qk-norm and rope; at 2,304 tokens
    the queries run in two chunks of 1,152 and the keys in chunks of 768
    (future chunks skipped), as the reference's chunk sizes divide it."""
    d, H, KV, hd = 64, 4, 2, 16
    rp = rattention.init_attn(jax.random.key(4), d, H, KV, hd, True,
                              jnp.float32)
    rng = np.random.default_rng(S)
    rp = dict(rp, q_norm=jnp.asarray(1 + 0.1 * rng.standard_normal(hd),
                                     jnp.float32))
    pp = model.params_from_numpy(_np(rp), CPU)
    x = rng.standard_normal((1, S, d)).astype(np.float32)
    kw = dict(n_heads=H, n_kv=KV, head_dim=hd, qk_norm=True,
              rope_theta=1e6)
    want = rattention.attention(rp, jnp.asarray(x), **kw)
    got = attention.attention(pp, _t(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


# --------------------------------------------------------------------------
# the model: forward, loss and gradients, decode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_forward_matches_reference(arch):
    rcfg, pcfg = _cfgs(arch)
    rp, pp = _carried(rcfg)
    tok, pre = _tokens(rcfg, 2, 24), _prefix(rcfg, 2)
    want = rmodel.forward(rcfg, rp, jnp.asarray(tok),
                          None if pre is None else jnp.asarray(pre))
    with torch.no_grad():
        got = model.forward(pcfg, pp, _t(tok), _t(pre))
    assert tuple(got.shape) == (2, 24 + pcfg.n_prefix, pcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmo-1b", "minitron-4b",
                                  "paligemma-3b"] + FAMILIES)
def test_loss_and_grads_match_reference(arch):
    """``loss_fn`` (remat, chunked cross entropy over two 16-token chunks)
    and its gradient on every leaf; olmo ties the head to the embedding,
    paligemma carries a prefix; the MoE's router and experts, the
    recurrences and the hybrid's shared block take gradients through the
    remat recompute."""
    rcfg, pcfg = _cfgs(arch)
    rp, pp = _carried(rcfg, seed=7)
    tok, lab = _tokens(rcfg, 2, 32), _tokens(rcfg, 2, 32, seed=2)
    pre = _prefix(rcfg, 2)
    rpre = None if pre is None else jnp.asarray(pre)
    want_loss, want_g = jax.value_and_grad(
        lambda p: rmodel.loss_fn(rcfg, p, jnp.asarray(tok), jnp.asarray(lab),
                                 rpre, remat=True, seq_chunk=16))(rp)
    leaves = {k: v.requires_grad_() for k, v in _flat(pp).items()}

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}/{k}") for k, v in tree.items()}
        return leaves[prefix]

    loss = model.loss_fn(pcfg, rebuild(pp), _t(tok), _t(lab), _t(pre),
                         remat=True, seq_chunk=16)
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-4, atol=1e-6)
    want_flat = _flat(_np(want_g))
    assert sorted(want_flat) == sorted(names)
    for k, g in zip(names, grads):
        g = np.zeros(leaves[k].shape, np.float32) if g is None else g.numpy()
        atol = max(1e-6, GRAD_SCALE_ATOL.get(arch, 0.0)
                   * float(np.abs(want_flat[k]).max(initial=0.0)))
        np.testing.assert_allclose(g, want_flat[k], rtol=1e-4, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmo-1b", "minitron-4b"]
                         + FAMILIES)
def test_decode_matches_reference_and_forward(arch):
    """Eight cached decode steps: each step's logits equal the reference's
    ``decode_step`` on the same cache and the port's own ``forward`` at the
    same positions (the reference test's 2e-4), and every cache leaf the
    reference's after them (K/V; the RWKV6 and Mamba2 states, their
    token-shift and convolution rows; the shared block's K/V)."""
    _check_decode(*_cfgs(arch))


@pytest.mark.parametrize("n_layers", [4, 6])
def test_hybrid_decode_with_the_shared_block_applied_repeatedly(n_layers):
    """zamba2 with its shared block applied 2 and 3 times (every second
    layer at ``reduced()``), each application with its own K/V cache: the
    decode checks above, every application's K/V leaf included."""
    rcfg, pcfg = _cfgs("zamba2-2.7b", n_layers=n_layers)
    assert pcfg.n_layers // pcfg.attn_every == n_layers // 2
    assert model.init_cache(pcfg, 2, 16, device=CPU)["k"].shape[0] == \
        n_layers // 2
    _check_decode(rcfg, pcfg)


def _check_decode(rcfg, pcfg):
    rp, pp = _carried(rcfg, seed=3)
    tok = _tokens(rcfg, 2, 8, seed=4)
    rcache = rmodel.init_cache(rcfg, 2, 16)
    pcache = model.init_cache(pcfg, 2, 16, device=CPU)
    assert sorted(pcache) == sorted(rcache)
    rstep = jax.jit(lambda c, t: rmodel.decode_step(rcfg, rp, c, t))
    outs = []
    with torch.no_grad():
        full = model.forward(pcfg, pp, _t(tok)).numpy()
        for i in range(8):
            want, rcache = rstep(rcache, jnp.asarray(tok[:, i:i + 1]))
            got, pcache = model.decode_step(pcfg, pp, pcache,
                                            _t(tok[:, i:i + 1]))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-4, atol=2e-4)
            outs.append(got.numpy())
    assert pcache["pos"] == 8 == int(rcache["pos"])
    np.testing.assert_allclose(np.concatenate(outs, axis=1), full,
                               rtol=2e-4, atol=2e-4)
    for k in sorted(set(pcache) - {"pos"}):
        assert tuple(pcache[k].shape) == rcache[k].shape, k
        np.testing.assert_allclose(pcache[k].numpy(), np.asarray(rcache[k]),
                                   rtol=2e-4, atol=2e-4, err_msg=k)


# --------------------------------------------------------------------------
# init, weights carried across, what is not ported
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmo-1b"] + FAMILIES)
def test_init_params_has_the_reference_tree(arch):
    """The same keys, shapes and dtypes, and the scales: each normal leaf's
    spread within 10% of the reference's, the norms ones (or empty)."""
    rcfg, pcfg = _cfgs(arch)
    want = _flat(_np(rmodel.init_params(rcfg, jax.random.key(0))))
    got = _flat(model.init_params(pcfg, torch.Generator().manual_seed(0),
                                  device=CPU))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape and str(v.dtype)[6:] == \
            str(want[k].dtype), k
        if v.numel() and ("norm" in k or "ln" in k):
            assert torch.equal(v, torch.from_numpy(want[k].copy())), k
        elif v.numel():
            assert float(v.std()) == pytest.approx(float(want[k].std()),
                                                   rel=0.1), k


def test_params_from_numpy_carries_bf16_bits():
    """bf16 leaves cross as ml_dtypes arrays or as their 16-bit patterns,
    bit for bit; int8 and int32 leaves as they are."""
    rcfg = dataclasses.replace(
        rconfigs.reduced(rconfigs.get_arch("qwen3-1.7b")), dtype="bfloat16")
    rp = _np(rmodel.init_params(rcfg, jax.random.key(1)))
    bits = jax.tree.map(lambda a: a.view(np.uint16), rp)
    for tree in (rp, bits):
        got = _flat(model.params_from_numpy(tree, CPU))
        for k, a in _flat(rp).items():
            assert got[k].dtype == torch.bfloat16
            assert np.array_equal(got[k].view(torch.int16).numpy(),
                                  a.view(np.int16)), k
    other = model.params_from_numpy(
        {"q": np.arange(-3, 3, dtype=np.int8), "step": np.int32(7)}, CPU)
    assert other["q"].dtype == torch.int8 and other["step"].dtype == \
        torch.int32 and int(other["step"]) == 7


def test_entry_points_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pcfg = _cfgs("qwen3-1.7b")
    for call in (lambda: model.init_params(pcfg, torch.Generator()),
                 lambda: model.init_cache(pcfg, 1, 4),
                 lambda: model.params_from_numpy({"w": np.ones(2)})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
