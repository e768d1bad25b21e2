"""The port's recurrent mixers (``repro_torch.models.ssm``: RWKV6 and
Mamba2) held to the JAX package's (``repro.models.ssm``) on the CPU, in
float32, on the reference's own weights carried across by
``params_from_numpy`` and inputs from numpy with a seed.

Tolerances: outputs and states ``rtol=1e-4, atol=1e-5`` against the
reference, the forward tolerance of ``tests/test_torch_models.py`` and the
reference's own for its chunked SSD against the per-step recurrence
(``tests/test_models.py::test_chunked_ssd_matches_step_scan``), which the
port's chunked path is held to against its own per-step path as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as rssm
from repro_torch.models import model, ssm

TOL = dict(rtol=1e-4, atol=1e-5)


def _carried(rp):
    return model.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_mix_matches_reference(with_state):
    """Time mixing over 12 steps from zeros, or from a carried state (a
    random wkv state and token-shift row), with the bonus ``u`` and the
    decay base set off zero."""
    d, H = 64, 4
    rp = rssm.init_rwkv6(jax.random.key(1), d, H, jnp.float32)
    rp = dict(rp, bonus_u=jnp.asarray(_x((H, d // H), 2)),
              decay_base=jnp.asarray(_x((d,), 3) * 0.5))
    pp = _carried(rp)
    x = _x((2, 12, d), 4)
    state = None
    if with_state:
        state = (_x((2, H, d // H, d // H), 5), _x((2, d), 6))
    want, (ws, wx) = rssm.rwkv6_mix(
        rp, jnp.asarray(x), n_heads=H,
        state=None if state is None else tuple(map(jnp.asarray, state)))
    got, (gs, gx) = ssm.rwkv6_mix(
        pp, torch.from_numpy(x), n_heads=H,
        state=None if state is None else tuple(map(torch.from_numpy, state)))
    _close(got, want)
    _close(gs, ws)
    _close(gx, wx)
    assert gs.dtype == torch.float32


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_channel_mix_matches_reference(with_state):
    """Without state it returns the output alone; with one, the output and
    the new token-shift row, as the reference does."""
    d, f = 64, 96
    rp = rssm.init_rwkv6_channel_mix(jax.random.key(7), d, f, jnp.float32)
    pp = _carried(rp)
    x = _x((2, 5, d), 8)
    if not with_state:
        got = ssm.rwkv6_channel_mix(pp, torch.from_numpy(x))
        assert isinstance(got, torch.Tensor)
        _close(got, rssm.rwkv6_channel_mix(rp, jnp.asarray(x)))
        return
    last = _x((2, d), 9)
    want, wl = rssm.rwkv6_channel_mix(rp, jnp.asarray(x),
                                      x_last=jnp.asarray(last))
    got, gl = ssm.rwkv6_channel_mix(pp, torch.from_numpy(x),
                                    x_last=torch.from_numpy(last))
    _close(got, want)
    _close(gl, wl)


def _mamba():
    rp = rssm.init_mamba2(jax.random.key(0), 64, head_dim=16, ssm_state=8,
                          dtype=jnp.float32)
    # A_log, D and dt_bias off their init constants, so each term shows
    rp = dict(rp, A_log=jnp.asarray(_x((8,), 10) * 0.5),
              D=jnp.asarray(_x((8,), 11)),
              dt_bias=jnp.asarray(_x((8,), 12) * 0.5))
    return rp, _carried(rp)


@pytest.mark.parametrize("chunk", [0, 16, 32, 96])
def test_mamba2_mix_matches_reference(chunk):
    """96 steps (the reference test's shape) per step (``ssd_chunk`` 0) and
    chunkwise at 16, 32 and 96: output and final state against the
    reference's same path, and the port's chunked path against its own
    per-step path."""
    rp, pp = _mamba()
    x = _x((2, 96, 64), 13)
    kw = dict(head_dim=16, ssm_state=8, ssd_chunk=chunk)
    want, (wh, wc) = rssm.mamba2_mix(rp, jnp.asarray(x), **kw)
    got, (gh, gc) = ssm.mamba2_mix(pp, torch.from_numpy(x), **kw)
    _close(got, want)
    _close(gh, wh)
    _close(gc, wc)
    if chunk:
        step, (sh, _) = ssm.mamba2_mix(pp, torch.from_numpy(x), head_dim=16,
                                       ssm_state=8, ssd_chunk=0)
        np.testing.assert_allclose(got.numpy(), step.numpy(), **TOL)
        np.testing.assert_allclose(gh.numpy(), sh.numpy(), **TOL)


def test_mamba2_decode_steps_carry_the_state():
    """Six single-token steps from a carried (ssm, conv) state equal the
    reference's steps, and their outputs the full-sequence pass."""
    rp, pp = _mamba()
    x = _x((2, 6, 64), 14)
    kw = dict(head_dim=16, ssm_state=8)
    full, _ = ssm.mamba2_mix(pp, torch.from_numpy(x), **kw)
    rstate = (jnp.zeros((2, 8, 16, 8), jnp.float32),
              jnp.zeros((2, ssm.CONV_K - 1, 128), jnp.float32))
    pstate = tuple(torch.from_numpy(np.array(s)) for s in rstate)
    for t in range(6):
        want, rstate = rssm.mamba2_mix(rp, jnp.asarray(x[:, t:t + 1]),
                                       state=rstate, **kw)
        got, pstate = ssm.mamba2_mix(pp, torch.from_numpy(x[:, t:t + 1]),
                                     state=pstate, **kw)
        _close(got, want)
        np.testing.assert_allclose(got.numpy()[:, 0], full.numpy()[:, t],
                                   **TOL)
    _close(pstate[0], rstate[0])
    _close(pstate[1], rstate[1])


def test_causal_conv_sums_in_the_reference_order():
    """The four taps add as ``0 + t0 + t1 + t2 + t3`` in x's dtype: in
    bf16 the port's convolution equals that sum bit for bit, with and
    without a carried state."""
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal((2, 7, 32)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((4, 32)).astype(
        np.float32)).to(torch.bfloat16)
    st = torch.from_numpy(rng.standard_normal((2, 3, 32)).astype(
        np.float32)).to(torch.bfloat16)
    for state in (None, st):
        got, new = ssm._causal_conv(x, w, state)
        pad = torch.zeros((2, 3, 32), dtype=torch.bfloat16) \
            if state is None else state
        xp = torch.cat([pad, x], dim=1)
        want = xp[:, 0:7] * w[0]
        for i in range(1, 4):
            want = want + xp[:, i:i + 7] * w[i]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want) and torch.equal(new, xp[:, -3:])
