"""The port's quantized-weight path against the reference.

``ref_dequant_matmul`` and ``dequant_matmul`` (on a CPU tensor: its plain
version) against the reference's ``dequant_matmul(interpret=True)`` at the
reference test's shapes, with the reference's tolerance (``rtol=5e-3,
atol=1e-4``: the Pallas kernel sums each 128-deep tile apart, the plain
version in one product); ``compress_weights`` byte-equal to the
reference's; ``decompress_dequant_matmul`` on a reference blob carried
across, equal to the reference's result; its second call builds no plan
and moves nothing across the host boundary; and the shape assertion raises
on the same shapes as the reference's.
"""
import ctypes
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import format as ref_fmt
from repro.core.engine import CodagEngine as RefEngine
from repro.core.engine import EngineConfig as RefConfig
from repro.kernels import dequant_matmul as ref_dq
from repro_torch.core import api, batch, format as fmt, plan as plan_mod
from repro_torch.core import transfers
from repro_torch.core.engine import CodagEngine, EngineConfig
from repro_torch.kernels import cuda_build
from repro_torch.kernels import dequant_matmul as dq

CPU = CodagEngine(EngineConfig(device="cpu"))
REF = RefEngine(RefConfig())
SHAPES = [(128, 128, 128), (256, 384, 256), (128, 512, 384)]


def _operands(m, k, n, seed=11, qmax=127):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    q = rng.integers(-qmax, qmax, (k, n)).astype(np.int8)
    s = (np.abs(rng.normal(size=(1, n))) * 0.01).astype(np.float32)
    return x, q, s


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_dequant_matmul_equals_reference_kernel(m, k, n):
    x, q, s = _operands(m, k, n)
    want = np.asarray(ref_dq.dequant_matmul(jnp.asarray(x), jnp.asarray(q),
                                            jnp.asarray(s), interpret=True))
    got = dq.dequant_matmul(*_t(x, q, s))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=1e-4)
    plain = dq.ref_dequant_matmul(*_t(x, q, s)).numpy()
    ref_plain = np.asarray(ref_dq.ref_dequant_matmul(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s)))
    np.testing.assert_allclose(plain, ref_plain, rtol=5e-3, atol=1e-4)


def test_dequant_matmul_bf16_keeps_the_dtype():
    """bf16 activations: computed in float32, returned in bf16 (compared in
    float32 against the reference's plain version, within two bf16 ulps)."""
    x, q, s = _operands(128, 256, 128)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = dq.dequant_matmul(xb, *_t(q, s))
    assert got.dtype == torch.bfloat16
    want = np.asarray(ref_dq.ref_dequant_matmul(
        jnp.asarray(xb.float().numpy()), jnp.asarray(q), jnp.asarray(s)))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1.6e-2,
                               atol=1e-2)


@pytest.mark.parametrize("m,k,n,dtype,want", [
    (128, 2048, 2048, torch.bfloat16, ("wgmma", 128)),
    (2048, 6144, 2048, torch.bfloat16, ("wgmma", 128)),
    (1, 2048, 2048, torch.bfloat16, ("wgmma", 8)),
    (9, 256, 128, torch.bfloat16, ("wgmma", 16)),
    (33, 256, 128, torch.bfloat16, ("wgmma", 64)),
    (64, 256, 128, torch.bfloat16, ("wgmma", 64)),
    (65, 256, 128, torch.bfloat16, ("wgmma", 128)),
    (128, 2048, 2048, torch.float32, ("simt", 0)),
    (64, 96, 100, torch.bfloat16, ("simt", 0)),     # N % 16: no TMA stride
    (64, 100, 96, torch.bfloat16, ("simt", 0))])    # K % 8: no TMA stride
def test_launch_plan_path_by_dtype_and_shape(m, k, n, dtype, want):
    path, bm, splits = dq._launch_plan(m, n, k, dtype)
    assert (path, bm) == want
    assert 1 <= splits <= -(-k // dq.WG_BK)
    if path == "simt":
        assert splits == 1


@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 1024), (2048, 6144),
                                 (6144, 2048)])
def test_launch_plan_splits_k_to_fill_the_card_at_a_decode_batch(k, n):
    """qwen3-1.7B's projections at M = 128 have 8-48 output tiles: K is
    split until there are at least 132 CTAs; at M = 2048 it is not."""
    path, bm, splits = dq._launch_plan(128, n, k, torch.bfloat16)
    tiles = -(-n // dq.WG_BN) * -(-128 // bm)
    assert path == "wgmma" and splits > 1
    assert tiles * splits >= dq.SMS > tiles * (splits - 1)
    assert dq._launch_plan(2048, n, k, torch.bfloat16) == ("wgmma", 128, 1)


@pytest.mark.parametrize("m,k,n", [(128, 256, 384), (1, 128, 64),
                                   (64, 96, 100)])
def test_cpu_dequant_matmul_equals_reference_plain_on_either_plan(m, k, n):
    """On a CPU tensor the wrapper runs its plain version whatever path the
    card would take, counts no launch, and equals the reference's
    ``ref_dequant_matmul`` (bf16 activations, two bf16 ulps)."""
    x, q, s = _operands(m, k, n)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    before = (dq.LAUNCHES, dict(dq.LAUNCHES_BY_PATH))
    got = dq.dequant_matmul(xb, *_t(q, s))
    assert (dq.LAUNCHES, dq.LAUNCHES_BY_PATH) == before
    want = np.asarray(ref_dq.ref_dequant_matmul(
        jnp.asarray(xb.float().numpy()), jnp.asarray(q), jnp.asarray(s)))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1.6e-2,
                               atol=1e-2)


def test_tensor_core_entry_signature_and_lazy_build():
    """The wgmma entry point's ctypes kinds equal its C parameters; it
    shares the SIMT entry's library (one build, with -lcuda) and binds
    nothing at import."""
    src = dq.WGMMA.source.read_text()
    m = re.search(r'extern "C" int codag_dequant_matmul_wgmma\s*\(([^)]*)\)',
                  src)
    params = [p.strip() for p in m.group(1).split(",")]
    want = "".join("p" if "*" in p else "l" if "int64_t" in p else "i"
                   for p in params)
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_int64: "l"}
    assert "".join(kinds[t] for t in dq.WGMMA.argtypes) == want
    assert dq.WGMMA.lib is dq.LIB and "-lcuda" in dq.LIB.flags
    assert not dq.WGMMA.loaded and not dq.LIB.loaded
    assert "-lcuda" not in cuda_build.NVCC_FLAGS


@pytest.mark.parametrize("m,k,n,kw", [
    (192, 128, 128, {}), (128, 128, 200, {}), (128, 320, 128, {}),
    (64, 64, 64, {}), (256, 256, 256, {"bm": 96})])
def test_shape_assertion_raises_as_reference(m, k, n, kw):
    x, q, s = _operands(m, k, n)
    try:
        ref_dq.dequant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                              interpret=True, **kw)
        ref_raised = False
    except AssertionError:
        ref_raised = True
    if ref_raised:
        with pytest.raises(AssertionError):
            dq.dequant_matmul(*_t(x, q, s), **kw)
    else:
        got = dq.dequant_matmul(*_t(x, q, s), **kw)
        assert got.shape == (m, n)
    assert ref_raised == (m == 192 or n == 200 or k == 320 or "bm" in kw)


@pytest.mark.parametrize("bad", ["q_dtype", "s_shape", "x_dtype", "k"])
def test_dequant_matmul_checks_its_inputs(bad):
    x, q, s = _t(*_operands(128, 128, 128))
    if bad == "q_dtype":
        q = q.to(torch.int16)
    elif bad == "s_shape":
        s = s[0]
    elif bad == "x_dtype":
        x = x.to(torch.float64)
    else:
        q = q[:64]
    with pytest.raises((ValueError, AssertionError)):
        dq.dequant_matmul(x, q, s)


def test_compress_weights_equals_reference():
    _, q, _ = _operands(256, 128, 128, qmax=8)
    for zp, codec in ((8, "bitpack"), (0, "rle_v1"), (128, "lzss")):
        ca = dq.compress_weights(q, codec, zero_point=zp)
        rca = ref_dq.compress_weights(q, codec, zero_point=zp)
        assert [fmt.blob_digest(b) for b in ca.blobs] == \
            [ref_fmt.blob_digest(b) for b in rca.blobs]
    with pytest.raises(ValueError, match="int8"):
        dq.compress_weights(q.astype(np.int16))


def test_decompress_dequant_matmul_carried_across_equals_reference():
    x, _, s = _operands(128, 256, 128)
    q = np.random.default_rng(7).integers(-8, 8, (256, 128)).astype(np.int8)
    rca = ref_dq.compress_weights(q, "bitpack", zero_point=8)
    ca = api.CompressedArray(
        blobs=[fmt.blob_from_reference(dataclasses.asdict(b))
               for b in rca.blobs],
        orig_dtype=rca.orig_dtype, orig_shape=rca.orig_shape)
    want = np.asarray(ref_dq.decompress_dequant_matmul(
        jnp.asarray(x), rca, jnp.asarray(s), zero_point=8, engine=REF,
        interpret=True))
    got = dq.decompress_dequant_matmul(*_t(x), ca, *_t(s), zero_point=8,
                                       engine=CPU)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=1e-4)
    assert torch.equal(dq.decode_weights(ca, zero_point=8, engine=CPU),
                       torch.from_numpy(q))


def test_steady_state_builds_no_plan_and_moves_nothing(monkeypatch):
    x, s = _t(*_operands(128, 256, 128)[::2])
    q = np.random.default_rng(5).integers(-8, 8, (256, 128)).astype(np.int8)
    ca = dq.compress_weights(q, zero_point=8)
    first = dq.decompress_dequant_matmul(x, ca, s, zero_point=8, engine=CPU)
    builds = []
    real = plan_mod.DecodePlan.build.__func__
    monkeypatch.setattr(plan_mod.DecodePlan, "build", classmethod(
        lambda cls, blobs: builds.append(1) or real(cls, blobs)))
    with transfers.count_host_transfers() as c:
        with transfers.no_host_transfers():
            again = dq.decompress_dequant_matmul(x, ca, s, zero_point=8,
                                                 engine=CPU)
    assert builds == [] and c == {"d2h": 0, "bytes": 0, "h2d": 0,
                                  "h2d_bytes": 0}
    assert torch.equal(first, again)
    # another zero point is another plan
    dq.decompress_dequant_matmul(x, ca, s, zero_point=0, engine=CPU)
    assert builds == [1]


def test_weight_epilogue_matches_reference():
    epi, ops_ = dq.weight_epilogue(8)
    ref_epi, ref_ops = ref_dq.weight_epilogue(8)
    assert (epi.out_dtype, epi.zero_key) == (ref_epi.out_dtype,
                                             ref_epi.zero_key)
    assert ops_.keys() == ref_ops.keys()
    assert ops_["epi_zero"] == ref_ops["epi_zero"]


def test_batch_aliases_lower_through_the_plan():
    assert batch.BatchPlan is plan_mod.DecodePlan
    assert batch.GroupPlan is plan_mod.PlanGroup
    a = np.repeat(np.arange(40, dtype=np.uint16), 7)
    blobs = [b for ca in api.compress_many([a, a[::-1].copy()], "rle_v1",
                                           256) for b in ca.blobs]
    host = batch.decompress_blobs(blobs, CPU)
    dev = batch.decompress_blobs(blobs, CPU, device_out=True)
    for h, d, want in zip(host, dev, (a, a[::-1])):
        assert np.array_equal(h, want) and np.array_equal(d.numpy(), want)
    assert batch.decompress_blobs([], CPU) == []
    with pytest.raises(ValueError, match="device_out"):
        batch.decompress_blobs(blobs, CPU, epilogue=dq.weight_epilogue()[0])
