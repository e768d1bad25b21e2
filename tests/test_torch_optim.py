"""The port's optimizer, gradient compression and single-device gradient
wire (``optim/{adamw,grad_compress}.py``, ``distributed/{collectives,
sharding}.py``) and the per-row epilogue operand held to the JAX package on
the CPU.

Inputs from numpy with a seed.  Integer results (int8 moments, the packed
wire, decoded wire values) must be equal bit for bit; float32 results of
AdamW within 1e-6 (``pow`` and a division may round by an ulp apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoders as renc
from repro.distributed import collectives as rcoll
from repro.kernels import ops as rops
from repro.optim import adamw as radamw
from repro.optim import grad_compress as rgc
from repro_torch.core import encoders as enc
from repro_torch.core.engine import EngineConfig
from repro_torch.distributed import collectives, sharding
from repro_torch.kernels import bitpack, harness, ops
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc

CPU_ENGINE = EngineConfig(device="cpu")


def _grads(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((700,))).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32),
            "m": {"k": (scale * rng.standard_normal((3, 129))).astype(
                np.float32)}}


def _tj(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tt(tree):
    return model.params_from_numpy(tree, "cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_matches_reference(compress):
    """Three updates on the same grads: int8 moments equal exactly, every
    float32 leaf within 1e-6, the step counter equal."""
    cfg_r = radamw.AdamWConfig(lr=1e-2, compress_moments=compress)
    cfg_p = adamw.AdamWConfig(lr=1e-2, compress_moments=compress)
    params = _grads(0)
    rp, pp = _tj(params), _tt(params)
    rs, ps = radamw.init(rp, cfg_r), adamw.init(pp, cfg_p)
    for step in range(3):
        g = _grads(10 + step, scale=0.1 * (step + 1))
        rp, rs = radamw.apply(rp, _tj(g), rs, cfg_r)
        pp, ps = adamw.apply(pp, _tt(g), ps, cfg_p)
        got, want = _flat({"p": pp, "s": ps}), _flat({"p": rp, "s": rs})
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            v = got[k]
            assert v.dtype == w.dtype, k
            if w.dtype.kind in "iu":
                np.testing.assert_array_equal(v, w, err_msg=k)
            else:
                np.testing.assert_allclose(v, w, rtol=1e-6, atol=1e-6,
                                           err_msg=k)


def _planted_ties(rng, n_blocks: int) -> np.ndarray:
    """Blocks of 128 whose largest magnitude is 127 * 2^-e, so the scale is
    2^-e exactly (the 1e-12 is below its ulp), and whose other values sit
    on the grid's half points (k + 0.5) * 2^-e: every quotient a tie that
    rounds half to even."""
    e = rng.integers(3, 16, (n_blocks, 1))
    k = rng.integers(-127, 127, (n_blocks, adamw.QBLOCK))
    x = (k + 0.5) * np.exp2(-e)
    x[:, 0] = rng.choice([-127.0, 127.0], n_blocks) * np.exp2(-e[:, 0])
    return x.astype(np.float32)


@pytest.mark.parametrize("sqrt_domain", [False, True])
def test_int8_quantizer_matches_reference_on_planted_ties(sqrt_domain):
    """``adamw._quantize`` on values at exact half points of the int8 grid
    (and in the sqrt domain, their squares, whose square roots are exact)
    and on 2^16 random values the size of a second moment, whose square
    roots the CPU's float32 path rounds an ulp low at times: q and s equal
    the reference's bit for bit."""
    rng = np.random.default_rng(23)
    ties = _planted_ties(rng, 64)
    g = rng.standard_normal(1 << 16).astype(np.float32)
    x = np.concatenate([ties.reshape(-1), 1e-4 * g]).astype(np.float32)
    if sqrt_domain:
        x = np.concatenate([np.square(ties.reshape(-1)),
                            np.float32(5e-8) * g * g]).astype(np.float32)
    # one CPU thread: in a process that has run XLA, a worker of torch's
    # CPU pool has been seen to return square roots ~12 bits exact on some
    # hosts, a chunk of the tensor at a time and not every run
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        q, s = adamw._quantize(torch.from_numpy(x), sqrt_domain)
    finally:
        torch.set_num_threads(threads)
    rq, rs = radamw._quantize(jnp.asarray(x), sqrt_domain)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(rs).view(np.uint32))
    # the ties round half to even: both directions occur
    half = np.abs(q.numpy()[:64, 1:].astype(np.int64))
    assert np.all(half % 2 == 0) and len(np.unique(half)) > 10


def test_adamw_state_carries_across():
    """A reference AdamW state (int8 moments) crosses through
    ``params_from_numpy`` with its leaves' dtypes and bits."""
    cfg = radamw.AdamWConfig(compress_moments=True)
    rs = radamw.init(_tj(_grads(1)), cfg)
    rs = radamw.apply(_tj(_grads(1)), _tj(_grads(2)), rs, cfg)[1]
    got = _flat(model.params_from_numpy(jax.tree.map(np.asarray, rs), "cpu"))
    for k, w in _flat(rs).items():
        np.testing.assert_array_equal(np.asarray(got[k]), w, err_msg=k)
        assert np.asarray(got[k]).dtype == w.dtype


def test_int8_moments_blow_up_alike_in_both_packages(tmp_path):
    """The int8 moments' divergence at the driver's learning rate is the
    reference's, and this is its cause.  Four steps of ``--preset small``
    (qwen3, batch 8 x 512, lr 3e-3, ``--grad-int8 --compress-moments``) on
    the same weights: both packages' losses agree within 1e-4 and both
    jump at step 4.  Every element that step 4 moves by more than 100 x lr
    (an Adam update is about lr) had, after step 3, a second moment that
    dequantizes to 0 (v in the sqrt domain, one scale a block of 128)
    beside a first moment that does not: its update is ``lr * m / eps``
    once the int8 wire rounds its gradient to 0."""
    from repro.launch import train as rtrain
    from repro.models import model as rmodel
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core.tree import leaves, map_tree
    from repro_torch.launch import train

    lr = 3e-3
    flags = ["--arch", "qwen3-1.7b", "--preset", "small", "--steps", "4",
             "--batch", "8", "--seq", "512", "--lr", str(lr), "--grad-int8",
             "--compress-moments", "--ckpt-every", "3"]
    rargs = rtrain.build_parser().parse_args(
        flags + ["--ckpt-dir", str(tmp_path / "ref")])
    want = rtrain.run_training(rargs)["losses"]
    params = model.params_from_numpy(jax.tree.map(np.asarray, (
        rmodel.init_params(rtrain._resolve_cfg(rargs), jax.random.key(0)))),
        "cpu")
    args = train.build_parser().parse_args(
        flags + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    m = train.run_training(args, params=params)
    np.testing.assert_allclose(m["losses"], want, rtol=1e-4)
    for losses in (want, m["losses"]):
        assert losses[3] > 10 * losses[2] and losses[2] < losses[0]
    p4, _ = m["state"]
    p3, o3 = ckpt.restore(str(tmp_path / "port"), 3, m["state"])

    def jumps(p, q, mo, vo):
        mf = adamw._dequantize(mo["q"], mo["s"], p.shape)
        vf = adamw._dequantize(vo["q"], vo["s"], p.shape, sqrt_domain=True)
        big = (q.float() - p.float()).abs() > 100 * lr
        assert not (big & ~((vf == 0) & (mf != 0))).any()
        return int(big.sum())

    jumped = sum(leaves(map_tree(jumps, p3, p4, o3["m"], o3["v"])))
    assert jumped > 0


# --------------------------------------------------------------------------
# the int8 grid and top-k
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(257,), (4, 96), (100 * gc.QBLOCK,)])
def test_quantize_leaf_matches_reference(shape):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    q, s = gc.quantize_leaf(torch.from_numpy(x))
    rq, rs = rgc.quantize_leaf(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        gc.dequantize_leaf(q, s, shape).numpy(),
        np.asarray(rgc.dequantize_leaf(rq, rs, shape)))
    got = gc.quantize_grads(_tt(_grads(4)))
    want = rgc.quantize_grads(_tj(_grads(4)))
    for k, w in _flat(want).items():
        np.testing.assert_array_equal(_flat(got)[k], w, err_msg=k)


def test_topk_matches_reference_on_ties():
    flat = np.full(1000, 0.25, np.float32)
    flat[::7] = -0.5
    m, kept = gc.topk_select(torch.from_numpy(flat), 13)
    rm, rkept = rgc.topk_select(jnp.asarray(flat), 13)
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(rkept))
    g = np.random.default_rng(5).standard_normal((40, 30)).astype(np.float32)
    r = np.random.default_rng(6).standard_normal((40, 30)).astype(np.float32)
    sp, res = gc.topk_sparsify(torch.from_numpy(g), torch.from_numpy(r), 0.05)
    rsp, rres = rgc.topk_sparsify(jnp.asarray(g), jnp.asarray(r), 0.05)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(rsp))
    np.testing.assert_array_equal(res.numpy(), np.asarray(rres))
    assert gc.topk_wire_bytes(1000, 0.01) == rgc.topk_wire_bytes(1000, 0.01)


# --------------------------------------------------------------------------
# the wire: encode byte for byte, decode bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bits,chunk_elems", [(8, gc.QBLOCK), (1, 2048),
                                              (4, 256)])
def test_device_wire_bit_exact_vs_host_encoder(bits, chunk_elems):
    """``pack_bits_rows`` + ``wire_dev`` build the bitpack codec's exact
    table: equal to the reference's device wire, to the reference's host
    encoder through its ``table_inputs`` and to the port's host encoder
    through ``format.to_device``, byte for byte (128-byte lane padding
    included)."""
    rng = np.random.default_rng(bits)
    vals = rng.integers(0, 1 << bits, (5, chunk_elems)).astype(np.uint32)
    dev = collectives.wire_dev(
        collectives.pack_bits_rows(torch.from_numpy(vals), bits),
        chunk_elems=chunk_elems, bits=bits)
    ref = rcoll.wire_dev(rcoll.pack_bits_rows(jnp.asarray(vals), bits),
                         chunk_elems=chunk_elems, bits=bits)
    flat = vals.reshape(-1).astype(np.uint8)
    host, hbits = ops.table_inputs(
        enc.compress(flat, "bitpack", chunk_bytes=chunk_elems, bits=bits),
        "cpu")
    rhost, _ = rops.table_inputs(renc.compress(
        flat, "bitpack", chunk_bytes=chunk_elems, bits=bits))
    assert hbits == bits
    assert sorted(dev) == sorted(ref) == sorted(host) == sorted(rhost)
    for k in dev:
        got = dev[k].numpy()
        for want in (np.asarray(ref[k]), host[k].numpy(),
                     np.asarray(rhost[k])):
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
    for row in range(5):
        np.testing.assert_array_equal(
            dev["comp_words"][row, :-(-chunk_elems * bits // 32)].numpy(),
            enc.pack_bits(vals[row], bits))


def test_wire_compressor_matches_reference():
    """The wire compressor's output equals the reference's and
    ``quantize_grads``' bit for bit; each leaf of a block or more is one
    dispatch whose dequant epilogue, with its per-row scale, fuses."""
    grads = _grads(11)
    comp = collectives.make_wire_compressor(CPU_ENGINE)
    before = (harness.EPILOGUE_FUSED, harness.EPILOGUE_UNFUSED)
    with ops.count_dispatches() as calls:
        got = comp(_tt(grads))
    assert len(calls) == 2          # "w" (700) and "m/k" (387); "b" passes
    assert (harness.EPILOGUE_FUSED - before[0],
            harness.EPILOGUE_UNFUSED - before[1]) == (2, 0)
    assert all(c["codec"] == "bitpack" and c["bits"] == 8 for c in calls)
    want = rcoll.make_wire_compressor()(_tj(grads))
    plain = gc.quantize_grads(_tt(grads))
    for k, w in _flat(want).items():
        np.testing.assert_array_equal(_flat(got)[k], w, err_msg=k)
        np.testing.assert_array_equal(_flat(plain)[k], w, err_msg=k)


def test_wire_compressor_keeps_bf16_leaves():
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (5, 300)).astype(np.float32)).to(torch.bfloat16)
    out = collectives.make_wire_compressor(CPU_ENGINE)({"g": g})["g"]
    assert out.dtype == torch.bfloat16 and out.shape == g.shape
    assert torch.equal(out, gc.quantize_grads({"g": g})["g"])


def test_wire_compressor_needs_its_device(monkeypatch):
    comp = collectives.make_wire_compressor(CPU_ENGINE)
    with pytest.raises(ValueError, match="decodes on"):
        comp({"g": torch.zeros(256, device="meta")})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collectives.make_wire_compressor()


def test_wire_bytes_accounting_matches_reference():
    tree = {"a": np.zeros((1000,), np.float32),
            "b": np.zeros((5,), np.float32),
            "c": {"d": np.zeros((64, 300), np.float32)}}
    for wire in ("int8", "topk", "none"):
        for s in (5, 128, 1000, 19200):
            assert collectives.leaf_wire_bytes(s, wire=wire) == \
                rcoll.leaf_wire_bytes(s, wire=wire)
        assert collectives.wire_report(_tt(tree), 4, wire=wire) == \
            rcoll.wire_report(_tj(tree), 4, wire=wire)
    assert gc.wire_bytes_compressed(4096, 3) == \
        rgc.wire_bytes_compressed(4096, 3)


def test_mesh_functions_raise_naming_the_roadmap_item():
    """What raises on the collective plane, pointing to
    ``launch.mesh.spawn``: the collectives and ``use_mesh`` over a mesh
    whose members hold distinct devices, in one process; ``use_mesh``
    installs a mesh whose members share one, and the mesh-free sharding
    context stays a no-op."""
    from repro_torch.launch import mesh as mesh_lib
    x = torch.zeros(2, 256)
    spread = mesh_lib.Mesh([torch.device("cpu"), torch.device("meta")],
                           ("pod",))
    for call in (lambda: collectives.compressed_psum(x, "pod", mesh=spread,
                                                     config=CPU_ENGINE),
                 lambda: collectives.topk_psum(x, x, "pod", mesh=spread,
                                               config=CPU_ENGINE),
                 lambda: collectives.make_tree_reduce(spread),
                 lambda: gc.compressed_psum(x, "pod", mesh=spread),
                 lambda: gc.make_compressed_psum_fn(spread)):
        with pytest.raises(NotImplementedError, match="launch.mesh.spawn"):
            call()
    with pytest.raises(NotImplementedError, match="launch.mesh.spawn"):
        with sharding.use_mesh(spread):
            pass
    shared = mesh_lib.make_test_mesh((2,), ("data",), device="cpu")
    with sharding.use_mesh(shared):
        assert sharding.current_mesh() is shared
        assert sharding.dp_groups(8) == 2 and sharding.dp_groups(3) == 1
    assert sharding.current_mesh() is None
    x = torch.zeros(256)
    with sharding.use_mesh(None, policy="dp"):
        assert sharding.current_mesh() is None
        assert sharding.current_policy() == "dp"
        assert sharding.constrain(x, "dp", None) is x
        assert sharding.dp_groups(8) == 1
    assert sharding.current_policy() == "tp"


# --------------------------------------------------------------------------
# the per-row epilogue operand
# --------------------------------------------------------------------------


def _wire_table(n=6, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 255, (n, gc.QBLOCK)).astype(np.int32)
    dev = collectives.wire_dev(collectives.pack_bits_rows(
        torch.from_numpy(u), 8), chunk_elems=gc.QBLOCK, bits=8)
    dev["s"] = torch.from_numpy(
        rng.random((n, 1)).astype(np.float32) * 1e-2)
    dev["z"] = torch.tensor(127.0)
    return u, dev


def test_row_operands_fuse_only_where_the_spec_reads_them():
    """``fused_epilogue`` takes an (n_chunks, 1) operand only for a spec
    that declares ``row_operands`` (bitpack alone), with strides (0, 1);
    a single value keeps strides (0, 0); (n,), (n, 2), (1, n) and a
    non-contiguous (n, 1) are refused."""
    _, dev = _wire_table()
    epi = harness.Epilogue(out_dtype="float32", scale_key="s", zero_key="z")
    from repro_torch.core import registry
    assert [c for c in registry.names()
            if registry.get(c).decode.row_operands] == ["bitpack"]
    assert harness.fused_epilogue(epi, dev, 1) is None
    f = harness.fused_epilogue(epi, dev, 1, row_operands=True)
    assert f is not None and f.row_strides() == (0, 1)
    one = dict(dev, s=torch.tensor([0.5]))
    assert harness.fused_epilogue(epi, one, 1).row_strides() == (0, 0)
    # a table's 0-d out_lens (a caller's stand-in) still takes single values
    assert harness.fused_epilogue(epi, dict(one, out_lens=torch.tensor(6)),
                                  1, row_operands=True) is not None
    for bad in (dev["s"][:, 0], dev["s"].repeat(1, 2), dev["s"].T,
                dev["s"].repeat(1, 2)[:, :1]):
        assert harness.fused_epilogue(epi, dict(dev, s=bad), 1,
                                      row_operands=True) is None


def test_row_operand_wire_decode_equals_the_plain_body_plus_apply():
    """A wire table decodes in one dispatch with ``(u8 - 127) * s_row``
    fused, equal bit for bit to the plain bitpack body followed by
    ``Epilogue.apply`` and to ``(u - 127) * s`` in float32."""
    u, dev = _wire_table(n=37, seed=4)
    epi = harness.Epilogue(out_dtype="float32", scale_key="s", zero_key="z")
    before = (harness.EPILOGUE_FUSED, harness.EPILOGUE_UNFUSED)
    got = ops.decode(dev, codec="bitpack", width=1, chunk_elems=gc.QBLOCK,
                     backend="cuda", bits=8, epilogue=epi)
    assert (harness.EPILOGUE_FUSED - before[0],
            harness.EPILOGUE_UNFUSED - before[1]) == (1, 0)
    plain = epi.apply(bitpack.unpack(dev["comp_words"],
                                     chunk_elems=gc.QBLOCK, width=1, bits=8),
                      dev)
    assert got.dtype == torch.float32 and torch.equal(got, plain)
    want = (u.astype(np.float32) - np.float32(127)) * dev["s"].numpy()
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_operand_elsewhere_takes_the_counted_unfused_path():
    """Another codec given an (n, 1) scale decodes, then applies it as
    torch ops, counted in ``EPILOGUE_UNFUSED``: the same values."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 5, 4096).astype(np.uint8)
    table = enc.compress(a, "rle_v2", 512)
    dev, bits = ops.table_inputs(table, "cpu")
    dev["s"] = torch.from_numpy(rng.random((table.num_chunks, 1)).astype(
        np.float32))
    epi = harness.Epilogue(out_dtype="float32", scale_key="s")
    before = (harness.EPILOGUE_FUSED, harness.EPILOGUE_UNFUSED)
    got = ops.decode(dev, codec="rle_v2", width=1,
                     chunk_elems=table.chunk_elems, backend="cuda", bits=bits,
                     epilogue=epi)
    assert (harness.EPILOGUE_FUSED - before[0],
            harness.EPILOGUE_UNFUSED - before[1]) == (0, 1)
    raw = ops.decode(dev, codec="rle_v2", width=1,
                     chunk_elems=table.chunk_elems, backend="torch",
                     bits=bits)
    assert torch.equal(got, raw.to(torch.float32) * dev["s"])


def test_wire_geometry_packs_rows():
    """A 128-element float32 row is 32 vectors: 32 rows share a block's
    1,024 slots, so 6.4 M wire rows are ~201 K blocks, not 6.4 M."""
    g = bitpack.launch_geometry(6_435_000, gc.QBLOCK, 8, 4)
    assert g.fast and g.rows_per_block == 32 and g.tiles_per_row == 1
    assert g.blocks == -(-6_435_000 // 32)
    assert bitpack.launch_geometry(4, 65536, 4, 1).rows_per_block == 1
