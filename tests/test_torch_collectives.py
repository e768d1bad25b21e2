"""The port's collective plane (``launch/mesh.py``, the member half of
``distributed/sharding.py``, ``core/plan.gather_member_tables``,
``distributed/collectives.py``' compressed all-reduces and
``optim/grad_compress.py``' seed path) held to the JAX package on the CPU.

The reference's collectives run inside ``shard_map`` over a multi-device
mesh, so its half runs as ``tests/test_distributed.py`` runs it: one
subprocess on 8 virtual CPU devices
(``--xla_force_host_platform_device_count=8``), started when the first test
of this file asks for it, computing every reference case from numpy inputs
made here from a seed and writing an ``.npz``.  The port's meshes are the
same shapes with every member on the CPU.

Tolerances: the int8 wire's member sum within ``n * 2^-23 * max|dequantized|``
elementwise of the reference's (the reference adds in another order, or
contracts a multiply and an add into an FMA: its own two int8 paths differ
by up to 4.77e-7 on unit normals), and within ``2 * max|x| / 127`` of the
exact float32 sum (the reference test's bound); the port's two int8 paths,
integer tables and top-k selections equal bit for bit.
"""
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.distributed import collectives as rcoll
from repro_torch.configs import get_arch, reduced
from repro_torch.core import plan as plan_mod
from repro_torch.core.engine import EngineConfig
from repro_torch.distributed import collectives, sharding
from repro_torch.kernels import bitpack, harness, ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model
from repro_torch.optim import grad_compress as gc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = EngineConfig(device="cpu")
PSUM_SIZE = 4096 + 77              # a leaf that is not a multiple of 128
ULP = 2.0 ** -23


def _inputs() -> dict:
    rng = np.random.default_rng(22)
    inp = {
        "ragged_vals": (np.arange(2 * 3 * 128, dtype=np.uint32)
                        .reshape(2, 3, 128) % 251),
        "ragged_scale": rng.uniform(0.01, 0.1, (2, 3, 1)).astype(np.float32),
        "tree_a": rng.standard_normal((2, 300)).astype(np.float32),
        "tree_b": (3 * rng.standard_normal((2, 16, 40))).astype(np.float32),
        "topk_g": rng.standard_normal((2, 1000)).astype(np.float32),
        "tr_w": rng.standard_normal((2, 300)).astype(np.float32),
        "tr_b": rng.standard_normal((2, 5)).astype(np.float32),
        "tr_m": (0.1 * rng.standard_normal((2, 16, 40))).astype(np.float32),
    }
    for n in (2, 4, 8):
        inp[f"psum_x{n}"] = rng.standard_normal((n, PSUM_SIZE)).astype(
            np.float32)
    return inp


INPUTS = _inputs()

REF = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.core import plan as plan_mod, tuning
from repro.core.engine import EngineConfig
from repro.distributed import collectives as C
from repro.kernels.harness import Epilogue
from repro.optim import grad_compress as gc

inp = dict(np.load(sys.argv[1]))
out = {}
devs = jax.devices()
tune = tuning.kernel_tune("bitpack", 1)


def mesh_of(n):
    return Mesh(np.asarray(devs).reshape(n, 8 // n), ("pod", "data"))


def smap(mesh, body, n_in, n_out=1):
    specs = tuple(P("pod") for _ in range(n_in))
    outs = P("pod") if n_out == 1 else tuple(P("pod") for _ in range(n_out))
    return jax.jit(shard_map(body, mesh=mesh, in_specs=specs,
                             out_specs=outs, check_rep=False))


mesh = mesh_of(2)

# ragged gather, then the member reduce over the ragged table
def ragged(v, c, s):
    dev = C.wire_dev(C.pack_bits_rows(v[0], 8), chunk_elems=128, bits=8)
    g = plan_mod.gather_member_tables(dev, "pod", codec="bitpack",
                                      row_counts=c[0, 0])
    g["wire_scale"] = lax.all_gather(s[0], "pod").reshape(-1, 1)
    g["wire_zero"] = jnp.float32(C.WIRE_ZERO)
    epi = Epilogue(out_dtype="float32", scale_key="wire_scale",
                   zero_key="wire_zero", fn=C._member_reduce(2, False))
    red = plan_mod.dispatch(g, config=EngineConfig(), codec="bitpack",
                            width=1, chunk_elems=128, bits=8, epilogue=epi,
                            tune=tune)
    return (g["out_lens"][None], g["comp_lens"][None],
            g["comp_words"][None], red[None])

counts = jnp.asarray([[2], [3]], jnp.int32)
ol, cl, cw, red = smap(mesh, ragged, 3, 4)(
    jnp.asarray(inp["ragged_vals"]), counts, jnp.asarray(inp["ragged_scale"]))
out["ragged_out_lens"] = np.asarray(ol)[0]
out["ragged_comp_lens"] = np.asarray(cl)[0]
out["ragged_comp_words"] = np.asarray(cw)[0]
out["ragged_reduce"] = np.asarray(red)[0]

# compressed_psum at 2, 4 and 8 members, and the seed path
for n in (2, 4, 8):
    m = mesh_of(n)
    x = jnp.asarray(inp[f"psum_x{n}"])
    for mean in (False, True):
        f = smap(m, lambda xs, mean=mean: C.compressed_psum(
            xs[0], "pod", tune=tune, mean=mean)[None], 1)
        out[f"psum{n}_{int(mean)}"] = np.asarray(f(x))[0]
    f = smap(m, lambda xs: gc.compressed_psum(xs[0], "pod")[None], 1)
    out[f"seed{n}"] = np.asarray(f(x))[0]

# make_compressed_psum_fn over a tree
tree = {"a": jnp.asarray(inp["tree_a"]), "b": jnp.asarray(inp["tree_b"])}
with mesh:
    r = jax.jit(gc.make_compressed_psum_fn(mesh, "pod"))(tree)
out["cpf_a"], out["cpf_b"] = np.asarray(r["a"]), np.asarray(r["b"])

# topk_psum over three rounds of error feedback
def tk(xs, rs):
    d, nr = C.topk_psum(xs[0], rs[0], "pod", frac=0.01, mean=True,
                        tune=tune)
    return d[None], nr[None]

f = smap(mesh, tk, 2, 2)
g = jnp.asarray(inp["topk_g"])
res = jnp.zeros_like(g)
for i in range(3):
    dense, res = f(g, res)
    out[f"topk_dense{i}"] = np.asarray(dense)[0]
    out[f"topk_res{i}"] = np.asarray(res)

# make_tree_reduce for each wire
tree = {"w": jnp.asarray(inp["tr_w"]), "b": jnp.asarray(inp["tr_b"]),
        "m": jnp.asarray(inp["tr_m"])}
for wire in ("int8", "topk", "none"):
    f = C.make_tree_reduce(mesh, "pod", wire=wire)
    res = jax.tree.map(jnp.zeros_like, tree) if wire == "topk" else None
    with mesh:
        mean, nr = jax.jit(lambda t, r: f(t, r))(tree, res)
    for k in tree:
        out[f"tree_{wire}_{k}"] = np.asarray(mean[k])
        if nr is not None:
            out[f"tree_{wire}_res_{k}"] = np.asarray(nr[k])
np.savez(sys.argv[2], **out)
print("PASS")
'''


class RefRun:
    """The reference's subprocess, started once a module and waited for on
    first use."""

    def __init__(self, tmp):
        self.inp, self.out = tmp / "in.npz", tmp / "out.npz"
        np.savez(self.inp, **INPUTS)
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        env["PYTHONPATH"] = os.path.join(ROOT, "src")
        env["JAX_PLATFORMS"] = "cpu"
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REF, str(self.inp), str(self.out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        self._res = None

    def get(self) -> dict:
        if self._res is None:
            so, se = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0 and "PASS" in so, \
                f"stdout:\n{so}\nstderr:\n{se[-4000:]}"
            self._res = dict(np.load(self.out))
        return self._res

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    run = RefRun(tmp_path_factory.mktemp("collectives_ref"))
    yield run
    run.close()


def _mesh(n: int):
    return mesh_lib.make_test_mesh((n, 8 // n), ("pod", "data"),
                                   device="cpu")


def _t(name: str) -> torch.Tensor:
    return torch.from_numpy(INPUTS[name].copy())


# --------------------------------------------------------------------------
# meshes and the member half of sharding (no reference numbers needed)
# --------------------------------------------------------------------------


def test_meshes_name_their_axes_and_devices(ref):
    m = _mesh(2)
    assert m.axis_names == ("pod", "data") and dict(m.shape) == \
        {"pod": 2, "data": 4}
    assert m.size == 8 and m.shared_device == torch.device("cpu")
    one = mesh_lib.make_decode_mesh(device="cpu")
    assert dict(one.shape) == {"data": 1}
    assert one.shared_device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        mesh_lib.make_decode_mesh(2, device="cpu")
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"need {n} devices .* have 1"):
            mesh_lib.make_production_mesh(multi_pod=multi, device="cpu")
    assert sharding.decode_axis(m) == "data"
    assert sharding.decode_axis(mesh_lib.make_test_mesh(
        (2,), ("pod",), device="cpu")) == "pod"
    assert sharding.dp_axes(m) == ("pod", "data")
    tp = mesh_lib.make_test_mesh((2, 2), ("data", "model"), device="cpu")
    with sharding.use_mesh(None, policy="dp"):
        assert sharding.dp_axes(tp) == ("data", "model")
    assert sharding.dp_axes(tp) == ("data",)
    ms = sharding.member_sharding(m, "pod", 3)
    assert ms.spec == ("pod", None, None)
    assert ms.device == torch.device("cpu")


def test_entry_points_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (mesh_lib.make_decode_mesh, mesh_lib.make_test_mesh,
                 lambda: collectives.compressed_psum(torch.zeros(2, 256))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_the_member_reduce_entry_is_bound_to_its_signature():
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_int64: "l"}
    entry = bitpack.REDUCE
    m = re.search(rf'extern "C" int {entry.entry}\s*\(([^)]*)\)',
                  entry.source.read_text())
    params = [p.strip() for p in m.group(1).split(",")]
    want = "".join("p" if "*" in p else "l" if "int64_t" in p else "i"
                   for p in params)
    assert "".join(kinds[t] for t in entry.argtypes) == want
    assert entry.lib is bitpack.LIB and not entry.loaded


def test_only_a_member_reduce_fuses_and_only_where_the_kernel_reduces():
    n, nb = 3, 5
    dev = {"out_lens": torch.full((n * nb,), 128, dtype=torch.int32),
           "s": torch.rand(n * nb, 1), "z": torch.tensor(127.0)}
    red = collectives._member_reduce(n, True)
    assert red is collectives._member_reduce(n, True)
    assert red == harness.MemberReduce(3, True) and hash(red) == \
        hash(harness.MemberReduce(3, True))
    epi = harness.Epilogue(out_dtype="float32", scale_key="s", zero_key="z",
                           fn=red)
    f = harness.fused_epilogue(epi, dev, 1, True, bitpack.REDUCE_BITS, 8)
    assert f is not None and f.reduce is red and not f.bits_only
    assert f.row_strides() == (0, 1)
    # another fn, a width the kernel does not reduce at, a table that is not
    # whole members, an integer output: unfused
    assert harness.fused_epilogue(harness.Epilogue(
        out_dtype="float32", scale_key="s", zero_key="z",
        fn=lambda o, d: o), dev, 1, True, bitpack.REDUCE_BITS, 8) is None
    assert harness.fused_epilogue(epi, dev, 1, True, bitpack.REDUCE_BITS,
                                  7) is None
    assert harness.fused_epilogue(epi, dev, 1, True, (), 8) is None
    odd = dict(dev, out_lens=dev["out_lens"][:-1], s=dev["s"][:-1])
    assert harness.fused_epilogue(epi, odd, 1, True, bitpack.REDUCE_BITS,
                                  8) is None
    assert harness.fused_epilogue(harness.Epilogue(
        out_dtype="int32", fn=red), dev, 1, True, bitpack.REDUCE_BITS,
        8) is None
    assert bitpack.CODEC.decode.reduce_bits == bitpack.REDUCE_BITS
    # the plain version adds in member order, then divides
    x = torch.randn(n * nb, 128)
    want = (x[:nb] + x[nb:2 * nb] + x[2 * nb:]) / 3
    assert torch.equal(red(x), want)


def test_a_member_reduce_on_the_block_unit_refuses_to_split_the_table():
    x = torch.randn(4, 1024)
    block = EngineConfig(device="cpu", unit="block", n_units=2)
    with pytest.raises(ValueError, match="whole gathered table"):
        collectives.compressed_psum(x, config=block)


def test_a_mesh_over_distinct_devices_raises_pointing_to_spawn():
    """One process holds a mesh whose members share one device: the
    collectives, the seed path, a member sharding's device and the list
    form of ``gather_member_tables`` over distinct devices raise, pointing
    to ``launch.mesh.spawn`` (one process a member)."""
    spread = mesh_lib.Mesh([torch.device("cpu"), torch.device("meta")],
                           ("pod",))
    assert spread.shared_device is None
    x = torch.zeros(2, 256)
    for call in (lambda: collectives.make_tree_reduce(spread),
                 lambda: collectives.compressed_psum(x, mesh=spread,
                                                     config=CPU),
                 lambda: collectives.topk_psum(x, x, mesh=spread,
                                               config=CPU),
                 lambda: gc.make_compressed_psum_fn(spread),
                 lambda: gc.compressed_psum(x, mesh=spread),
                 lambda: sharding.member_sharding(spread).device):
        with pytest.raises(NotImplementedError, match="launch.mesh.spawn"):
            call()
    w = collectives.pack_bits_rows(torch.zeros(1, 128, dtype=torch.int32), 8)
    tables = [collectives.wire_dev(w, chunk_elems=128, bits=8),
              collectives.wire_dev(w.to("meta"), chunk_elems=128, bits=8)]
    with pytest.raises(NotImplementedError, match="launch.mesh.spawn"):
        plan_mod.gather_member_tables(tables, codec="bitpack")


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------


def test_gather_member_tables_ragged_matches_the_reference(ref):
    """Member 0 has 2 real chunks, member 1 has 3, both padded to 3 rows:
    the padding row's lens are zeroed; the gathered words equal the
    reference's; the member reduce over the ragged table (the padding row
    adds its words' values, as in the reference) equals the reference's."""
    want = ref.get()
    vals = _t("ragged_vals")
    scale = _t("ragged_scale")
    tables = [collectives.wire_dev(collectives.pack_bits_rows(vals[m], 8),
                                   chunk_elems=128, bits=8) for m in (0, 1)]
    g = plan_mod.gather_member_tables(tables, codec="bitpack",
                                      row_counts=[2, 3])
    np.testing.assert_array_equal(g["out_lens"].numpy(),
                                  [128, 128, 0, 128, 128, 128])
    np.testing.assert_array_equal(g["out_lens"].numpy(),
                                  want["ragged_out_lens"])
    np.testing.assert_array_equal(g["comp_lens"].numpy(),
                                  want["ragged_comp_lens"])
    assert g["out_lens"].dtype == torch.int32
    np.testing.assert_array_equal(g["comp_words"].numpy(),
                                  want["ragged_comp_words"])
    assert g["bitpack_bits"] is tables[0]["bitpack_bits"]
    g["wire_scale"] = scale.reshape(-1, 1)
    g["wire_zero"] = torch.tensor(collectives.WIRE_ZERO)
    epi = harness.Epilogue(out_dtype="float32", scale_key="wire_scale",
                           zero_key="wire_zero",
                           fn=collectives._member_reduce(2, False))
    before = harness.EPILOGUE_UNFUSED
    red = plan_mod.dispatch(g, config=CPU, codec="bitpack", width=1,
                            chunk_elems=128, bits=8, epilogue=epi)
    assert harness.EPILOGUE_UNFUSED == before
    bound = 2 * ULP * float(np.abs(want["ragged_reduce"]).max())
    np.testing.assert_allclose(red.numpy(), want["ragged_reduce"], rtol=0,
                               atol=bound)


def _psum_bounds(x: np.ndarray, n: int) -> tuple:
    """(the bound against the reference's result, against the exact sum)."""
    deq = float(np.abs(x).max()) * (1 + 1e-6)
    return n * ULP * deq, 2 * deq / 127 + 1e-6


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("mean", [False, True])
def test_compressed_psum_matches_the_reference(ref, n, mean):
    want = ref.get()
    x = _t(f"psum_x{n}")
    before = (harness.EPILOGUE_FUSED, harness.EPILOGUE_UNFUSED)
    with ops.count_dispatches() as calls:
        got = collectives.compressed_psum(x, "pod", mesh=_mesh(n),
                                          config=CPU, mean=mean)
    # one dispatch a leaf, the dequant and member reduce in its epilogue
    assert [(c["codec"], c["num_chunks"], c["bits"]) for c in calls] == \
        [("bitpack", n * -(-PSUM_SIZE // 128), 8)]
    assert harness.EPILOGUE_FUSED == before[0] + 1
    assert harness.EPILOGUE_UNFUSED == before[1]
    assert got.shape == (PSUM_SIZE,) and got.dtype == torch.float32
    to_ref, to_exact = _psum_bounds(INPUTS[f"psum_x{n}"], n)
    np.testing.assert_allclose(got.numpy(), want[f"psum{n}_{int(mean)}"],
                               rtol=0, atol=to_ref)
    exact = INPUTS[f"psum_x{n}"].astype(np.float64).sum(0)
    if mean:
        exact = exact / n
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=to_exact)
    # the wire path equals the seed path bit for bit (the same adds)
    seed = gc.compressed_psum(x, "pod", mesh=_mesh(n))
    if mean:
        seed = seed / torch.tensor(float(n))
    assert torch.equal(got, seed)
    if not mean:
        np.testing.assert_allclose(seed.numpy(), want[f"seed{n}"], rtol=0,
                                   atol=to_ref)


def test_make_compressed_psum_fn_matches_the_reference(ref):
    want = ref.get()
    tree = {"a": _t("tree_a"), "b": _t("tree_b")}
    got = gc.make_compressed_psum_fn(_mesh(2), "pod")(tree)
    for k in tree:
        assert got[k].shape == tree[k].shape
        assert torch.equal(got[k][0], got[k][1])
        to_ref, _ = _psum_bounds(INPUTS[f"tree_{k}"], 2)
        np.testing.assert_allclose(got[k].numpy(), want[f"cpf_{k}"], rtol=0,
                                   atol=to_ref)


def test_topk_psum_error_feedback_matches_the_reference(ref):
    """Three rounds of top-k 1% with error feedback: every round's dense
    mean and residuals equal the reference's (the same selections, the same
    f16 values); entries below the bar cross once the residual carries them
    over it, and each round moves exactly k values a member."""
    want = ref.get()
    g = _t("topk_g")
    res = torch.zeros_like(g)
    k = int(1000 * 0.01)
    moved = torch.zeros(1000, dtype=torch.bool)
    for i in range(3):
        before = harness.EPILOGUE_UNFUSED
        dense, res = collectives.topk_psum(g, res, "pod", mesh=_mesh(2),
                                           frac=0.01, config=CPU, mean=True)
        # the scatter needs a prefix sum over a whole bitmap: unfused
        assert harness.EPILOGUE_UNFUSED == before + 1
        np.testing.assert_array_equal(res.numpy(), want[f"topk_res{i}"])
        np.testing.assert_allclose(dense.numpy(), want[f"topk_dense{i}"],
                                   rtol=ULP, atol=0)
        assert int((dense != 0).sum()) <= 2 * k
        assert int((res == 0).sum()) == 2 * k   # what crossed this round
        moved |= dense != 0
    assert int(moved.sum()) > 2 * k        # the residual carried new entries


def test_make_tree_reduce_matches_the_reference_for_each_wire(ref):
    """int8 (a 5-element leaf under one quant block takes the plain member
    mean), top-k with residuals, and the uncompressed mean."""
    want = ref.get()
    tree = {"w": _t("tr_w"), "b": _t("tr_b"), "m": _t("tr_m")}
    for wire in ("int8", "topk", "none"):
        f = collectives.make_tree_reduce(_mesh(2), "pod", wire=wire,
                                         config=CPU)
        res = ({k: torch.zeros_like(v) for k, v in tree.items()}
               if wire == "topk" else None)
        mean, nr = f(tree, res)
        assert (nr is None) == (wire != "topk")
        for k, x in tree.items():
            assert mean[k].shape == x.shape[1:]
            w = want[f"tree_{wire}_{k}"]
            if wire == "int8" and x[0].numel() >= gc.QBLOCK:
                to_ref, _ = _psum_bounds(INPUTS[f"tr_{k}"], 2)
                np.testing.assert_allclose(mean[k].numpy(), w, rtol=0,
                                           atol=to_ref)
            elif wire == "topk" and x[0].numel() >= gc.QBLOCK:
                np.testing.assert_allclose(mean[k].numpy(), w, rtol=ULP,
                                           atol=0)
                np.testing.assert_array_equal(
                    nr[k].numpy(), want[f"tree_{wire}_res_{k}"])
            else:       # the plain float32 member mean: two members, exact
                np.testing.assert_array_equal(mean[k].numpy(), w)
    with pytest.raises(ValueError, match="residuals"):
        collectives.make_tree_reduce(_mesh(2), wire="topk", config=CPU)(tree)
    with pytest.raises(ValueError, match="unknown wire"):
        collectives.make_tree_reduce(_mesh(2), wire="fp8", config=CPU)


def test_wire_report_keeps_the_reference_ratios():
    """The outer sync's bytes for the ``tiny`` olmo tree at 2 pods: 3.88x
    for the int8 wire and 27.6x for top-k 1% against the float32 ring (the
    reference's collectives baseline, 2 pods on 8 virtual devices), equal
    to the reference's ``wire_report`` at 2, 4 and 8 members."""
    cfg = reduced(get_arch("olmo-1b"))
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    shapes = {k: np.zeros(tuple(v.shape), np.float32)
              for k, v in _flat(params).items()}
    for n in (2, 4, 8):
        for wire in ("int8", "topk", "none"):
            assert collectives.wire_report(params, n, wire=wire) == \
                rcoll.wire_report(shapes, n, wire=wire)
    assert collectives.wire_report(params, 2, wire="int8")["ratio"] == \
        3.878787878787879
    assert collectives.wire_report(params, 2, wire="topk")["ratio"] == \
        27.588684328693308


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}
