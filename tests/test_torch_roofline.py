"""The port's roofline (``repro_torch.roofline``) held to the JAX package's
and to the numbers it must reproduce, on the CPU.

* ``Roofline`` against the H100 constants, the reference's test mirrored;
  ``model_flops_for`` equal to the reference's for every arch x shape.
* The analytic bounds ``chip_smoke.py`` prints, from ``abstract_params``
  at the arguments phases 11 and 12 pass, pinned to the values PERF.md §5
  records at their printed digits.
* ``count.count_costs`` on hand-built programs whose counts are known, on
  the CPU and on ``meta``, and on the reduced train step of each family,
  whose ``meta`` counts must equal its CPU counts.
* The collective sites' records, the refusal of a ``ctypes`` kernel under
  a counter, and ``moe.abstract_quantize_expert_weights`` against the
  reference's ``ShapeDtypeStruct`` s.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs.base import SHAPES as REF_SHAPES
from repro.roofline import analysis as ref_analysis
from repro_torch.configs import get_arch, list_archs, reduced
from repro_torch.configs.base import SHAPES
from repro_torch.core.engine import EngineConfig
from repro_torch.distributed import collectives
from repro_torch.kernels import cuda_build
from repro_torch.launch import steps
from repro_torch.models import model, moe
from repro_torch.optim import adamw
from repro_torch.roofline import analysis
from repro_torch.roofline.count import count_costs

DEVICES = ("cpu", "meta")


def test_roofline_terms_and_dominant():
    """The reference's test, at the H100's constants."""
    r = analysis.Roofline(flops=989e12, hbm_bytes=3.35e12 / 2,
                          coll_bytes=450e9 * 2, coll_by_op={},
                          model_flops=989e12 * 256, n_chips=256)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 0.5) < 1e-9
    assert abs(r.t_collective - 2.0) < 1e-9
    assert r.dominant == "collective"
    assert abs(r.useful_ratio - 1.0) < 1e-9
    assert abs(r.t_bound - 2.0) < 1e-9
    assert abs(r.mfu_bound - 0.5) < 1e-9
    ref = ref_analysis.Roofline(flops=1.0, hbm_bytes=1.0, coll_bytes=1.0,
                                coll_by_op={}, model_flops=1.0, n_chips=1)
    assert list(r.to_dict()) == list(ref.to_dict())


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_equal_the_reference(arch, shape):
    got = analysis.model_flops_for(get_arch(arch), SHAPES[shape])
    assert got == ref_analysis.model_flops_for(ref_get_arch(arch),
                                               REF_SHAPES[shape])


def _decode_bound(arch, n_layers=None):
    """Phases 11 (a) and 12 (a)-(c): 8 prompts of 64 tokens, 32 generated,
    a cache of 64 + 32 + 8 positions."""
    cfg = get_arch(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    cache = model.init_cache(cfg, 8, 104, device="meta")
    total = analysis.decode_step_bytes(cfg, model.abstract_params(cfg),
                                       cache, 8)[0]
    return total / analysis.HBM_BW * 1e3


def _train_bound(arch, n_layers):
    """Phases 11 (b) and 12 (d), (e): batch 8 x seq 512."""
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers)
    return analysis.train_step_bound(cfg, model.abstract_params(cfg), 8,
                                     512)[0]


@pytest.mark.parametrize("bound, want", [
    (lambda: _decode_bound("qwen3-1.7b"), "1.056"),
    (lambda: _decode_bound("qwen3-moe-235b-a22b", 4), "6.315"),
    (lambda: _decode_bound("rwkv6-1.6b"), "0.983"),
    (lambda: _decode_bound("zamba2-2.7b"), "2.266"),
    (lambda: _train_bound("qwen3-1.7b", 4), "12.84"),
    (lambda: _train_bound("qwen3-moe-235b-a22b", 1), "21.11"),
    (lambda: _train_bound("zamba2-2.7b", 6), "10.61"),
], ids=["decode-qwen3", "decode-moe", "decode-rwkv6", "decode-zamba2",
        "train-qwen3", "train-moe", "train-zamba2"])
def test_analytic_bounds_print_perf_md_digits(bound, want):
    digits = len(want.split(".")[1])
    assert f"{bound():.{digits}f}" == want


def test_decode_and_matmul_bounds():
    # 4 + 4 KiB of rows and out_lens read, 1 MiB of u32 written
    want = (4096 + 4 * 2 + 2 * 128 * 1024 * 4) / 3.35e12 * 1e3
    assert analysis.decode_bound_ms("rle_v2", 4096, 2, 128 * 1024, 4) == want
    # bitpack reads no out_lens; tdeflate reads its LUTs a chunk
    assert analysis.decode_bound_ms("bitpack", 4096, 2, 1024, 4) == \
        (4096 + 2 * 1024 * 4) / 3.35e12 * 1e3
    assert analysis.decode_bound_ms("tdeflate", 0, 1, 0, 1) == \
        (4 + analysis.LUT_BYTES["tdeflate"]) / 3.35e12 * 1e3
    ms, by = analysis.matmul_bound(2048, 2048, 2048, 2)
    assert by == "operations" and ms == 2 * 2048 ** 3 / 989e12 * 1e3
    ms, by = analysis.matmul_bound(1, 2048, 2048, 2)
    assert by == "bytes"


@pytest.mark.parametrize("device", DEVICES)
def test_counter_matmul_view_add(device):
    M, K, N = 64, 48, 32
    a = torch.ones((M, K), device=device)
    b = torch.ones((K, N), device=device)
    with count_costs() as c:
        a @ b
    got = c.only()
    assert got.flops == 2 * M * N * K
    assert got.bytes == (M * K + K * N + M * N) * 4
    assert got.peak == M * N * 4
    with count_costs() as c:
        a.t()
        a.view(K, M)
        a[1:]
        a.reshape(-1)
    assert c.by_device == {}            # views count nothing
    with count_costs() as c:
        a + a
    got = c.only()
    assert (got.flops, got.bytes, got.ops) == (M * K, 3 * M * K * 4, 1)


@pytest.mark.parametrize("device", DEVICES)
def test_counter_peak_of_a_known_chain(device):
    n = 1000
    x = torch.ones(n, device=device)           # an argument: not counted
    with count_costs() as c:
        a = x * 2                                # live 4n
        b = a + 1                                # live 8n
        del a                                    # live 4n
        y = torch.empty(3 * n, device=device)    # live 16n: the peak
        del y, b                                 # live 0
        z = x.sum()                              # live 4 bytes
    got = c.only()
    assert got.peak == 16 * n
    assert got.live == 4 and z.numel() == 1
    # empty writes nothing; sum is a reduction: one FLOP an output element;
    # a Python scalar operand is no tensor
    assert got.flops == 2 * n + 1
    assert got.bytes == 2 * (2 * n * 4) + (n + 1) * 4


def _train_inputs(cfg, device, B=2, S=64):
    if device == "meta":
        params, opt = steps.abstract_train_state(cfg)
    else:
        params = model.init_params(cfg, torch.Generator().manual_seed(0),
                                   device=device)
        opt = adamw.init(params, adamw.AdamWConfig())
    batch = {k: torch.zeros((B, S), dtype=torch.int32, device=device)
             for k in ("tokens", "labels")}
    return params, opt, batch


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen3-moe-235b-a22b",
                                  "rwkv6-1.6b", "zamba2-2.7b"])
def test_train_step_counts_equal_on_meta_and_cpu(arch, monkeypatch):
    """FLOPs, bytes, ops and the peak of the reduced train step are the
    same on ``meta`` as on the CPU.  The CPU's square roots are taken in
    float64 by design (``adamw._sqrt``), another program than a card's or
    ``meta``'s: both runs here take the plain one."""
    monkeypatch.setattr(adamw, "_sqrt", torch.sqrt)
    cfg = reduced(get_arch(arch), n_layers=2)
    got = {}
    for device in DEVICES:
        step = steps.build_train_step(cfg)
        args = _train_inputs(cfg, device)
        with count_costs() as c:
            out = step(*args)
        del out
        got[device] = c.only().as_dict()
    assert got["meta"] == got["cpu"]
    assert got["meta"]["flops"] > 0 and got["meta"]["peak"] > 0


def test_kernel_launch_under_a_counter_raises():
    class Never:
        entry = "codag_rle_decode"

        def fn(self):
            raise AssertionError("launched")

    with count_costs():
        with pytest.raises(RuntimeError, match="ctypes"):
            cuda_build.launch(Never(), 1, 2)


def test_collective_sites_record_their_gathers():
    """``compressed_psum`` records the all-gather of its members' wire
    tables and scales; ``topk_psum`` of its bitmaps and f16 values: the
    gathered entries' bytes."""
    n, size = 3, 1000
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(n, size)).astype(np.float32))
    cpu = EngineConfig(device="cpu")
    dev = collectives.gathered_wire(x)
    rows = dev["out_lens"].shape[0]
    want = sum(v.numel() * v.element_size() for k, v in dev.items()
               if k != "bitpack_bits" and isinstance(v, torch.Tensor)
               and v.dim() >= 1 and v.shape[0] == rows)
    with count_costs() as c:
        collectives.compressed_psum(x, config=cpu)
    assert c.at("cpu").coll == {"all-gather": want}
    with count_costs() as c:
        collectives.topk_psum(x, torch.zeros_like(x), config=cpu)
    k = int(size * 0.01)
    gathered = c.at("cpu").coll["all-gather"]
    assert gathered > n * k * 2            # the values and the bitmaps
    assert set(c.at("cpu").coll) == {"all-gather"}


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"])
def test_abstract_quantized_experts_equal_the_reference(arch):
    import jax
    from repro.models import model as ref_model
    from repro.models import moe as ref_moe
    got = moe.abstract_quantize_expert_weights(
        model.abstract_params(get_arch(arch))["blocks"]["moe"])
    want = ref_moe.abstract_quantize_expert_weights(
        ref_model.abstract_params(ref_get_arch(arch))["blocks"]["moe"])
    for key in ("w_up", "w_gate", "w_down"):
        for part, dtype in (("q", torch.int8), ("s", torch.float32)):
            t, w = got[key][part], want[key][part]
            assert isinstance(w, jax.ShapeDtypeStruct)
            assert tuple(t.shape) == tuple(w.shape)
            assert t.dtype == dtype and str(w.dtype) == str(dtype)[6:]
            assert t.device.type == "meta"
    assert got["router"] is not None and "router" in want
