"""The benchmark on the card, at a size a test run holds: every cell comes
out correct with the program in the window, and not correct with the
control or any fault in its place (on the card an unwritten output reads
the poison set-up leaves in free memory).  Skips without a card."""
import json
from pathlib import Path

import pytest

from bench import control, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SMALL = {"config_over": {"table_chunks": 1024, "base_chunks": 16},
         "traffic_over": {"check": {"drawn": 2,
                                    "drawn_from": 8}}}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    res = harness.run_cell(cell, 2**31 + 11, 1.0, True, **SMALL)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    assert all(n and n != "void" for n, _ in res["breakdown"]["device_ops"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("what", control.WHAT)
def test_control_and_faults_on_the_card(card, cell, what):
    res = control.run(cell, 2**31 + 12, 1.0, what, **SMALL)
    assert res["correct"] is False, (what, res["checks"])
