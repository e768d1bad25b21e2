"""The paper's Table IV datasets, as seeded numpy generators, frozen.

A copy of the repository's Table IV mirrors (CODAG, arXiv:2307.03760,
§VI), kept here so that no later change elsewhere can change the
benchmark's data.  Each generator returns exactly ``n_bytes`` of its
column; where the original could fall short of its budget (MC0, MC3 draw
runs of random length), this copy draws enough runs and cuts, which keeps
the distribution.

| name | mirrors             | dtype   | structure                        |
|------|---------------------|---------|----------------------------------|
| MC0  | Mortgage col 0      | uint64  | very long runs                   |
| MC3  | Mortgage col 3      | float32 | long runs of repeated floats     |
| TPC  | Taxi passenger cnt  | int8    | run len ~1-6, tiny alphabet      |
| TPT  | Taxi payment type   | uint8   | ~unit runs, 4-symbol alphabet    |
| CD2  | Criteo dense 2      | uint32  | power-law values                 |
| TC2  | Twitter COO col 1   | uint64  | sorted ids -> delta-friendly     |
| HRG  | Human ref genome    | uint8   | ACGTN with repeated motifs       |
"""
from __future__ import annotations

import numpy as np

DTYPES = {"MC0": np.uint64, "MC3": np.float32, "TPC": np.int8,
          "TPT": np.uint8, "CD2": np.uint32, "TC2": np.uint64,
          "HRG": np.uint8}


def _mc0(rng, n):
    vals = rng.integers(0, 500, n // 200 + 1).astype(np.uint64)
    lens = rng.integers(200, 1000, len(vals))
    return np.repeat(vals, lens)[:n]


def _mc3(rng, n):
    vals = rng.normal(3.5, 1.0, n // 100 + 1).astype(np.float32)
    lens = rng.integers(100, 500, len(vals))
    return np.repeat(vals, lens)[:n]


def _tpc(rng, n):
    vals = rng.choice(np.arange(1, 7, dtype=np.int8), n,
                      p=[0.72, 0.14, 0.06, 0.04, 0.03, 0.01])
    runs = rng.integers(0, n - 8, n // 6)
    for s in runs[:2000]:      # short runs: smear
        vals[s:s + int(rng.integers(2, 6))] = vals[s]
    return vals


def _tpt(rng, n):
    return rng.choice(np.frombuffer(b"1234", np.uint8), n,
                      p=[0.55, 0.41, 0.03, 0.01])


def _cd2(rng, n):
    return np.minimum(rng.zipf(1.5, n), 2 ** 31).astype(np.uint32)


def _tc2(rng, n):
    return np.sort(rng.integers(0, 2 ** 33, n).astype(np.uint64))


def _hrg(rng, n):
    motif = rng.choice(np.frombuffer(b"ACGT", np.uint8), 400)
    out = np.empty(n, np.uint8)
    pos = 0
    while pos < n:
        if rng.random() < 0.3:   # repeated motif
            m = motif[:min(len(motif), n - pos)]
        else:
            m = rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                           min(int(rng.integers(50, 300)), n - pos),
                           p=[0.29, 0.21, 0.21, 0.28, 0.01])
        out[pos:pos + len(m)] = m
        pos += len(m)
    return out


_MAKE = {"MC0": _mc0, "MC3": _mc3, "TPC": _tpc, "TPT": _tpt, "CD2": _cd2,
         "TC2": _tc2, "HRG": _hrg}


def make(name: str, rng: np.random.Generator, n_bytes: int) -> np.ndarray:
    """``n_bytes`` of dataset ``name`` from ``rng``."""
    width = np.dtype(DTYPES[name]).itemsize
    if n_bytes % width:
        raise ValueError(f"{name}: {n_bytes} bytes is no whole number of "
                         f"{width}-byte elements")
    out = _MAKE[name](rng, n_bytes // width)
    if out.nbytes != n_bytes or out.dtype != DTYPES[name]:
        raise AssertionError(f"{name}: made {out.nbytes} bytes of "
                             f"{out.dtype}")
    return out
