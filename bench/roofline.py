"""The yardstick of a decode's roofline, frozen here.

The least time a decode can take on the card is its bytes over the card's
memory bandwidth: each compressed payload byte read once and each decoded
byte the caller receives written once (a decode does a few integer
operations a byte, far below the card's rate of operations, so bytes bound
it).  Bytes are counted from the benchmark's own blobs, not from the
program.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 at 3.35 TB/s, at the full 700 W.
HBM_BW = 3.35e12


def least_bytes(query) -> int:
    """Bytes a query's decode has to move: payload read plus output written."""
    return query.payload_bytes + query.user_bytes


def least_seconds(query) -> float:
    return least_bytes(query) / HBM_BW
