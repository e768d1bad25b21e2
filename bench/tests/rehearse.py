"""Tiny sizes for running the benchmark's cells on the CPU, through the
harness and the cells' own files, on the program's plain CPU bodies."""
CONFIG = {"chunk_bytes": 1024, "base_chunks": 2}
TABLE = {"table4_rle": 24, "table4_deflate": 14}
CHECK = {"check": {"drawn": 1, "drawn_from": 2}}


def overrides(config: str) -> dict:
    """``run_cell``'s keyword arguments for a tiny run of a cell."""
    return {"device": "cpu", "workers": 0,
            "config_over": {**CONFIG, "table_chunks": TABLE[config]},
            "traffic_over": dict(CHECK)}
