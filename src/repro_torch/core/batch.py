"""Multi-blob batched decompression — the reference's compatibility names.

The scheduler's machinery (grouping, staging, scatter, the executors) lives
in :mod:`repro_torch.core.plan` as the ``DecodePlan`` IR; this module keeps
the reference's older public names (``repro/core/batch.py``) working:

    from repro_torch.core import batch
    outs = batch.decompress_blobs(blobs, engine)  # len(outs) == len(blobs)
    plan = batch.BatchPlan.build(blobs)           # == plan.DecodePlan.build
"""
from __future__ import annotations

from repro_torch.core import plan as _plan

DecodePlan = _plan.DecodePlan
PlanGroup = _plan.PlanGroup
decompress_blobs = _plan.decompress_blobs

# historical names
BatchPlan = _plan.DecodePlan
GroupPlan = _plan.PlanGroup
