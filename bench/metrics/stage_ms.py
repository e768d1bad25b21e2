"""Host milliseconds of ``DecodePlan.stage`` for every query of the cell,
ending in a synchronize, in set-up."""


def read(run):
    v = run.setup.get("stage_s")
    return None if v is None else 1e3 * v
