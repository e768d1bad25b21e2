"""Host milliseconds of ``DecodePlan.build`` for every query of the cell,
in set-up."""


def read(run):
    v = run.setup.get("build_s")
    return None if v is None else 1e3 * v
