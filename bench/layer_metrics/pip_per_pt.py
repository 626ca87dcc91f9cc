"""Candidate point-in-polygon tests a point: the program's
``GeoStats.n_pip`` over the points of the window."""


def read(run):
    c = run.counters
    return c["n_pip"] / c["points"] if c.get("points") else None
