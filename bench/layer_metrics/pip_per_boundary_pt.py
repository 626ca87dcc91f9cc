"""Candidate point-in-polygon tests a point that needed resolution: the
program's ``GeoStats.n_pip`` over its ``GeoStats.n_need``, summed over
the window.  The two-phase resolution's cost a boundary point."""


def read(run):
    c = run.counters
    return c["n_pip"] / c["n_need"] if c.get("n_need") else None
