"""The share of points that landed in a boundary cell of the covering and
needed candidate resolution, in %: the program's ``GeoStats.n_need`` over
the points of the window.  The covering's level sets it."""


def read(run):
    c = run.counters
    return 100.0 * c["n_need"] / c["points"] if c.get("points") else None
