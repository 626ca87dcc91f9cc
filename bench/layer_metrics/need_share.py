"""The share of points that needed candidate resolution, in %: the
program's ``GeoStats.n_need`` (summed over the levels of the cascade)
over the points of the window."""


def read(run):
    c = run.counters
    return 100.0 * c["n_need"] / c["points"] if c.get("points") else None
