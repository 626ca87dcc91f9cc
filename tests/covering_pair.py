"""The port reports facts of its covering that the JAX package does not
(``GeoIndexSet.covering_facts``: in ``memory_footprint()`` and under
``GeoEngine.explain()["covering"]``).  These helpers split them off, so a
test compares the rest with the JAX package's dicts, and check them
against the engine's own covering and fast index.  No test file.
"""
from repro_torch.core.artifact import COVERING_KEYS


def facts_of(indices) -> dict:
    """What the facts must read for a ``GeoIndexSet``."""
    cov, fast = indices.covering, indices.fast
    return {
        "covering_level": 0 if cov is None else int(cov.max_level),
        "covering_cells": 0 if cov is None else len(cov.lo),
        "covering_boundary_cells": (0 if cov is None
                                    else int((cov.val < 0).sum())),
        "covering_bytes": 0 if cov is None else int(
            sum(a.nbytes for a in (cov.lo, cov.hi, cov.val, cov.level,
                                   cov.cand))),
        "search_iters": 0 if fast is None else int(fast.search_iters),
    }


def without_covering(engine) -> dict:
    """``engine.explain()`` without ``"covering"``, once that is checked."""
    plan = engine.explain()
    assert plan.pop("covering") == facts_of(engine.indices)
    return plan


def shared_footprint(indices, ref: dict) -> dict:
    """``indices.memory_footprint()`` cut to the keys of ``ref`` (the JAX
    package's), once the port's own keys are checked."""
    fp = indices.memory_footprint()
    assert set(fp) - set(ref) == set(COVERING_KEYS)
    assert {k: fp[k] for k in COVERING_KEYS} == facts_of(indices)
    return {k: fp[k] for k in ref}
