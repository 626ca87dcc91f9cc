"""GeoLint (``repro.analysis``) over the port: every rule — lock
discipline on the ``# guarded-by:`` fields of the serving, analytics and
obs modules, wall-clock use, the compat boundary, trace purity, unused
imports, unreachable code — finds nothing in src/repro_torch, as over
src/repro (scripts/check_static.py ratchets that tree at zero).
"""
import os

import pytest

from repro.analysis import ALL_RULES, collect_guards, load_modules, run_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


@pytest.fixture(scope="module")
def findings():
    return run_all([PORT])


@pytest.mark.parametrize("rule", ALL_RULES)
def test_port_has_no_findings(findings, rule):
    hits = [f"{os.path.relpath(f.path, REPO)}:{f.line}: {f.message}"
            for f in findings if f.rule == rule]
    assert not hits, "\n".join(hits)


def test_lock_annotations_are_seen():
    """The rule has something to check: the port's guarded fields (the
    server's ticket and region, the window state, the cache, the metrics
    registry, the profiler session) are collected."""
    guards = [g for mod in load_modules([PORT])
              for g in collect_guards(mod)]
    owners = {os.path.basename(g.path) for g in guards}
    assert {"server.py", "window.py", "cache.py", "metrics.py",
            "profile.py"} <= owners, owners
