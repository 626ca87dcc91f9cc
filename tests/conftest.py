"""Shared fixtures: a small synthetic census + points with ground truth.

Also provides two markers the concurrency battery relies on:

* ``@pytest.mark.load`` — sustained-load / soak tests, excluded from the
  default (tier-1) run; opt in with ``--run-load``.
* ``@pytest.mark.timeout(seconds)`` — per-test wall-clock deadline so a
  deadlocked threaded test fails fast instead of hanging the whole
  suite.  Implemented in-tree (the pytest-timeout plugin is not in the
  image): the test body runs on a daemon worker thread and the hook
  fails the test if it does not finish in time.  Only apply it to tests
  whose fixtures/teardown tolerate the test thread being abandoned —
  the serving tests do (daemon threads, in-process state only).

``REPRO_LOCKCHECK=1`` turns on the runtime lock-order detector
(repro.analysis.lockcheck, DESIGN.md §17): the serving/analytics locks
are wrapped once per session, and after every test the hook asserts
(a) no write to a ``# guarded-by:`` field was observed without its lock
held and (b) the accumulated acquisition-order graph is acyclic.

NOTE: device count must stay 1 here (the multi-pod dry-run sets
XLA_FLAGS=--xla_force_host_platform_device_count=512 in its own process).
Sharding tests spawn subprocesses with their own XLA_FLAGS.
"""
import os
import threading

import numpy as np
import pytest

from repro.core.synth import build_synth_census

LOCKCHECK = os.environ.get("REPRO_LOCKCHECK") == "1"

if LOCKCHECK:
    from repro.analysis import lockcheck

    @pytest.fixture(autouse=True)
    def _lockcheck_guard():
        """Per-test lockcheck verdict: violations recorded during this
        test (plus any cycle in the session-wide acquisition graph)
        fail it.  Install is idempotent — first test pays it."""
        lockcheck.install()
        seen = len(lockcheck.registry.violations)
        yield
        fresh = lockcheck.registry.violations[seen:]
        cycle = lockcheck.registry.find_cycle()
        if fresh or cycle:
            lines = list(fresh)
            if cycle:
                lines.append(
                    f"lock acquisition-order cycle: {' -> '.join(cycle)}")
            pytest.fail("lockcheck: " + "; ".join(lines), pytrace=False)


def pytest_addoption(parser):
    parser.addoption("--run-load", action="store_true", default=False,
                     help="run @pytest.mark.load sustained-load tests")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "load: sustained-load test, skipped unless --run-load")
    config.addinivalue_line(
        "markers", "timeout(seconds): fail the test if its body runs "
                   "longer than this (thread-based, no pytest-timeout)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one "
                   "(chip_smoke.py checks the kernels on the card)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--run-load"):
        return
    skip = pytest.mark.skip(reason="load test: needs --run-load")
    for item in items:
        if "load" in item.keywords:
            item.add_marker(skip)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    marker = item.get_closest_marker("timeout")
    if marker is None:
        yield
        return
    seconds = float(marker.args[0]) if marker.args else 60.0
    outcome = []
    orig = item.runtest

    def run():
        try:
            orig()
            outcome.append(None)
        except BaseException as e:      # noqa: BLE001 — re-raised below
            outcome.append(e)

    # Replace runtest with a thread-joined wrapper; the surrounding
    # pytest machinery (setup/teardown, reporting) stays on the main
    # thread.  A daemon thread left behind on timeout cannot block
    # interpreter exit.

    def runtest_with_deadline():
        t = threading.Thread(target=run, daemon=True,
                             name=f"timeout:{item.name}")
        t.start()
        t.join(seconds)
        if t.is_alive():
            pytest.fail(f"test exceeded {seconds:g}s timeout "
                        f"(likely deadlock)", pytrace=False)
        if outcome and outcome[0] is not None:
            raise outcome[0]

    item.runtest = runtest_with_deadline
    try:
        yield
    finally:
        item.runtest = orig


@pytest.fixture(scope="session")
def synth_small():
    return build_synth_census(seed=0, n_states=8, counties_per_state=4,
                              blocks_per_county=16)


@pytest.fixture(scope="session")
def synth_mid():
    return build_synth_census(seed=1, n_states=16, counties_per_state=8,
                              blocks_per_county=24)


@pytest.fixture(scope="session")
def points_small(synth_small):
    rng = np.random.default_rng(42)
    return synth_small.sample_points(rng, 4096)


@pytest.fixture(scope="session")
def points_mid(synth_mid):
    rng = np.random.default_rng(43)
    return synth_mid.sample_points(rng, 8192)
