"""Pytest settings of the benchmark's own tests (``bench/test_*.py``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
