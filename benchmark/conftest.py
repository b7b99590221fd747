"""Pytest settings of the benchmark's own tests (``pytest benchmark``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
