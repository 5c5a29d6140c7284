"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the repository.  Tests marked ``card`` need a CUDA device and skip
without one (decided inside the ``card`` fixture, never at import)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")
