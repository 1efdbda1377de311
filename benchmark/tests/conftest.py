"""The benchmark's own tests: they import neither JAX nor the JAX package
(the repository's `tests/conftest.py` does, and is not on this path)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")
