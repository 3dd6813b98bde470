"""Registers the repository's pytest marker for tests that need a card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with the CUDA toolkit; skipped without one")
