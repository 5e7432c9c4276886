"""Registers the marker of tests that need a CUDA device."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips inside the test without "
                   "one); run on the card with `pytest -m gpu tests/`")
