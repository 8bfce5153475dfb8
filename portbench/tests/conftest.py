"""The benchmark's own tests: `python -m pytest -q portbench/tests` from
the checkout's root. The `cuda` tests decide inside the test whether a
card is there and skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
