"""pytest settings for the benchmark's own tests (pytest benchmark/tests).

Puts the benchmark's directory and the checkout's root on sys.path, and
registers the `chip` marker: a test so marked needs a CUDA device and
decides inside the test whether one is there."""
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(BENCH), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one)")
