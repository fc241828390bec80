"""The benchmark's CPU tests: `python -m pytest benchmark/tests -q`.
A test marked `card` runs only where a CUDA card is (it decides inside
the test) and skips elsewhere with the reason."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")
