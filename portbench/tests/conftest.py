"""Tests of the benchmark's harness. They run on the CPU at small sizes
and import neither JAX nor the repository's test configuration:

    python -m pytest portbench/tests -q -p no:cacheprovider

Cases marked `gpu` need a card and skip without one.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped where there is none")
