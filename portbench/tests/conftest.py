"""pytest settings of the benchmark's own tests (run from the repository's
root: ``python -m pytest portbench/tests``)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs a CUDA card; skipped where there is none')
