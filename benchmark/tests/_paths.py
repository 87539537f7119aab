"""Puts the benchmark's folder and the repository's root on ``sys.path``,
as ``benchmark/run.py`` does, for the tests of the benchmark."""

import os
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
FOLDER = os.path.dirname(TESTS)
ROOT = os.path.dirname(FOLDER)
for p in (TESTS, ROOT, FOLDER):
    if p not in sys.path:
        sys.path.insert(0, p)
