"""The harness's tests run from the repository's root:

    python -m pytest benchmark/tests -q

They put the benchmark's folder and the root on sys.path, as run.py does.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for p in (BENCH, os.path.dirname(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
