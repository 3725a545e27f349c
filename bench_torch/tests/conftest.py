"""The benchmark's own tests (CPU): the harness and the checkout's root on
the import path."""

import sys
from pathlib import Path

_BENCH = Path(__file__).resolve().parents[1]
for path in (str(_BENCH.parent), str(_BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)
