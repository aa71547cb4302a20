"""The benchmark's CPU tests: the checkout's root and this folder on the path."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parents[1], HERE):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
