"""Puts the checkout's root on the path, so that ``spmv_bench`` imports
however pytest is started."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
