"""The harness's CPU tests. They import the harness from the checkout's
root and never JAX: run them as `python -m pytest portbench/tests`."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
