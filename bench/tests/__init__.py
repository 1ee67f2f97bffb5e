"""The benchmark's own tests, run on the CPU: ``python -m pytest bench/tests``
from the root of a checkout. The program's package lies under ``src``."""
import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
