"""The benchmark's CPU tests: run from the repository's root with
``python -m pytest h100bench/tests``."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
