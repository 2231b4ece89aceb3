"""The benchmark's own tests (CPU; a test that needs the card skips inside
itself). Run from the repository's root:

    python3 -m pytest benchmark/tests -q
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
