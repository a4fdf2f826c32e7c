"""The benchmark's own tests: its spec, its work counts and its references
on the CPU at small sizes. The benchmark's directory and the repository's
root go on the import path, as ``benchmark/run.py`` puts them."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for path in (str(BENCH.parent), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)
