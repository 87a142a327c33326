"""CPU tests of the benchmark itself; they import ``portbench`` from the
repository root and run the drivers on the CPU at small sizes."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
