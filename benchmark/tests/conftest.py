"""The benchmark's own tests: ``python -m pytest benchmark/tests``. Tests
marked ``cuda`` need a card and skip without one (they decide inside the
test)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where "
        "torch.cuda.is_available() is false")
