"""The benchmark's own tests: its harness on the CPU at tiny sizes, and
(marked ``chip``) one full-size run that needs the card."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")
