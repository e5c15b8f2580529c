"""The benchmark's tests run on the CPU (torch on one thread); a test that
needs the card is marked `cuda` and skips inside itself without one."""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(Path(__file__).resolve().parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
torch.set_num_threads(1)
