"""The benchmark's own CPU tests: the checkout's root on the import path, and
few CPU threads (the port's eager calls at B = 4 are small)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

torch.set_num_threads(2)
