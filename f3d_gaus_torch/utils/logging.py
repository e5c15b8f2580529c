"""Observability: stdout tee + timestamped lines + scalar logging.

Counterparts of the reference's Logger tee (src/utils.py:445-501) and
safe_state's timestamped stdout (utils/general_utils.py:110-130); scalar
history doubles as the tensorboard-less metrics sink (train.py:156-191) —
dumped as JSONL so external tooling can tail it.  A copy of
f3d_gaus_tpu/utils/logging.py (that package's import chain pulls in JAX).
"""
from __future__ import annotations

import json
import sys
import time


class Tee:
    """Mirror stdout into a file (reference Logger, src/utils.py:445-501)."""

    def __init__(self, path: str, timestamp: bool = False):
        self.file = open(path, "a")
        self.stdout = sys.stdout
        self.timestamp = timestamp
        self._at_line_start = True

    def __enter__(self):
        sys.stdout = self
        return self

    def __exit__(self, *exc):
        sys.stdout = self.stdout
        self.file.close()

    def write(self, text):
        if self.timestamp and text and self._at_line_start:
            stamp = time.strftime("[%d/%m %H:%M:%S] ")
            text = stamp + text
        self._at_line_start = text.endswith("\n")
        self.stdout.write(text)
        self.file.write(text)

    def flush(self):
        self.stdout.flush()
        self.file.flush()


class ScalarLog:
    """Append-only JSONL scalar sink: one {step, name: value, ...} per call."""

    def __init__(self, path: str):
        self.path = path

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
