"""Driving benchmark/run.py in-process at the tiny sizes on the CPU (the
look for a card skipped), capturing its result line and standard error.
A helper module of the tests, not collected."""
from __future__ import annotations

import contextlib
import io
import json
import time

from benchmark import run as bench_run

from tiny import tiny_root


def run_cell(tmp, cell, seed=2147483999, seconds=1.0, trace=0,
             spec_edit=None, device="cpu", root=None):
    """(exit code, last stdout line as a dict or None, stderr text)."""
    root = root or tiny_root(tmp, spec_edit)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench_run.main(["--workload", cell, "--seed", str(seed),
                             "--seconds", str(seconds), "--trace",
                             str(trace)], root=root, device=device,
                            t_start=time.perf_counter())
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if lines and rc == 0 else None
    return rc, result, err.getvalue()
