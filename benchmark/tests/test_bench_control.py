"""The control of each cell, at the tiny sizes, on the card: the reference
in the next precision below the configuration's, put in the program's
place, must fail at least one of the cell's numbers on every seed (the
full-size readings the limits were set from are in PERF.md).  Skips
without a card; run on the card with

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -q
"""
import json

import pytest
import torch

from benchmark import harness as H
from tiny import tiny_root

CELLS = [w["name"] for w in json.loads(
    (H.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_number(tmp_path, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (TF32 exists only there)")
    cell = H.load_cell(name, tiny_root(tmp_path))
    loop = H.load_loop(cell)
    limits = cell.limits["limits"]
    for seed in (1, 2, 3):
        values = loop.control(cell, seed, "cuda")
        failed = [k for k in limits if k in values
                  and not values[k] <= limits[k]]
        assert failed, (seed, values)
