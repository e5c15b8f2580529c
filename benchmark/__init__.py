"""The benchmark of f3d_gaus_torch (the PyTorch and CUDA port) on one card.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line.  Everything a cell needs is found by name: its configuration under
`configs/`, its traffic mix under `traffic/` (which names the traffic loop
under `loops/`), its correctness limits under `workloads/`, and each
per-layer metric's reader under `metrics/`.  `reference/` is the plain
PyTorch yardstick the comparison that decides `correct` runs; it imports
nothing of the program.
"""
