"""A copy of the benchmark's data files at CPU-test sizes: the same
BENCHMARK.json, traffic mixes, limits and readers, with each
configuration shrunk (TINY) and each mix's sizes overridden (TINY_TRAFFIC).
Imported by the tests as a helper module, not collected."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY = {
    "imagenetgs_256": {"pipeline": dict(
        resolution=32, base_dim=32, num_blocks=1, attn_resolutions=[8],
        num_aggregation_views=2, num_nvs_views=3, pair_cap=1 << 14,
        max_per_tile=256)},
    "gof_nerf_synthetic_800": {
        "scene": dict(views=6, resolution=32, init_points=300),
        "per_scene": dict(densify_from_iter=4, densification_interval=5,
                          pair_cap=1 << 14, max_per_tile=512)},
}
TINY_TRAFFIC = {
    "nvs_b1": dict(pool=3, check_views=2),
    "fit": dict(check_steps=2, surgery_at=10, trace_from=2, trace_iters=3),
    "train_b6": dict(batch=2, pool=6, first_steps=3, check_steps=3,
                     trace_step=0),
}


def tiny_root(tmp: Path, spec_edit=None) -> Path:
    """tmp holding BENCHMARK.json and benchmark/ {configs, traffic,
    workloads, metrics} at the tiny sizes; `spec_edit(spec)` may change
    the spec before it is written."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("traffic", "workloads", "metrics"):
        shutil.copytree(BENCH / sub, tmp / "benchmark" / sub)
    (tmp / "benchmark" / "configs").mkdir(parents=True)
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        for section, over in TINY.get(c["name"], {}).items():
            cfg[section] = {**cfg[section], **over}
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for name, over in TINY_TRAFFIC.items():
        path = tmp / "benchmark" / "traffic" / f"{name}.json"
        if path.exists():
            path.write_text(json.dumps({**json.loads(path.read_text()),
                                        **over}))
    if spec_edit is not None:
        spec_edit(spec)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
