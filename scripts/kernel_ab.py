#!/usr/bin/env python3
"""This checkout's compositing kernels against another checkout's, on one
card, in turns.

    python3 scripts/kernel_ab.py --old DIR [--seed 0] [--iters 20] [--out DIR]

DIR is the root of another checkout of the repo, for example
`git archive <commit> | tar -x -C build/old`.  Its f3d_gaus_torch is
imported under another name and its own loader builds its kernels (into
DIR/build/kernels/); both sides are launched through their wrappers
cuda_raster.composite_fwd and composite_bwd, whose arguments every slice of
the port has kept.  The inputs are chip_smoke.py's at two shapes of the
main path: the NVS render of the serving path at its final caps
(run_nvs_replanned with 2 orbit views; the merged cloud does not depend on
their number) and the canonical render of the training step at the EDM
init.  Each shape runs old, new, new, old, each a CUDA-event mean over
--iters launches (chip_smoke.time_ms), says whether the two forwards agree
bit for bit and how far the two backwards lie apart on the same residuals
(chip_smoke.grad_agreement).  It also counts the SASS instructions of each
kernel by opcode (cuobjdump -sass) and writes the listings to --out.
Prints one JSON line per shape, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def other_cuda_raster(root, name="f3d_gaus_torch_old"):
    """The cuda_raster module of the checkout at `root`, its package
    imported as `name` so that it does not shadow this checkout's."""
    pkg = os.path.join(root, "f3d_gaus_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[name])
    return importlib.import_module(name + ".ops.cuda_raster")


def in_turns(old, new, iters):
    """old, new, new, old: CUDA-event means over `iters` launches each."""
    import chip_smoke as S
    res = collections.defaultdict(list)
    for name, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
        res[f"{name}_ms"].append(S.time_ms(fn, iters))
    return dict(res)


def compare_shape(name, inp, old, iters, seed):
    import torch
    import chip_smoke as S
    from f3d_gaus_torch.ops import cuda_raster as new

    s = inp.statics
    feat, extra, slab, _, g = S.bwd_inputs(inp, seed)
    new_out, new_aux = new.composite_fwd(feat, *slab, s)
    old_out, old_aux = old.composite_fwd(feat, *slab, s)
    res = {"phase": "kernel_ab", "shape": name, "P": int(feat.shape[0]),
           "max_per_tile": s.max_per_tile,
           "fwd_bitwise_equal": bool(
               torch.equal(new_out, old_out)
               and all(map(torch.equal, new_aux, old_aux))),
           "fwd_max_abs_diff": float((new_out - old_out).abs().max()),
           "fwd_pos_equal": bool(
               torch.equal(new_aux.last_pos, old_aux.last_pos)
               and torch.equal(new_aux.max_pos, old_aux.max_pos)),
           "fwd": in_turns(lambda: old.composite_fwd(feat, *slab, s),
                           lambda: new.composite_fwd(feat, *slab, s), iters)}
    # both backwards on the old forward's residuals
    args = (feat, extra, *slab, old_aux, g, s)
    res["bwd_agreement"], _ = S.grad_agreement(new.composite_bwd(*args),
                                               old.composite_bwd(*args))
    res["bwd"] = in_turns(lambda: old.composite_bwd(*args),
                          lambda: new.composite_bwd(*args), iters)
    return res


def sass_counts(so, out_dir, tag):
    """Instruction counts by opcode of each kernel in a shared library."""
    from f3d_gaus_torch.ops import cuda_raster
    tool = os.path.join(os.path.dirname(cuda_raster._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    with open(os.path.join(out_dir, f"{tag}.sass"), "w") as f:
        f.write(text)
    counts, fn = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)(?:\.(\S+?))?\s", ln)
        if fn and m:
            counts[fn][m.group(1)] += 1
    return {k: dict(v.most_common()) for k, v in counts.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "kernel_ab"))
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab.py: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as S
    from f3d_gaus_torch.core.cameras import Camera
    from f3d_gaus_torch.models import predictor as Pm
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.pipeline import config as C
    from f3d_gaus_torch.pipeline import cycle
    from f3d_gaus_torch.pipeline import dataset as D
    from f3d_gaus_torch.train import feedforward as F

    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    card = S.card_line()
    old = other_cuda_raster(os.path.abspath(args.old))
    sass = {}
    for tag, mod in (("new", cuda_raster), ("old", old)):
        libs = mod.load(rebuild=True)
        print(json.dumps({"phase": f"build_{tag}", "ptxas": [
            ln.strip() for ln in mod.build_log.splitlines()
            if "registers" in ln or "spill" in ln or ln.startswith("[")]}),
            flush=True)
        for name, lib in libs.items():
            sass[f"{tag}_{name}"] = sass_counts(lib._name, args.out,
                                                f"{tag}_{name}")
    with open(os.path.join(args.out, "sass_counts.json"), "w") as f:
        json.dump(sass, f)

    # the NVS render at the serving path's final caps
    cfg = dataclasses.replace(C.PipelineConfig(), num_nvs_views=2)
    model = Pm.GaussianPredictor(cfg.predictor_config(),
                                 torch.Generator().manual_seed(args.seed))
    images, depth = S.smooth_rgbd(np.random.default_rng(args.seed),
                                  cfg.resolution)
    cams = D.canonical_cameras(cfg)
    res = cycle.run_nvs_replanned(model, cfg, cams, images, depth, device=dev,
                                  log=lambda *_: None)
    fcfg = res.cfg
    ncs = cycle.nvs_cameras(fcfg, cams.inverse_first_camera)
    nvs_cam = Camera(ncs.world_view[0], ncs.full_proj[0], ncs.cam_centers[0],
                     fcfg.resolution, fcfg.resolution, fcfg.tan_fov,
                     fcfg.tan_fov)
    nvs = S.prepared(res.merged, nvs_cam, fcfg)
    del res
    # the canonical training render at the EDM init, caps doubled until
    # nothing overflows
    tcfg = C.PipelineConfig()
    pack = F.make_cameras_pack(tcfg, cams, n_banks=1, views_per_bank=1)
    img, dep = S.smooth_rgbd(np.random.default_rng(args.seed + 1),
                             tcfg.resolution)
    target = torch.from_numpy(img).to(dev).permute(0, 3, 1, 2)
    with torch.no_grad():
        g = F._predict(model.to(dev), target, torch.ones_like(target[:, :1]),
                       torch.from_numpy(dep).to(dev), pack.cano_v2w,
                       pack.cano_quat)
    cano_cam = Camera(pack.cano_wv, pack.cano_fp, pack.cano_cc,
                      tcfg.resolution, tcfg.resolution, tcfg.tan_fov,
                      tcfg.tan_fov)
    while True:
        cano = S.prepared(g, cano_cam, tcfg)
        b = cano.binning
        if not (bool(b.overflow)
                or int(b.tile_count.max()) > tcfg.max_per_tile):
            break
        tcfg = dataclasses.replace(tcfg, pair_cap=tcfg.pair_cap * 2,
                                   max_per_tile=tcfg.max_per_tile * 2)
    del model
    for name, inp in (("nvs", nvs), ("canonical", cano)):
        line = compare_shape(name, inp, old, args.iters, args.seed)
        line["card"] = card
        print(json.dumps(line), flush=True)
        with open(os.path.join(args.out, "kernel_ab.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
