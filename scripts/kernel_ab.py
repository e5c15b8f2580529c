#!/usr/bin/env python3
"""This checkout's compositing kernels and field query against another
checkout's, on one card, in turns.

    python3 scripts/kernel_ab.py --old DIR [--seed 0] [--iters 20] [--out DIR]
                                 [--mesh_dir DIR] [--field_only]
                                 [--slice_sweep 64,128,...,whole]

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

The field query (cuda_raster.integrate, whose arguments every slice has
kept) is compared on the mesh run's frontal view: --mesh_dir is a CLI
mesh run's output of one image (default chip_smoke.py's, build/
mesh_smoke/out/00_00, so run the smoke first), read back as chip_smoke.py's
integrate_timing reads it, at that run's caps.  Old, new, new, old, how
far the two fields lie apart (and each from the plain version), and the
opcode counts of the field kernels.  --slice_sweep times this checkout's
field query on the same view at each window-slice length given (`whole`:
the run's max_per_tile, so that no window is split), in the order given
and then in reverse, with each length's item and partial-product counts
(integrate._integrate_items) and how far its field lies from the default
length's.  --field_only skips the compositing shapes.  Prints one JSON
line per shape, then the card's name and power limit.
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
    from f3d_gaus_torch.ops import rasterize as R

    s = inp.statics
    feat, extra, slab, _, g = S.bwd_inputs(inp, seed)
    # a checkout's kernels return the side outputs as a tuple or a RenderAux
    new_out, new_aux = new.composite_fwd(feat, *slab, s)
    old_out, old_aux = old.composite_fwd(feat, *slab, s)
    new_aux, old_aux = R.RenderAux(*new_aux), R.RenderAux(*old_aux)
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


def field_view(mesh_dir, dev):
    """The mesh run's frontal view as the field query takes it: (its caps,
    the slab, the query rays, the statics, the wrapper's arguments)."""
    import chip_smoke as S
    from f3d_gaus_torch.ops import integrate as TI

    with open(os.path.join(mesh_dir, "mesh_stats.json")) as f:
        stats = json.load(f)
    pair_cap, mpt = stats["pair_cap"], stats["max_per_tile"]
    cfg, gauss, _, cam, tp = S.frontal_field_view(mesh_dir, 128, dev)
    s = TI._statics(cam, mpt, cfg.chunk, 1 << 14)
    pre, bng, trunc = TI._prepare_view(gauss, cam, cfg.max_sh_degree, 0.0,
                                       pair_cap, mpt)
    S.require(not bool(trunc), "the view's binning is truncated")
    q = TI.query_rays(tp, cam, s)
    slab = (pre.v2g_mb, pre.opa_coef, bng.point_list, bng.tile_start,
            bng.tile_count)
    kargs = (*slab, q.u, q.v, q.depth, q.tile, q.inside, mpt)
    return {"pair_cap": pair_cap, "max_per_tile": mpt}, slab, q, s, kargs


def compare_field(mesh_dir, old, iters, dev):
    """The field query, old against new, on the mesh run's frontal view."""
    import torch
    import chip_smoke as S
    from f3d_gaus_torch.ops import cuda_raster as new
    from f3d_gaus_torch.ops import integrate as TI

    caps, slab, q, s, kargs = field_view(mesh_dir, dev)
    k_new, k_old = new.integrate(*kargs), old.integrate(*kargs)
    plain = TI._alpha_impl(*slab, q, s)
    diff = (k_new - k_old).abs()
    return {"phase": "kernel_ab", "shape": "field_frontal",
            "P": int(slab[0].shape[0]), "seed_points": int(q.u.shape[0]),
            "caps": caps,
            "bitwise_equal": bool(torch.equal(k_new, k_old)),
            "max_abs_diff": float(diff.max()),
            "points_differing": int((diff > 0).sum()),
            "new_vs_plain": S.field_agreement(k_new, plain),
            "old_vs_plain": S.field_agreement(k_old, plain),
            "field": in_turns(lambda: old.integrate(*kargs),
                              lambda: new.integrate(*kargs), iters)}


def slice_sweep(mesh_dir, lengths, iters, dev):
    """This checkout's field query on the mesh run's frontal view at each
    window-slice length, in the order given and then in reverse."""
    import torch
    import chip_smoke as S
    from f3d_gaus_torch.ops import cuda_raster
    from f3d_gaus_torch.ops import integrate as TI

    caps, slab, q, s, kargs = field_view(mesh_dir, dev)
    mpt = caps["max_per_tile"]
    lengths = [mpt if L == "whole" else int(L) for L in lengths]
    ref = cuda_raster.integrate(*kargs)
    res = {L: {"ms": []} for L in lengths}
    for L in lengths + lengths[::-1]:
        res[L]["ms"].append(S.time_ms(
            lambda: cuda_raster.integrate(*kargs, slice_len=L), iters))
    for L in lengths:
        plan = TI._integrate_items(q.tile, q.inside, q.u, q.v, slab[4], mpt,
                                   L)
        blocks = -(-(plan.seg_start[1:] - plan.seg_start[:-1])
                   // TI.POINTS_PER_ITEM)
        n_slices = ((plan.item_start[1:] - plan.item_start[:-1])
                    // torch.clamp_min(blocks, 1))
        res[L].update(
            items=int(plan.item_start[-1]), parts=int(plan.part_start[-1]),
            part_bytes_allocated=4 * TI.plan_bounds(
                q.u.shape[0], slab[3].shape[0], mpt, L)[1],
            split_tiles=int((n_slices > 1).sum()),
            max_abs_diff_from_default=float(
                (cuda_raster.integrate(*kargs, slice_len=L) - ref).abs()
                .max()))
    return {"phase": "kernel_ab", "shape": "field_slice_sweep",
            "caps": caps, "default_slice_len": TI.SLICE_LEN,
            "max_slices": TI.MAX_SLICES,
            "by_slice_len": {str(L): v for L, v in res.items()}}


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
    ap.add_argument("--mesh_dir", default=os.path.join(
        ROOT, "build", "mesh_smoke", "out", "00_00"))
    ap.add_argument("--field_only", action="store_true")
    ap.add_argument("--slice_sweep", default=None,
                    help="comma-separated slice lengths, or `whole`")
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
    print(json.dumps({"phase": "sass_integrate", **{
        tag: sass[f"{tag}_integrate"] for tag in ("old", "new")}}),
        flush=True)

    def report(line):
        line["card"] = card
        print(json.dumps(line), flush=True)
        with open(os.path.join(args.out, "kernel_ab.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")

    report(compare_field(args.mesh_dir, old, args.iters, dev))
    if args.slice_sweep:
        report(slice_sweep(args.mesh_dir, args.slice_sweep.split(","),
                           args.iters, dev))
    if args.field_only:
        print(card, flush=True)
        return 0

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
        report(compare_shape(name, inp, old, args.iters, args.seed))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
