"""full_eval orchestration: per-scene train -> render -> metrics
(counterpart of f3d_gaus_tpu/full_eval.py, and of the reference's
src/gaussian-splatting/full_eval.py + render.py + metrics.py).  For each
scene directory it

  1. loads the COLMAP / Blender scene (pipeline/scene_io.py),
  2. splits train/test with the llffhold-every-8th convention
     (dataset_readers.py:145: `eval` holds every 8th image),
  3. fits a per-scene GOF model (train/per_scene.py),
  4. renders the test (and optionally train) split to renders/<name>.png
     next to gt/<name>.png   (render.py's render_set layout),
  5. runs PSNR/SSIM (and LPIPS, given `lpips_weights`) over the pairs
     (eval.py / metrics.py:36-97),

and writes per-split and per-scene results.json plus full_eval.json, the
aggregate.  Runs on the card unless `device` (`--device`) says otherwise:

    python -m f3d_gaus_torch.full_eval --scenes <dir1> <dir2> --output out/
        [--iterations N] [--fixed_caps] [--device cpu]

The renderer's caps are planned from the scene by default (per_scene.
fit_scene(caps="plan"): at init, every densification_interval steps and
for the renders of each split); `--fixed_caps` keeps the config's, the
JAX package's behaviour, which truncates renders at 800^2.  Truncated
training steps and renders are counted in the summary (`overflow_steps`,
`overflow_<split>_renders`), where the JAX package scores them silently.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import eval as eval_mod
from .core.device import resolve_device
from .pipeline import scene_io
from .train import per_scene


def _detect_and_load(scene_dir: str, n_init_points: int = 100_000):
    if os.path.isdir(os.path.join(scene_dir, "sparse")):
        return scene_io.read_colmap_scene(scene_dir, load_images=True)
    if os.path.exists(os.path.join(scene_dir, "transforms_train.json")):
        return scene_io.read_blender_scene(scene_dir, load_images=True,
                                           n_init_points=n_init_points)
    raise FileNotFoundError(
        f"{scene_dir}: neither a COLMAP (sparse/0) nor a Blender "
        "(transforms_train.json) scene")


def _split(cameras, eval_split: bool, llffhold: int = 8):
    """Every llffhold-th camera is test (dataset_readers.py:145)."""
    if not eval_split:
        return cameras, []
    train = [c for i, c in enumerate(cameras) if i % llffhold != 0]
    test = [c for i, c in enumerate(cameras) if i % llffhold == 0]
    return train, test


def _save_png(path: str, img_chw: np.ndarray):
    from PIL import Image
    arr = (np.clip(np.transpose(img_chw, (1, 2, 0)), 0, 1) * 255
           ).astype(np.uint8)
    Image.fromarray(arr).save(path)


def run_scene(scene_dir: str, out_dir: str,
              cfg: per_scene.PerSceneConfig | None = None,
              eval_split: bool = True, llffhold: int = 8,
              render_train: bool = False, seed: int = 0,
              lpips_weights: str | None = None,
              n_init_points: int = 100_000, device=None,
              caps: str = "plan") -> dict:
    """Train + render + metric one scene on `device` (default `cuda`),
    with the caps planned (`caps="plan"`) or the config's ("fixed").
    Returns the summary dict: `overflow_steps` counts the training steps
    whose render the caps truncated, `overflow_<split>_renders` the
    truncated renders of each split, `plan_s` the planning's seconds;
    with `lpips_weights` (a torchvision vgg16 .pt) `<split>_lpips` too."""
    dev = resolve_device(device)
    data = _detect_and_load(scene_dir, n_init_points)
    train_cams, test_cams = _split(data.cameras, eval_split, llffhold)
    if not test_cams:
        test_cams = train_cams[:1]
    cfg = cfg or per_scene.PerSceneConfig()

    targets = np.stack([np.transpose(c.image, (2, 0, 1))
                        for c in train_cams])
    scene, hist = per_scene.fit_scene(
        [c.camera for c in train_cams], targets, data.points, data.colors,
        cfg, extent=data.extent, seed=seed, device=dev, caps=caps)

    os.makedirs(out_dir, exist_ok=True)
    sets = {"test": test_cams}
    if render_train:
        sets["train"] = train_cams
    results, truncated, plan_s = {}, {}, hist["plan_s"]
    bg = torch.zeros(3, device=dev)
    for split, cams in sets.items():
        rdir = os.path.join(out_dir, split, "renders")
        gdir = os.path.join(out_dir, split, "gt")
        os.makedirs(rdir, exist_ok=True)
        os.makedirs(gdir, exist_ok=True)
        render_cfg = cfg
        if caps == "plan":
            t0 = time.perf_counter()
            render_cfg = cfg._replace(**per_scene.plan_caps(
                per_scene.needed_caps(scene, [sc.camera for sc in cams],
                                      cfg), cfg))
            plan_s += time.perf_counter() - t0
        truncated[split] = 0
        for sc in cams:
            with torch.no_grad():
                out = per_scene.render_scene(scene, sc.camera, render_cfg,
                                             bg, cfg.sh_degree)
            truncated[split] += int(out["overflow"])
            name = os.path.splitext(sc.name)[0] + ".png"
            _save_png(os.path.join(rdir, name), out["render"].cpu().numpy())
            _save_png(os.path.join(gdir, name),
                      np.transpose(sc.image, (2, 0, 1)))
        results[split] = eval_mod.evaluate_dirs(
            rdir, gdir, out_json=os.path.join(out_dir, split, "results.json"),
            lpips=bool(lpips_weights), lpips_weights=lpips_weights,
            device=dev)
    summary = {
        "scene": scene_dir,
        "iterations": cfg.iterations,
        "final_gaussians": int(scene.alive.sum()),
        "overflow_steps": hist["overflow_steps"],
        **{f"overflow_{s}_renders": n for s, n in truncated.items()},
        "plan_s": plan_s,
        **{f"{s}_{k}": v for s, r in results.items()
           for k, v in r["mean"].items()},
    }
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump({"summary": summary, "splits": results}, f, indent=2)
    return summary


def full_eval(scene_dirs, output_root: str,
              cfg: per_scene.PerSceneConfig | None = None,
              eval_split: bool = True, render_train: bool = False,
              lpips_weights: str | None = None,
              n_init_points: int = 100_000, device=None,
              caps: str = "plan") -> dict:
    """Orchestrate every scene and aggregate (full_eval.py semantics), on
    `device` (default `cuda`), the caps as run_scene's."""
    dev = resolve_device(device)
    summaries = []
    for sd in scene_dirs:
        name = os.path.basename(os.path.normpath(sd))
        summaries.append(run_scene(
            sd, os.path.join(output_root, name), cfg=cfg,
            eval_split=eval_split, render_train=render_train,
            lpips_weights=lpips_weights, n_init_points=n_init_points,
            device=dev, caps=caps))
        print(json.dumps(summaries[-1]))
    keys = [k for k in summaries[0] if k.endswith(("psnr", "ssim", "lpips"))]
    agg = {"scenes": summaries,
           "mean": {k: float(np.mean([s[k] for s in summaries if k in s]))
                    for k in keys}}
    os.makedirs(output_root, exist_ok=True)
    with open(os.path.join(output_root, "full_eval.json"), "w") as f:
        json.dump(agg, f, indent=2)
    return agg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenes", nargs="+", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--no_eval_split", action="store_true",
                    help="train on all views, test on the first")
    ap.add_argument("--render_train", action="store_true")
    ap.add_argument("--lpips_weights", default=None,
                    help="torchvision vgg16 state_dict .pt enabling LPIPS")
    ap.add_argument("--fixed_caps", action="store_true",
                    help="render at PerSceneConfig's caps (the JAX "
                         "package's; they truncate renders at 800x800) "
                         "instead of planning them from the scene")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    cfg = per_scene.PerSceneConfig()
    if args.iterations:
        cfg = cfg._replace(iterations=args.iterations)
    agg = full_eval(args.scenes, args.output, cfg=cfg,
                    eval_split=not args.no_eval_split,
                    render_train=args.render_train,
                    lpips_weights=args.lpips_weights, device=args.device,
                    caps="fixed" if args.fixed_caps else "plan")
    print(json.dumps(agg["mean"]))


if __name__ == "__main__":
    main()
