"""Command-line pipeline: single image -> 3D Gaussians -> NVS frames + mesh
(counterpart of f3d_gaus_tpu/cli.py):

    python -m f3d_gaus_torch.cli --folder images/1 --output_path out \
        [--load_model ckpt.pt] [--skip_mesh] [--aug_mesh] \
        [--mesh_method delaunay|grid] [--num_nvs_views N] [--device cuda]

Outputs per batch element: the NVS orbit as a video (mp4 when an ffmpeg
backend exists, else GIF) plus a depth video, the predicted Gaussian set
as a 3DGS PLY (the cycle-aggregated set under --aug_mesh) and, unless
--skip_mesh, the binary-searched opacity-0.5 mesh
(mesh_binary_search.ply) with its stage seconds and counts
(mesh_stats.json).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def _save_video(frames, path_base):
    """frames: list of (H, W, 3) uint8.  Writes mp4 where imageio has an
    ffmpeg backend, else a GIF with PIL."""
    try:
        import imageio
        imageio.mimwrite(path_base + ".mp4", frames, fps=30)
        return path_base + ".mp4"
    except (ValueError, RuntimeError, ImportError, OSError):
        from PIL import Image
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(path_base + ".gif", save_all=True,
                     append_images=imgs[1:], duration=1000 // 30, loop=0)
        return path_base + ".gif"


def _to_uint8(chw):
    return (np.clip(np.asarray(chw), 0, 1).transpose(1, 2, 0)
            * 255).astype(np.uint8)


def colorize_depth(depth, lo=None, hi=None):
    """Simple perceptual depth colormap ((H, W) -> (H, W, 3) uint8)."""
    d = np.asarray(depth, np.float32)
    lo = np.min(d) if lo is None else lo
    hi = np.max(d) if hi is None else hi
    t = np.clip((d - lo) / max(hi - lo, 1e-12), 0, 1)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None, help="reference-format YAML")
    p.add_argument("--load_model", default=None,
                   help="reference torch .pt predictor checkpoint")
    p.add_argument("--folder", required=True, help="RGB+_depth.png image dir")
    p.add_argument("--output_path", default="log_visuals")
    p.add_argument("--skip_mesh", action="store_true")
    p.add_argument("--aug_mesh", action="store_true",
                   help="mesh from the cycle-aggregated (9x) gaussian set")
    p.add_argument("--mesh_method", default="delaunay",
                   choices=["delaunay", "grid"])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--num_nvs_views", type=int, default=0,
                   help="override the 128-view orbit (e.g. for smoke runs)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch
    from .core.device import resolve_device
    from .io import ply as plyio
    from .mesh import extract as ME
    from .models import predictor as P
    from .pipeline import config as C
    from .pipeline import cycle, dataset as D

    device = resolve_device(args.device)
    cfg = C.from_yaml(args.config) if args.config else C.PipelineConfig()
    if args.num_nvs_views:
        cfg = dataclasses.replace(cfg, num_nvs_views=args.num_nvs_views)
    ds = D.DemoDataset(args.folder, cfg)
    print(f"dataset: {len(ds)} samples from {args.folder}")

    model = P.GaussianPredictor(cfg.predictor_config(),
                                torch.Generator().manual_seed(0))
    if args.load_model:
        from .models import convert
        model.load_state_dict(convert.convert_checkpoint(args.load_model))
        print(f"loaded torch checkpoint {args.load_model}")
    else:
        print("WARNING: no --load_model; using random predictor weights")
    model = model.to(device).eval()

    os.makedirs(args.output_path, exist_ok=True)
    B = args.batch_size
    n_batches = (len(ds) + B - 1) // B
    if args.max_batches:
        n_batches = min(n_batches, args.max_batches)

    for bi in range(n_batches):
        idx = range(bi * B, min((bi + 1) * B, len(ds)))
        batch = ds.batch(idx)
        res = cycle.run_nvs_replanned(
            model, cfg, ds, batch["images"], batch["depth"], device=device,
            log=lambda msg, bi=bi: print(f"[batch {bi}] {msg}"))
        cfg = res.cfg       # keep the caps that fit for the next batch
        rgb = res.renders["render"].cpu().numpy()          # (B, V, 3, H, W)
        depth_r = res.renders["rendered_depth"].cpu().numpy()

        for b in range(rgb.shape[0]):
            tag = f"{bi:02d}_{b:02d}"
            out_dir = os.path.join(args.output_path, tag)
            os.makedirs(out_dir, exist_ok=True)
            frames = [_to_uint8(rgb[b, v]) for v in range(rgb.shape[1])]
            vid = _save_video(frames, os.path.join(out_dir, "nvs"))
            # one color range across the orbit so the depth video doesn't
            # flicker frame-to-frame
            d_lo, d_hi = float(depth_r[b].min()), float(depth_r[b].max())
            dframes = [colorize_depth(depth_r[b, v, 0], d_lo, d_hi)
                       for v in range(depth_r.shape[1])]
            _save_video(dframes, os.path.join(out_dir, "nvs_depth"))
            print(f"[{tag}] wrote {vid} ({len(frames)} views)")

            src = res.merged if args.aug_mesh else res.first
            g = {k: v[b].cpu().numpy() for k, v in src.items()}
            plyio.write_gaussian_ply(
                os.path.join(out_dir, "gaussians.ply"),
                g["xyz"], g["features_dc"], g["features_rest"],
                g["opacity"], g["scaling"], g["rotation"])

            if not args.skip_mesh:
                nvs_cams = cycle.nvs_cameras(cfg, ds.inverse_first_camera)
                gauss = {"xyz": src["xyz"][b], "scaling": src["scaling"][b],
                         "rotation": src["rotation"][b],
                         "opacity": src["opacity"][b],
                         "shs": torch.cat([src["features_dc"][b],
                                           src["features_rest"][b]], 1)}
                camd = {"world_view": nvs_cams.world_view,
                        "full_proj": nvs_cams.full_proj,
                        "cam_centers": nvs_cams.cam_centers}
                timings, counts = {}, {}
                mesh = ME.extract_mesh(
                    gauss, camd, width=cfg.resolution, height=cfg.resolution,
                    tan_fov=cfg.tan_fov, fov_deg=cfg.fov_deg,
                    method=args.mesh_method, pair_cap=cfg.pair_cap,
                    max_per_tile=cfg.max_per_tile, chunk=cfg.chunk,
                    device=device, timings=timings, counts=counts)
                plyio.write_mesh_ply(
                    os.path.join(out_dir, "mesh_binary_search.ply"),
                    mesh.vertices, mesh.faces, mesh.vertex_colors)
                with open(os.path.join(out_dir, "mesh_stats.json"), "w") as f:
                    json.dump({"method": args.mesh_method,
                               "attempts": res.attempts,
                               "pair_cap": cfg.pair_cap,
                               "max_per_tile": cfg.max_per_tile,
                               "counts": counts, "stage_s": timings}, f)
                print(f"[{tag}] mesh: {len(mesh.vertices)} verts, "
                      f"{len(mesh.faces)} faces")
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
