"""Feed-forward trainer: the UNet predictor and the differentiable renderer
end to end (counterpart of f3d_gaus_tpu/train/feedforward.py).

The training step the reference's config keys describe
(config/imagenetgs_256x256_v1.yaml: bs 7, lr 6e-7; loss weights under
opt.*), with every loss the config names:

  w_rgb / lambda_ssim  photometric reconstruction of the canonical view
  w_depth              rendered depth vs the input (mono) depth
  w_normal             rendered normal vs the depth-derived normal
  w_alpha              coverage (alpha -> 1 on full frames)
  w_tv                 total variation of the rendered depth
  w_distortion         the GOF/2DGS distortion regulariser
  w_warping            the input image warped into a novel view through the
                       novel view's rendered depth, vs the novel render
  w_cycle (yaml w_prop) the novel render fed back through the predictor
                       (detached and clipped) with the canonical input in
                       one N = 2 call, its Gaussians rendered at the
                       canonical camera, vs the input

  w_perceptual         VGG16 feature L1 of the canonical render vs the input
                       (models/vgg.py)
  w_clip               1 - cosine of the CLIP ViT-B/32 embeddings of the
                       clipped canonical render and the input (models/clip.py)

The two towers' weights are files the user supplies (vgg.load_towers,
clip.load_tower); nonzero w_perceptual / w_clip without their tower raise.
The towers are frozen and stay out of the optimizer.

The novel-view difficulty curriculum (yaml start_diff 24 -> final_diff 6,
denominator2 18 over [start_iter, end_iter]) picks, per step, a camera from
banks precomputed on the host and ordered easy -> hard.  Each image
renders three times per step (canonical, novel, cycle), each render
through the compositing kernels forward and backward on the card.

`train_step` takes no `lr`, unlike the JAX function: the learning rate
lives in the state's Adam optimizer (`init_state(lr=)`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import cameras as C
from ..core.device import abs_tie, clip_tie, resolve_device
from ..models import predictor as P
from ..pipeline import renderer
from ..pipeline.config import PipelineConfig
from ..utils import profiling
from . import losses


class LossWeights(NamedTuple):
    """yaml opt.* weights (config/imagenetgs_256x256_v1.yaml:50-113)."""
    w_rgb: float = 1.0
    lambda_ssim: float = 0.2
    w_depth: float = 2.0
    w_normal: float = 0.2
    w_alpha: float = 1.0
    w_tv: float = 0.1
    w_distortion: float = 0.0
    w_warping: float = 10.0
    w_cycle: float = 10.0          # yaml w_prop
    w_perceptual: float = 0.0      # yaml 2; needs towers["vgg"]
    w_clip: float = 0.0            # yaml 0.35; needs towers["clip"]
    warp_alpha_threshold: float = 0.9   # yaml model.threshold


class Curriculum(NamedTuple):
    """Novel-view difficulty schedule (yaml:66-71)."""
    start_diff: float = 24.0
    final_diff: float = 6.0
    denominator2: float = 18.0
    start_iter: int = 0
    end_iter: int = 100000


class CamerasPack(NamedTuple):
    """Host-side camera constants (float32 numpy): the canonical camera
    plus (n_banks, views_per_bank) novel cameras ordered easy -> hard."""
    cano_v2w: np.ndarray
    cano_quat: np.ndarray
    cano_wv: np.ndarray
    cano_fp: np.ndarray
    cano_cc: np.ndarray
    nb_v2w: np.ndarray       # (D, V, 4, 4)
    nb_quat: np.ndarray      # (D, V, 4)
    nb_wv: np.ndarray
    nb_fp: np.ndarray
    nb_cc: np.ndarray        # (D, V, 3)


@dataclasses.dataclass
class TrainState:
    """The predictor, its optimizer and the step count; train_step updates
    all three in place."""
    model: P.GaussianPredictor
    optimizer: torch.optim.Optimizer
    step: int = 0


def select_novel_camera(pack: CamerasPack, step: int, cur: Curriculum):
    """Difficulty-scheduled camera pick: progress through [start_iter,
    end_iter] maps to the bank axis (easy -> hard); the step rotates
    through the bank's views.  Returns (v2w, quat, world_view, full_proj,
    cam_center)."""
    D, V = pack.nb_wv.shape[:2]
    span = max(cur.end_iter - cur.start_iter, 1)
    prog = np.clip(np.float32(step - cur.start_iter) / np.float32(span),
                   0.0, 1.0)
    bank = int(np.round(prog * np.float32(D - 1)))
    view = int(step % V)
    return tuple(a[bank, view] for a in (pack.nb_v2w, pack.nb_quat,
                                         pack.nb_wv, pack.nb_fp, pack.nb_cc))


def make_optimizer(params, lr: float = 6e-7):
    """Adam at the reference's configured LR (yaml:6): optax.adam's rule,
    betas (0.9, 0.999), eps 1e-8 outside the square root."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def init_state(generator: torch.Generator | None, cfg: PipelineConfig,
               lr: float = 6e-7, device=None) -> TrainState:
    """A fresh predictor (EDM init drawn from `generator`) and its Adam
    optimizer on `device`: `cuda` unless the caller asks for the CPU; it
    raises without a card."""
    dev = resolve_device(device)
    model = P.GaussianPredictor(cfg.predictor_config(), generator).to(dev)
    return TrainState(model, make_optimizer(model.parameters(), lr), 0)


def _t(x, device):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _predict(model, images_nchw, alpha, depth, v2w, quat):
    """One predictor call: feat = [rgb | alpha-or-ones] (visualize.py:282)."""
    B = images_nchw.shape[0]
    dev = images_nchw.device
    feat = torch.cat([images_nchw, alpha], 1).permute(0, 2, 3, 1)[:, None]
    return model(feat, _t(v2w, dev).expand(B, 1, 4, 4),
                 _t(quat, dev).expand(B, 1, 4), depth[:, None])


def cycle_predict(model, target, depth, o_render, o_alpha, o_depth,
                  pack: CamerasPack, orbit_v2w, orbit_quat):
    """The cycle feed: the canonical input [target | ones] and the novel
    view's render [clip(o_render, 0, 1) | o_alpha] with its depth, all
    detached, through the predictor in ONE N = 2 call (cross-view
    attention).  target (B, 3, H, W), depth (B, H, W), o_render
    (B, 3, H, W), o_alpha (B, 1, H, W), o_depth (B, H, W).  Returns the
    merged (B, 2P, ...) Gaussians."""
    B = target.shape[0]
    dev = target.device
    feat2 = torch.stack([
        torch.cat([target, torch.ones_like(target[:, :1])], 1),
        torch.cat([o_render.detach().clamp(0.0, 1.0), o_alpha.detach()], 1)],
        1).permute(0, 1, 3, 4, 2)                     # (B, 2, H, W, 4)
    v2w2 = torch.stack([_t(pack.cano_v2w, dev), _t(orbit_v2w, dev)])
    quat2 = torch.stack([_t(pack.cano_quat, dev), _t(orbit_quat, dev)])
    return model(feat2, v2w2.expand(B, 2, 4, 4), quat2.expand(B, 2, 4),
                 torch.stack([depth, o_depth.detach()], 1))


def loss_fn(model, cfg: PipelineConfig, batch, cameras_pack: CamerasPack,
            w: LossWeights = LossWeights(), step: int = 0,
            cur: Curriculum = Curriculum(), towers=None):
    """The full multi-term objective.  batch: images (B, H, W, 3) in
    [0, 1] and depth (B, H, W), tensors or arrays (moved to the model's
    device); step drives the novel-view curriculum; towers: an optional
    dict with 'vgg' (models/vgg.VGG16) and/or 'clip' (models/clip.
    CLIPVisual), frozen, activating w_perceptual / w_clip.  Returns (loss,
    aux): aux holds l1, ssim, psnr, each weighted term as loss_<name>, and
    `overflow`, the (3B,) bool map of the step's renders (canonical and
    novel per image, then the cycle render per image)."""
    towers = towers or {}
    if w.w_perceptual and "vgg" not in towers:
        raise NotImplementedError(
            "w_perceptual needs the VGG16 tower: pass towers={'vgg': "
            "models.vgg.load_towers(path)[0]}")
    if w.w_clip and "clip" not in towers:
        raise NotImplementedError(
            "w_clip needs the CLIP tower: pass towers={'clip': "
            "models.clip.load_tower(path)}")
    for name, tower in towers.items():
        if any(p.requires_grad for p in tower.parameters()):
            raise ValueError(f"the {name} tower must be frozen "
                             f"(requires_grad_(False))")
    dev = next(model.parameters()).device
    images, depth = _t(batch["images"], dev), _t(batch["depth"], dev)
    pack = cameras_pack
    (orbit_v2w, orbit_quat, orbit_wv, orbit_fp,
     orbit_cc) = select_novel_camera(pack, step, cur)
    B = images.shape[0]
    target = images.permute(0, 3, 1, 2)                      # NCHW

    g = _predict(model, target, torch.ones_like(target[:, :1]), depth,
                 pack.cano_v2w, pack.cano_quat)
    bg = torch.zeros(3, device=dev)
    views = renderer.render_views_batched(
        g, np.stack([pack.cano_wv, orbit_wv]), np.stack([pack.cano_fp, orbit_fp]),
        np.stack([pack.cano_cc, orbit_cc]), bg, cfg)

    recon = views["render"][:, 0]                            # canonical
    r_depth = views["rendered_depth"][:, 0]                  # (B, 1, H, W)
    r_alpha = views["rendered_alpha"][:, 0]
    r_normal = views["rendered_normal"][:, 0]
    d_normal = views["depth_normal"][:, 0]

    terms = {}
    l1 = losses.l1(recon, target)
    ssim_v = losses.ssim(recon, target)
    terms["rgb"] = w.w_rgb * (l1 + w.lambda_ssim * (1.0 - ssim_v))
    cover = r_alpha > 0.5
    terms["depth"] = w.w_depth * losses.masked_l1(r_depth, depth[:, None],
                                                  cover)
    terms["normal"] = w.w_normal * losses.normal_consistency(
        r_normal, d_normal, cover[:, 0])
    terms["alpha"] = w.w_alpha * abs_tie(r_alpha - 1.0).mean()
    terms["tv"] = w.w_tv * losses.tv(r_depth)
    if w.w_perceptual:
        from ..models import vgg
        terms["perceptual"] = w.w_perceptual * vgg.perceptual_loss(
            towers["vgg"], recon, target)
    if w.w_clip:
        from ..models import clip
        terms["clip"] = w.w_clip * clip.clip_loss(
            towers["clip"], clip_tie(recon, 0.0, 1.0), target)
    if w.w_distortion:
        terms["distortion"] = w.w_distortion * abs_tie(
            views["distortion_map"][:, 0]).mean()

    # warping: the input image resampled into the novel view through the
    # novel view's (detached) rendered depth, vs the novel render
    if w.w_warping:
        o_render = views["render"][:, 1]
        o_depth = views["rendered_depth"][:, 1].detach()
        o_alpha = views["rendered_alpha"][:, 1]
        warped, valid = zip(*(losses.warp_from_view(
            target[b], pack.cano_wv, pack.cano_fp, o_depth[b], orbit_wv,
            cfg.resolution, cfg.resolution, cfg.tan_fov, cfg.tan_fov)
            for b in range(B)))
        mask = torch.stack(valid)[:, None] & (o_alpha > w.warp_alpha_threshold)
        terms["warping"] = w.w_warping * losses.masked_l1(
            torch.stack(warped), o_render, mask)

    # cycle: re-predict from the detached, clipped novel render together
    # with the canonical input, and reconstruct the canonical view from
    # the merged 2P Gaussians
    overflow = [views["overflow"].reshape(-1)]
    if w.w_cycle:
        g2 = cycle_predict(model, target, depth, views["render"][:, 1],
                           views["rendered_alpha"][:, 1],
                           views["rendered_depth"][:, 1, 0], pack,
                           orbit_v2w, orbit_quat)
        cyc = renderer.render_views_batched(
            g2, pack.cano_wv[None], pack.cano_fp[None], pack.cano_cc[None],
            bg, cfg)
        terms["cycle"] = w.w_cycle * losses.l1(cyc["render"][:, 0], target)
        overflow.append(cyc["overflow"].reshape(-1))

    loss = sum(terms.values())
    aux = {"l1": l1, "ssim": ssim_v, "psnr": losses.psnr(recon, target).mean(),
           **{f"loss_{k}": v for k, v in terms.items()},
           "overflow": torch.cat(overflow)}
    return loss, aux


@profiling.spanned("step")
def train_step(state: TrainState, cfg: PipelineConfig, batch,
               cameras_pack: CamerasPack, weights: LossWeights = LossWeights(),
               cur: Curriculum = Curriculum(), timings=None, towers=None,
               group=None):
    """One optimizer step, in place: state.model's parameters, the Adam
    moments and state.step advance (the PyTorch idiom; the JAX step
    returns a new state).  Returns (loss, aux) as loss_fn, detached;
    `towers` as loss_fn's.

    `group`: a torch.distributed process group of data-parallel ranks
    (parallel/mesh.py:sharded_train_step), each with its own slice of the
    batch.  The overflow count is then summed over the group before any
    rank decides, so all raise together, and the gradients are averaged
    over it before the update (DistributedDataParallel's semantics,
    written out: the predictor runs twice before one backward, and an
    overflow leaves a forward without its backward, neither of which
    DistributedDataParallel's reducer allows).

    Raises renderer.RenderOverflow, before any backward or update, if a
    render of the step exceeded cfg.pair_cap / cfg.max_per_tile: the
    caller doubles the caps and runs the step again.  `timings`: a dict to
    receive the wall seconds of 'forward', 'backward' and 'optimizer' (the
    device is synchronised after each only when it is given).  While
    tracing is on (utils.profiling) the step is a root span `step` with a
    span per stage."""
    dev = next(state.model.parameters()).device
    clock = profiling.StageClock(dev, timings)
    state.optimizer.zero_grad(set_to_none=True)
    loss, aux = loss_fn(state.model, cfg, batch, cameras_pack, weights,
                        state.step, cur, towers)
    clock.lap("forward")
    counts = torch.stack([aux["overflow"].sum(),
                          torch.tensor(aux["overflow"].numel(), device=dev)])
    if group is not None:
        dist.all_reduce(counts, group=group)
    n_over, n_renders = (int(c) for c in counts)
    if n_over:
        raise renderer.RenderOverflow(
            f"{n_over} of {n_renders} renders exceeded the "
            f"static caps (pair_cap={cfg.pair_cap}, max_per_tile="
            f"{cfg.max_per_tile}); double the caps and run the step again")
    loss.backward()
    if group is not None:
        grads = [p.grad for p in state.model.parameters()
                 if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= dist.get_world_size(group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
    clock.lap("backward")
    state.optimizer.step()
    state.step += 1
    clock.lap("optimizer")
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def bank_angles(cur: Curriculum, bank: int, n_banks: int,
                views_per_bank: int):
    """(yaws, pitches) of one difficulty bank.  Bank i's difficulty
    interpolates start_diff -> final_diff linearly in i/(n_banks-1); the
    yaw amplitude is pi/diff and the pitch amplitude the fixed
    pi/denominator2 (the yaml:66-71 reading of the JAX package)."""
    f = bank / max(n_banks - 1, 1)
    diff = cur.start_diff + (cur.final_diff - cur.start_diff) * f
    ang = 2 * np.pi * np.arange(views_per_bank) / views_per_bank
    yaws = (np.pi / diff * -np.sin(ang)).astype(np.float32)
    pitches = (np.pi / cur.denominator2 * np.cos(ang)).astype(np.float32)
    return yaws, pitches


def make_cameras_pack(cfg: PipelineConfig, dataset,
                      cur: Curriculum = Curriculum(), n_banks: int = 6,
                      views_per_bank: int = 4) -> CamerasPack:
    """Host-side camera constants: the canonical camera of `dataset`
    (anything with camera_set and inverse_first_camera) plus an (n_banks,
    views_per_bank) grid of novel cameras ordered easy -> hard."""
    cano = dataset.camera_set
    rebase = dataset.inverse_first_camera if cfg.update_pose else None
    banks = []
    for i in range(n_banks):
        yaws, pitches = bank_angles(cur, i, n_banks, views_per_bank)
        banks.append(C.build_camera_set(
            yaws, pitches, cfg.radius, cfg.look_at_z, cfg.fov_deg,
            cfg.z_near, cfg.z_far, rebase=rebase))

    def stack(field):
        return np.stack([getattr(b, field) for b in banks])
    return CamerasPack(
        cano.view_to_world[0], cano.cv2wT_quat[0], cano.world_view[0],
        cano.full_proj[0], cano.cam_centers[0],
        stack("view_to_world"), stack("cv2wT_quat"), stack("world_view"),
        stack("full_proj"), stack("cam_centers"))
