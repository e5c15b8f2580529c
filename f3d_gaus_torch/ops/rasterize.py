"""The GOF tile rasterizer, forward half (counterpart of
f3d_gaus_tpu/ops/rasterize.py).

`render` runs preprocess -> binning -> compositing.  Compositing has two
implementations of one function:

  * the hand-written CUDA kernel (ops/cuda_raster.py, csrc/raster_fwd.cu),
    which every render on CUDA tensors goes through;
  * `_composite_fwd_impl`, its plain PyTorch version: the JAX package's
    chunked parallel-compositing formulation (exclusive cumulative
    products for transmittance, the stop rule as a mask), used for CPU
    tensors and as the yardstick the kernel is held against.

Every per-pixel quantity of the GOF ray quadratic is evaluated from 19
per-Gaussian monomial coefficients in the ray d = (u, v, 1) (see the NFEAT
layout note below).  This slice is forward-only: `render` refuses inputs
that require a gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import gaussians as G
from ..core.device import resolve_device
from . import binning as B

NEAR_PLANE = G.NEAR_PLANE
FAR_PLANE = G.FAR_PLANE
ALPHA_EPS = 1.0 / 255.0
STOP_T = 1e-4
BLOCK = 16
PIX = BLOCK * BLOCK
# Feature layout: MONOMIAL-COEFFICIENT form.  Every per-pixel quantity of
# the ray quadratic is a polynomial in d = (u, v, 1):
#   AA  = |M d|^2 = d^T (M^T M) d      — quadratic form, 6 coefficients
#   num = |K d|^2 = d^T (K^T K) d      — quadratic form, 6 coefficients
#   BB  = 2 d . (M^T b)                — linear, 3 coefficients
#   n   = (M^T M) d                    — linear, reuses AA's coefficients
# Rows: qa[6] (A00, 2A01, A11, 2A02, 2A12, A22) | qk[6] (same form of K^T K)
#       | B[3] | rgb[3] | opa[1].
NFEAT = 19
ROW_QA = 0
ROW_QK = 6
ROW_B = 12
ROW_RGB = 15
ROW_OPA = 18


class RasterStatics(NamedTuple):
    """Static configuration of one composite call."""
    width: int
    height: int
    grid_x: int
    grid_y: int
    focal_x: float
    focal_y: float
    max_per_tile: int    # per-tile compositing window K
    chunk: int           # Gaussians per step of the plain version
    lanes: int = 128     # binning slab alignment


class RenderAux(NamedTuple):
    """Per-pixel side outputs, shape (num_tiles, PIX)."""
    final_T: torch.Tensor
    dist1: torch.Tensor
    dist2: torch.Tensor
    raw_distortion: torch.Tensor
    last_pos: torch.Tensor   # int32 window pos of last contributor, -1 = none
    max_pos: torch.Tensor    # int32 window pos of the median-depth contributor


def _tile_rays(s: RasterStatics, device):
    """Per-tile pixel rays: u, v of shape (num_tiles, PIX)."""
    tiles = torch.arange(s.grid_x * s.grid_y, dtype=torch.int32, device=device)
    tx = (tiles % s.grid_x)[:, None]
    ty = (tiles // s.grid_x)[:, None]
    p = torch.arange(PIX, dtype=torch.int32, device=device)
    ix = (p % BLOCK)[None, :]
    iy = (p // BLOCK)[None, :]
    px = (tx * BLOCK + ix).float() + 0.5
    py = (ty * BLOCK + iy).float() + 0.5
    u = (px - s.width / 2.0) / s.focal_x
    v = (py - s.height / 2.0) / s.focal_y
    return u, v


def _quadform6(r0, r1, r2):
    """Monomial coefficients (xx, 2xy, yy, 2xz, 2yz, zz) of d^T (G^T G) d
    where G has rows r0, r1, r2 (each a 3-list of (P,))."""
    def cdot(i, j):
        return r0[i] * r0[j] + r1[i] * r1[j] + r2[i] * r2[j]
    return [cdot(0, 0), 2.0 * cdot(0, 1), cdot(1, 1),
            2.0 * cdot(0, 2), 2.0 * cdot(1, 2), cdot(2, 2)]


def _expand_feature_columns(v2g_mb, rgb, opa):
    """The NFEAT per-Gaussian monomial-coefficient columns as a list of
    (P,) tensors."""
    m = [v2g_mb[:, i] for i in range(9)]          # M row-major
    b0, b1, b2 = v2g_mb[:, 9], v2g_mb[:, 10], v2g_mb[:, 11]
    qa = _quadform6(m[0:3], m[3:6], m[6:9])
    # rows of K = [b]_x M
    k0 = [-b2 * m[3 + j] + b1 * m[6 + j] for j in range(3)]
    k1 = [b2 * m[j] - b0 * m[6 + j] for j in range(3)]
    k2 = [-b1 * m[j] + b0 * m[3 + j] for j in range(3)]
    qk = _quadform6(k0, k1, k2)
    Bv = [m[i] * b0 + m[3 + i] * b1 + m[6 + i] * b2 for i in range(3)]
    return qa + qk + Bv + [rgb[:, 0], rgb[:, 1], rgb[:, 2], opa]


def _chunk_eval(feat_c, u, v):
    """Evaluate one Gaussian chunk against each tile's rays.

    feat_c: (T, C, NFEAT); u, v: (T, PIX).  Returns (T, PIX, C) maps,
    (T, PIX, C, 3) for nn and the pixel-independent (T, 1, C, 3) rgb."""
    def e(i):
        return feat_c[:, None, :, i]                     # (T, 1, C)
    U, V = u[..., None], v[..., None]                    # (T, PIX, 1)
    qa = [e(ROW_QA + i) for i in range(6)]
    qk = [e(ROW_QK + i) for i in range(6)]
    B_ = [e(ROW_B + i) for i in range(3)]
    opa = e(ROW_OPA)

    def quad(q):
        return ((q[0] * U + q[1] * V + q[3]) * U
                + (q[2] * V + q[4]) * V + q[5])
    AA = quad(qa)                                        # |M d|^2
    num = quad(qk)                                       # |b x (M d)|^2
    BB = 2.0 * (B_[0] * U + B_[1] * V + B_[2])           # 2 a.b

    # AA and num are PSD forms; the monomial evaluation can round slightly
    # negative for thin Gaussians, so clamp both (as the JAX package does)
    AA_safe = torch.clamp_min(AA, 1e-12)
    num = torch.clamp_min(num, 0.0)
    t = -BB / (2.0 * AA_safe)
    min_value = num / AA_safe
    Gv = torch.exp(torch.clamp_max(-0.5 * min_value, 0.0))
    alpha_raw = torch.clamp_max(opa * Gv, 0.99)

    # n = (M^T M) d, un-doubling the baked-in off-diagonal 2s
    nx = qa[0] * U + 0.5 * qa[1] * V + 0.5 * qa[3]
    ny = 0.5 * qa[1] * U + qa[2] * V + 0.5 * qa[4]
    nz = 0.5 * qa[3] * U + 0.5 * qa[4] * V + qa[5]
    length = torch.sqrt(nx * nx + ny * ny + nz * nz + 1e-7)
    inv_len = 1.0 / length
    nn = torch.stack([-nx * inv_len, -ny * inv_len, -nz * inv_len], -1)

    t_pos = torch.clamp_min(t, 1e-6)     # m-mapping guard; masked downstream
    m = (FAR_PLANE * t_pos - FAR_PLANE * NEAR_PLANE) / (
        (FAR_PLANE - NEAR_PLANE) * t_pos)
    rgb = feat_c[:, None, :, ROW_RGB:ROW_RGB + 3]       # (T, 1, C, 3)
    return {"alpha_raw": alpha_raw, "G": Gv, "t": t, "m": m, "nn": nn,
            "rgb": rgb}


def _exclusive_cumprod(x, dim):
    incl = torch.cumprod(x, dim=dim)
    ones = torch.ones_like(incl.narrow(dim, 0, 1))
    return torch.cat([ones, incl.narrow(dim, 0, x.shape[dim] - 1)], dim)


def _gather_windows(feat, point_list, tile_start, tile_count, K):
    """Dense per-tile windows: (T, K) valid mask + (T, K, F) features.
    Gathers ride a zero-padded table so the slab's sentinel id P lands on
    an all-zero row (which self-masks in _chunk_eval)."""
    offs = torch.arange(K, dtype=torch.int64, device=feat.device)[None, :]
    idx = tile_start.long()[:, None] + offs
    win_valid = offs < torch.clamp_max(tile_count.long(), K)[:, None]
    idx_c = idx.clamp(0, point_list.shape[0] - 1)
    gids = point_list.long()[idx_c]
    win_valid = win_valid & (gids < feat.shape[0])
    featz = torch.cat([feat, feat.new_zeros((1,) + feat.shape[1:])], 0)
    return win_valid, featz[gids]


def _composite_fwd_impl(feat, point_list, tile_start, tile_count, bg,
                        s: RasterStatics):
    """Plain PyTorch compositing forward: feat (P, NFEAT) monomial table,
    the aligned slab, bg (3,).  Walks each tile's window in chunks of
    s.chunk; returns (out (num_tiles, PIX, 9), aux: RenderAux)."""
    dev, dt = feat.device, feat.dtype
    T_tiles = s.grid_x * s.grid_y
    u, v = _tile_rays(s, dev)
    C = s.chunk
    n_chunks = max(-(-s.max_per_tile // C), 1)
    K = n_chunks * C
    win_valid, wfeat = _gather_windows(feat, point_list, tile_start,
                                       tile_count, K)
    win_valid = win_valid & (torch.arange(K, device=dev) < s.max_per_tile)

    def z(*sh):
        return torch.zeros((T_tiles, PIX) + tuple(sh), dtype=dt, device=dev)
    T_run = torch.ones((T_tiles, PIX), dtype=dt, device=dev)
    stopped = torch.zeros((T_tiles, PIX), dtype=torch.bool, device=dev)
    Crgb, Cnn, Calpha, depth = z(3), z(3), z(), z()
    max_pos = torch.full((T_tiles, PIX), -1, dtype=torch.int32, device=dev)
    last_pos = torch.full((T_tiles, PIX), -1, dtype=torch.int32, device=dev)
    d1, d2, dist = z(), z(), z()
    zero = torch.zeros((), dtype=dt, device=dev)

    for ci in range(n_chunks):
        feat_c = wfeat[:, ci * C:(ci + 1) * C]
        wv_c = win_valid[:, ci * C:(ci + 1) * C]
        ct = _chunk_eval(feat_c, u, v)
        t, m = ct["t"], ct["m"]
        vc = (t > NEAR_PLANE) & (ct["alpha_raw"] >= ALPHA_EPS) & wv_c[:, None, :]
        alpha = torch.where(vc, ct["alpha_raw"], zero)

        om = 1.0 - alpha
        T_before = T_run[..., None] * _exclusive_cumprod(om, -1)
        # CUDA stop: the first valid Gaussian with T(1-a) < 1e-4 halts the
        # pixel and does not contribute; T is monotone along the chunk, so
        # every later valid lane fires its own stop test too
        stop = vc & (T_before * (1.0 - ct["alpha_raw"]) < STOP_T)
        contrib = vc & (~stop) & (~stopped[..., None])
        w = torch.where(contrib, T_before * alpha, zero)

        pos = (ci * C + torch.arange(C, dtype=torch.int32, device=dev))[None, None, :]
        Crgb = Crgb + torch.bmm(w, ct["rgb"][:, 0])
        Cnn = Cnn + torch.einsum('tpc,tpcj->tpj', w, ct["nn"])
        Calpha = Calpha + torch.sum(w, -1)

        # median depth: t of the LAST contributor with T_before > 0.5
        sel = contrib & (T_before > 0.5)
        t_masked = torch.where(sel, t, zero)
        neg1 = torch.full_like(pos, -1).expand_as(sel)
        mpos = torch.amax(torch.where(sel, pos.expand_as(sel), neg1), -1)
        has = mpos >= 0
        onehot = pos == mpos[..., None]
        t_at = torch.sum(torch.where(onehot, t_masked, zero), -1)
        depth = torch.where(has, t_at, depth)
        max_pos = torch.where(has, mpos, max_pos)
        lpos = torch.amax(torch.where(contrib, pos.expand_as(contrib), neg1), -1)
        last_pos = torch.maximum(last_pos, lpos)

        # 2DGS distortion with running accumulators (forward.cu:543-557)
        A_acc = 1.0 - T_before
        mw = m * w
        m2w = m * mw
        d1_excl = d1[..., None] + (torch.cumsum(mw, -1) - mw)
        d2_excl = d2[..., None] + (torch.cumsum(m2w, -1) - m2w)
        err = m * m * A_acc + d2_excl - 2.0 * m * d1_excl
        dist = dist + torch.sum(err * w, -1)
        d1 = d1 + torch.sum(mw, -1)
        d2 = d2 + torch.sum(m2w, -1)

        T_run = T_run * torch.prod(torch.where(contrib, om, 1.0 + zero), -1)
        stopped = stopped | torch.any(stop, -1)

    out = torch.cat([
        Crgb + T_run[..., None] * bg[None, None, :],
        Cnn, depth[..., None], Calpha[..., None],
        (dist / ((1.0 - T_run) ** 2 + 1e-7))[..., None]], -1)
    aux = RenderAux(final_T=T_run, dist1=d1, dist2=d2, raw_distortion=dist,
                    last_pos=last_pos, max_pos=max_pos)
    return out, aux


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _tiles_to_image(x, s: RasterStatics):
    """(num_tiles, PIX, C) -> (C, H, W), cropping tile padding."""
    C = x.shape[-1]
    img = x.reshape(s.grid_y, s.grid_x, BLOCK, BLOCK, C)
    img = img.permute(4, 0, 2, 1, 3).reshape(C, s.grid_y * BLOCK,
                                            s.grid_x * BLOCK)
    return img[:, :s.height, :s.width]


def _as_tensor(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def plan_caps(means3d, scales, quats, opacities, camera, *,
              kernel_size: float = 0.0, scale_modifier: float = 1.0,
              pair_bucket: int = 1 << 16, tile_bucket: int = 128,
              margin: float = 1.25, device=None):
    """Two-phase sizing: measure the exact pair count and the largest
    per-tile occupancy, and return {'pair_cap', 'max_per_tile'} rounded up
    to buckets (x margin), so the render that follows is exact."""
    dev = resolve_device(device, means3d if torch.is_tensor(means3d) else None)
    means3d, scales, quats, opacities = (
        _as_tensor(a, dev) for a in (means3d, scales, quats, opacities))
    with torch.no_grad():
        shs_dummy = torch.zeros((means3d.shape[0], 1, 3), device=dev)
        pre = G.preprocess(means3d, scales, quats, opacities, shs_dummy, 0,
                           camera, kernel_size, scale_modifier)
        total = int(B.count_pairs(pre.means2d, pre.radii, camera.width,
                                  camera.height))
        pair_cap = B.suggest_pair_cap(int(total * margin), pair_bucket)
        bng = B.bin_gaussians(pre.means2d, pre.radii, pre.depths,
                              camera.width, camera.height, pair_cap)
        max_count = int(torch.max(bng.tile_count))
    mpt = max(int(max_count * margin), tile_bucket)
    mpt = ((mpt + tile_bucket - 1) // tile_bucket) * tile_bucket
    return {"pair_cap": pair_cap, "max_per_tile": mpt}


class CompositeInputs(NamedTuple):
    """What compositing consumes: the preprocessed Gaussians (radii masked),
    their colours, the binning, the statics and the background."""
    pre: G.Preprocessed
    rgb: torch.Tensor
    binning: B.Binning
    statics: RasterStatics
    bg: torch.Tensor


def prepare(means3d, scales, quats, opacities, shs, camera, bg=None, *,
            sh_degree: int = 1, kernel_size: float = 0.0,
            scale_modifier: float = 1.0, pair_cap: int = 1 << 18,
            max_per_tile: int = 1024, chunk: int = 128, colors_precomp=None,
            mask=None, device=None) -> CompositeInputs:
    """Preprocess and bin one Gaussian set for one camera (the part of
    `render` before compositing; same arguments)."""
    dev = resolve_device(device, means3d if torch.is_tensor(means3d) else None)
    means3d, scales, quats, opacities, shs = (
        _as_tensor(a, dev) for a in (means3d, scales, quats, opacities, shs))
    pre = G.preprocess(means3d, scales, quats, opacities, shs, sh_degree,
                       camera, kernel_size, scale_modifier)
    if mask is not None:
        # dead slots are culled like frustum-failed Gaussians (no tile pairs)
        pre = pre._replace(radii=torch.where(
            torch.as_tensor(mask, device=dev), pre.radii,
            torch.zeros_like(pre.radii)))
    rgb = pre.rgb if colors_precomp is None else _as_tensor(colors_precomp, dev)

    width, height = camera.width, camera.height
    # window and slab alignment: 256 whenever the window allows it
    lanes = 256 if max_per_tile % 256 == 0 else 128
    pair_cap = ((pair_cap + lanes - 1) // lanes) * lanes
    bng = B.bin_gaussians(pre.means2d, pre.radii, pre.depths, width, height,
                          pair_cap, max_per_tile=max_per_tile, align=lanes)
    statics = RasterStatics(width=width, height=height,
                            grid_x=bng.grid[0], grid_y=bng.grid[1],
                            focal_x=float(camera.focal_x),
                            focal_y=float(camera.focal_y),
                            max_per_tile=max_per_tile, chunk=chunk,
                            lanes=lanes)
    bg = (torch.zeros(3, device=dev) if bg is None
          else _as_tensor(bg, dev).reshape(3).contiguous())
    return CompositeInputs(pre, rgb, bng, statics, bg)


def composite(inp: CompositeInputs, backend: str = "auto"):
    """Composite prepared inputs.  backend 'auto' launches the kernel
    (cuda_raster.composite_fwd) for CUDA tensors and takes the plain
    version for CPU tensors; 'torch' always takes the plain version.
    Returns (out (num_tiles, PIX, 9), RenderAux)."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    from . import cuda_raster
    pre, bng = inp.pre, inp.binning
    feat = cuda_raster._all_features(pre.v2g_mb, inp.rgb, pre.opa_coef)
    args = (feat, bng.point_list, bng.tile_start, bng.tile_count, inp.bg,
            inp.statics)
    if backend == "torch" or feat.device.type == "cpu":
        return _composite_fwd_impl(*args)
    return cuda_raster.composite_fwd(*args)


def render(means3d, scales, quats, opacities, shs, camera, bg=None, *,
           sh_degree: int = 1, kernel_size: float = 0.0,
           scale_modifier: float = 1.0, pair_cap: int = 1 << 18,
           max_per_tile: int = 1024, chunk: int = 128, colors_precomp=None,
           mask=None, backend: str = "auto", device=None):
    """Render one Gaussian set through one camera.

    backend: 'auto' composites CUDA tensors in the hand-written kernel and
    CPU tensors in the plain PyTorch version; 'torch' forces the plain
    version (tests and chip_smoke.py compare the two with it).  The inputs
    may be tensors (their device is used) or arrays, which go to `device`
    (default `cuda`).

    Returns a dict with keys render (3,H,W), rendered_normal (camera space,
    unnormalized), rendered_depth, rendered_alpha, distortion_map, out9,
    radii, aux, binning and overflow (a 0-dim bool tensor: True iff
    pair_cap or max_per_tile was too small and the image is truncated).
    """
    tensors = [means3d, scales, quats, opacities, shs, bg, colors_precomp]
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise NotImplementedError("backward lands with the training slice")
    inp = prepare(means3d, scales, quats, opacities, shs, camera, bg,
                  sh_degree=sh_degree, kernel_size=kernel_size,
                  scale_modifier=scale_modifier, pair_cap=pair_cap,
                  max_per_tile=max_per_tile, chunk=chunk,
                  colors_precomp=colors_precomp, mask=mask, device=device)
    out, aux = composite(inp, backend)
    img = _tiles_to_image(out, inp.statics)
    bng = inp.binning
    overflow = bng.overflow | torch.any(bng.tile_count > max_per_tile)
    return {
        "render": img[0:3],
        "rendered_normal": img[3:6],
        "rendered_depth": img[6:7],
        "rendered_alpha": img[7:8],
        "distortion_map": img[8:9],
        "out9": img,
        "radii": inp.pre.radii,
        "aux": aux,
        "binning": bng,
        "overflow": overflow,
    }
