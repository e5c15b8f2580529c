"""The differentiable GOF tile rasterizer (counterpart of
f3d_gaus_tpu/ops/rasterize.py).

`render` runs preprocess -> binning -> compositing.  `prepare` hands
`composite` the same inputs on every route (CompositeInputs): the (P,
NFEAT) feature table, the (P, 5) conic | means2d table and the radii.  The
preprocess of a render that no gradient flows through (CUDA tensors,
nothing for autograd to record, no colors_precomp) is one launch of
csrc/preprocess.cu (cuda_raster.preprocess), which writes both tables;
every other render composes them, differentiably, in `_preprocess_impl`
(core.gaussians.preprocess and `_all_features`: the kernel's plain
version).  `_kernel_preprocess` is the one place that chooses.
Compositing has two implementations of each direction:

  * the hand-written CUDA kernels (ops/cuda_raster.py), which every render
    on CUDA tensors goes through: the decision pass csrc/gof_decide.cu
    (one bit per slab slot and pixel: t > 0.2, alpha >= 1/255, inside the
    window), then csrc/raster_fwd.cu over the set bits for the forward and
    csrc/raster_bwd.cu for its gradient;
  * `_contrib_mask_impl`, `_composite_fwd_impl` / `_composite_bwd_impl`,
    their plain PyTorch versions: the same packed mask, and the JAX
    package's chunked parallel-compositing formulation (exclusive
    cumulative products for transmittance, the stop rule as a mask; a
    reverse chunk walk with the pull-back through `torch.func.vjp` of
    `_chunk_eval`), used for CPU tensors and as the yardstick the kernels
    are held against.  Given a mask, the compositing versions take its
    bits as the decision; without one they decide themselves.

`composite` is a `torch.autograd.Function` over the (P, NFEAT) feature
table and a (P, 3) densification-stats dummy; its backward keeps the
reference's gradient semantics (pass-through clamps, no gradient on the
alpha channel, detached distortion weights, the depth gradient to the
median contributor only, stats through the conic).  Every per-pixel
quantity of the GOF ray quadratic is evaluated from 19 per-Gaussian
monomial coefficients in the ray d = (u, v, 1) (see the NFEAT layout note
below).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import gaussians as G
from ..core.device import max_tie, resolve_device
from ..utils import profiling
from . import binning as B
from . import cuda_raster

NEAR_PLANE = G.NEAR_PLANE
FAR_PLANE = G.FAR_PLANE
ALPHA_EPS = 1.0 / 255.0
STOP_T = 1e-4
BLOCK = 16
PIX = cuda_raster.PIX
# Feature layout: MONOMIAL-COEFFICIENT form.  Every per-pixel quantity of
# the ray quadratic is a polynomial in d = (u, v, 1):
#   AA  = |M d|^2 = d^T (M^T M) d      — quadratic form, 6 coefficients
#   num = |K d|^2 = d^T (K^T K) d      — quadratic form, 6 coefficients
#   BB  = 2 d . (M^T b)                — linear, 3 coefficients
#   n   = (M^T M) d                    — linear, reuses AA's coefficients
# Rows: qa[6] (A00, 2A01, A11, 2A02, 2A12, A22) | qk[6] (same form of K^T K)
#       | B[3] | rgb[3] | opa[1].  The kernels hard-code it (cuda_raster).
NFEAT = cuda_raster.NFEAT
ROW_QA = cuda_raster.ROW_QA
ROW_QK = cuda_raster.ROW_QK
ROW_B = cuda_raster.ROW_B
ROW_RGB = cuda_raster.ROW_RGB
ROW_OPA = cuda_raster.ROW_OPA
# The decision mask's layout (cuda_raster.MASK_SLOTS)
MASK_SLOTS = cuda_raster.MASK_SLOTS
mask_shape = cuda_raster.mask_shape


def _quadform6(r0, r1, r2):
    """Monomial coefficients (xx, 2xy, yy, 2xz, 2yz, zz) of d^T (G^T G) d
    where G has rows r0, r1, r2 (each a 3-list of (P,))."""
    def cdot(i, j):
        return r0[i] * r0[j] + r1[i] * r1[j] + r2[i] * r2[j]
    return [cdot(0, 0), 2.0 * cdot(0, 1), cdot(1, 1),
            2.0 * cdot(0, 2), 2.0 * cdot(1, 2), cdot(2, 2)]


def _all_features(v2g_mb, rgb, opa):
    """The (P, NFEAT) feature table of the layout above, one row per
    Gaussian, from the (P, 12) M | b packing, the (P, 3) colours and the
    (P,) opacities; differentiable in all three."""
    m = [v2g_mb[:, i] for i in range(9)]          # M row-major
    b0, b1, b2 = v2g_mb[:, 9], v2g_mb[:, 10], v2g_mb[:, 11]
    qa = _quadform6(m[0:3], m[3:6], m[6:9])
    # rows of K = [b]_x M
    k0 = [-b2 * m[3 + j] + b1 * m[6 + j] for j in range(3)]
    k1 = [b2 * m[j] - b0 * m[6 + j] for j in range(3)]
    k2 = [-b1 * m[j] + b0 * m[3 + j] for j in range(3)]
    qk = _quadform6(k0, k1, k2)
    Bv = [m[i] * b0 + m[3 + i] * b1 + m[6 + i] * b2 for i in range(3)]
    return torch.stack(qa + qk + Bv + [rgb[:, 0], rgb[:, 1], rgb[:, 2], opa],
                       1)


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
    # A band of a frame (render(tile_rows=...)): the statics' grid_y tile
    # rows start at global tile row row_off, while width, height and the
    # focals stay the full frame's, whose principal point the rays need.
    row_off: int = 0


class RenderAux(NamedTuple):
    """Per-pixel side outputs, shape (num_tiles, PIX)."""
    final_T: torch.Tensor
    dist1: torch.Tensor
    dist2: torch.Tensor
    raw_distortion: torch.Tensor
    last_pos: torch.Tensor   # int32 window pos of last contributor, -1 = none
    max_pos: torch.Tensor    # int32 window pos of the median-depth contributor


def _tile_rays(s: RasterStatics, device):
    """Per-tile pixel rays: u, v of shape (num_tiles, PIX), the tile rows
    shifted by the band's s.row_off."""
    tiles = torch.arange(s.grid_x * s.grid_y, dtype=torch.int32, device=device)
    tx = (tiles % s.grid_x)[:, None]
    ty = (tiles // s.grid_x)[:, None] + s.row_off
    p = torch.arange(PIX, dtype=torch.int32, device=device)
    ix = (p % BLOCK)[None, :]
    iy = (p // BLOCK)[None, :]
    px = (tx * BLOCK + ix).float() + 0.5
    py = (ty * BLOCK + iy).float() + 0.5
    u = (px - s.width / 2.0) / s.focal_x
    v = (py - s.height / 2.0) / s.focal_y
    return u, v


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
    # negative for thin Gaussians, so clamp both (as the JAX package does,
    # with jnp.maximum's half gradient at the tie: num is exactly 0 on a
    # Gaussian's own pixel ray often)
    AA_safe = max_tie(AA, 1e-12)
    num = max_tie(num, 0.0)
    t = -BB / (2.0 * AA_safe)
    min_value = num / AA_safe
    # pass-through clamps (the CUDA reference keeps the full gradient
    # through min(), backward.cu:912)
    Gv = torch.exp(_passthrough_min(-0.5 * min_value, 0.0))
    alpha_raw = _passthrough_min(opa * Gv, 0.99)

    # n = (M^T M) d, un-doubling the baked-in off-diagonal 2s
    nx = qa[0] * U + 0.5 * qa[1] * V + 0.5 * qa[3]
    ny = 0.5 * qa[1] * U + qa[2] * V + 0.5 * qa[4]
    nz = 0.5 * qa[3] * U + 0.5 * qa[4] * V + qa[5]
    length = torch.sqrt(nx * nx + ny * ny + nz * nz + 1e-7)
    inv_len = 1.0 / length
    nn = torch.stack([-nx * inv_len, -ny * inv_len, -nz * inv_len], -1)

    t_pos = max_tie(t, 1e-6)     # m-mapping guard; masked downstream
    m = (FAR_PLANE * t_pos - FAR_PLANE * NEAR_PLANE) / (
        (FAR_PLANE - NEAR_PLANE) * t_pos)
    rgb = feat_c[:, None, :, ROW_RGB:ROW_RGB + 3]       # (T, 1, C, 3)
    return {"alpha_raw": alpha_raw, "G": Gv, "t": t, "m": m, "nn": nn,
            "rgb": rgb}


def _passthrough_min(x, cap):
    """min(x, cap) in value, identity in gradient (CUDA clamp semantics)."""
    return x + (torch.clamp_max(x, cap) - x).detach()


def _exclusive_cumprod(x, dim):
    incl = torch.cumprod(x, dim=dim)
    ones = torch.ones_like(incl.narrow(dim, 0, 1))
    return torch.cat([ones, incl.narrow(dim, 0, x.shape[dim] - 1)], dim)


def _gather_windows(feat, point_list, tile_start, tile_count, K):
    """Dense per-tile windows: (T, K) Gaussian ids, valid mask and (T, K, F)
    features.  Gathers ride a zero-padded table so the slab's sentinel id P
    lands on an all-zero row (which self-masks in _chunk_eval)."""
    offs = torch.arange(K, dtype=torch.int64, device=feat.device)[None, :]
    idx = tile_start.long()[:, None] + offs
    win_valid = offs < torch.clamp_max(tile_count.long(), K)[:, None]
    idx_c = idx.clamp(0, point_list.shape[0] - 1)
    gids = point_list.long()[idx_c]
    win_valid = win_valid & (gids < feat.shape[0])
    featz = torch.cat([feat, feat.new_zeros((1,) + feat.shape[1:])], 0)
    return gids, win_valid, featz[gids]


def _windows(feat, point_list, tile_start, tile_count, s: RasterStatics):
    """_gather_windows over s.max_per_tile rounded up to whole chunks, the
    validity cut at max_per_tile: (gids, win_valid, wfeat, chunk count)."""
    n_chunks = max(-(-s.max_per_tile // s.chunk), 1)
    K = n_chunks * s.chunk
    gids, win_valid, wfeat = _gather_windows(feat, point_list, tile_start,
                                             tile_count, K)
    win_valid = win_valid & (torch.arange(K, device=feat.device)
                             < s.max_per_tile)
    return gids, win_valid, wfeat, n_chunks


def _decide(ct, wv_c):
    """The decision of every (pixel, pair) of a chunk from _chunk_eval's
    maps and the chunk's window validity (T, C): (T, PIX, C) bool."""
    return ((ct["t"] > NEAR_PLANE) & (ct["alpha_raw"] >= ALPHA_EPS)
            & wv_c[:, None, :])


def mask_words_used(tile_start, tile_count, s: RasterStatics) -> int:
    """How many leading words of the mask the decision pass writes: those
    of the MASK_SLOTS-slot blocks up to the end of the last tile's window
    (a host sync)."""
    n = min(int(tile_count[-1]), s.max_per_tile)
    end = int(tile_start[-1]) + -(-n // MASK_SLOTS) * MASK_SLOTS
    return end // 32


def _unpack_window_bits(mask, tile_start, pos0, C):
    """The mask's bits at window positions pos0 .. pos0 + C - 1 of every
    tile, as (T, PIX, C) bool.  Positions past a tile's window read other
    words (another tile's, or past the mask: clamped); the caller masks
    them with the window validity."""
    pos = pos0 + torch.arange(C, device=mask.device)
    word = (tile_start.long()[:, None] + pos[None, :]) // 32
    vals = mask[word.clamp_max(mask.shape[0] - 1)].permute(0, 2, 1)
    # contiguous, as _decide's maps are: the layout of a mask decides the
    # summation order of what it selects
    return ((vals >> (pos % 32).int()) & 1).bool().contiguous()


def _pack_window_bits(bits_of_chunk, n_chunks, C, tile_start, tile_count,
                      s: RasterStatics, shape):
    """Packs per-window decisions into the mask layout.  bits_of_chunk(ci)
    gives window positions ci * C .. ci * C + C - 1 as (T, PIX, C) bool;
    the words that hold a window position of their tile are filled, every
    other word of `shape` is 0."""
    dev = tile_start.device
    T = tile_start.shape[0]
    n_words = -(-n_chunks * C // 32)
    words = torch.zeros((T, PIX, n_words), dtype=torch.int64, device=dev)
    for ci in range(n_chunks):
        pos = ci * C + torch.arange(C, device=dev)
        words.index_add_(2, pos // 32,
                         bits_of_chunk(ci).long() << (pos % 32))
    words = torch.where(words > B.INT32_MAX, words - (1 << 32), words)
    n = torch.clamp_max(tile_count.long(), s.max_per_tile)
    w = torch.arange(n_words, device=dev)
    sel = w[None, :] < ((n + 31) // 32)[:, None]                  # (T, W)
    rows = tile_start.long()[:, None] // 32 + w[None, :]
    mask = torch.zeros(shape, dtype=torch.int32, device=dev)
    mask[rows[sel]] = words.permute(0, 2, 1)[sel].to(torch.int32)
    return mask


def _contrib_mask_impl(feat, point_list, tile_start, tile_count,
                       s: RasterStatics):
    """Plain PyTorch decision pass: the (slab / 32, PIX) int32 mask of
    cuda_raster.decide, word for word, from _chunk_eval's t and alpha_raw
    and the window validity (the vc of _composite_fwd_impl).  Words past
    mask_words_used, which the kernel leaves unwritten, are 0."""
    u, v = _tile_rays(s, feat.device)
    _, win_valid, wfeat, n_chunks = _windows(feat, point_list, tile_start,
                                             tile_count, s)
    C = s.chunk

    def bits(ci):
        sl = slice(ci * C, (ci + 1) * C)
        with torch.no_grad():
            return _decide(_chunk_eval(wfeat[:, sl], u, v), win_valid[:, sl])
    return _pack_window_bits(bits, n_chunks, C, tile_start, tile_count, s,
                             mask_shape(point_list))


def _composite_fwd_impl(feat, point_list, tile_start, tile_count, bg,
                        s: RasterStatics, mask=None):
    """Plain PyTorch compositing forward: feat (P, NFEAT) monomial table,
    the aligned slab, bg (3,) and optionally the decision mask
    (_contrib_mask_impl's layout), whose bits then stand for the decision.
    Walks each tile's window in chunks of s.chunk; returns (out (num_tiles,
    PIX, 9), aux: RenderAux)."""
    dev, dt = feat.device, feat.dtype
    T_tiles = s.grid_x * s.grid_y
    u, v = _tile_rays(s, dev)
    C = s.chunk
    _, win_valid, wfeat, n_chunks = _windows(feat, point_list, tile_start,
                                             tile_count, s)

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
        vc = (_decide(ct, wv_c) if mask is None else
              _unpack_window_bits(mask, tile_start, ci * C, C)
              & wv_c[:, None, :])
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


def _composite_bwd_impl(feat, extra, point_list, tile_start, tile_count, bg,
                        aux: RenderAux, g_out, s: RasterStatics, mask=None):
    """Plain PyTorch compositing backward: the reverse chunk walk of the
    CUDA reference (backward.cu:738-953), as the JAX package restates it.

    feat (P, NFEAT) and extra (P, 5) = [conic | means2d] tables, the aligned
    slab, bg (3,), the forward's RenderAux and g_out (num_tiles, PIX, 9),
    the cotangent of out9, and optionally the forward's decision mask
    (_contrib_mask_impl's layout), whose bits then stand for the decision.
    Suffix sums accumulate exactly from zero, T is rebuilt from final_T by
    division, the contributor mask re-uses the forward's last_pos, and the
    chunk cotangents are pulled back through torch.func.vjp of _chunk_eval.
    Returns (d_feat (P, NFEAT), d_stats (P, 3)), the per-Gaussian
    densification statistics |dL/dmean2d| through the conic."""
    P = feat.shape[0]
    dev, dt = feat.device, feat.dtype
    u, v = _tile_rays(s, dev)
    C = s.chunk
    gids, win_valid, wall, n_chunks = _windows(
        torch.cat([feat, extra], 1), point_list, tile_start, tile_count, s)

    gL_rgb, gL_nn = g_out[..., 0:3], g_out[..., 3:6]
    gL_depth = g_out[..., 6]
    # the alpha channel (7) takes no gradient in the reference
    gL_reg = g_out[..., 8]
    T_final = aux.final_T
    final_A = (1.0 - T_final)[..., None]
    final_D1 = aux.dist1[..., None]
    bg_dot = (gL_rgb * bg).sum(-1)[..., None]
    px = (u * s.focal_x + s.width / 2.0 - 0.5)[..., None]   # backward.cu:770
    py = (v * s.focal_y + s.height / 2.0 - 0.5)[..., None]
    zero = torch.zeros((), dtype=dt, device=dev)

    def rev_cumsum_excl(x):
        return torch.flip(torch.cumsum(torch.flip(x, [-2]), -2), [-2]) - x

    T_right = T_final
    S_rgb_c = torch.zeros(T_final.shape + (3,), dtype=dt, device=dev)
    S_nn_c = torch.zeros_like(S_rgb_c)
    d_win = torch.zeros(wall.shape[:2] + (NFEAT + 3,), dtype=dt, device=dev)
    for ci in reversed(range(n_chunks)):
        sl = slice(ci * C, (ci + 1) * C)
        feat_c, ex_c = wall[:, sl, :NFEAT], wall[:, sl, NFEAT:]
        ct, vjp_fn = torch.func.vjp(lambda f: _chunk_eval(f, u, v), feat_c)
        alpha_raw = ct["alpha_raw"]
        vc = (_decide(ct, win_valid[:, sl]) if mask is None else
              _unpack_window_bits(mask, tile_start, ci * C, C)
              & win_valid[:, None, sl])
        pos = (ci * C + torch.arange(C, dtype=torch.int32, device=dev))[None, None, :]
        contrib = vc & (pos <= aux.last_pos[..., None])
        alpha = torch.where(contrib, alpha_raw, zero)
        om = 1.0 - alpha
        sp_incl = torch.flip(torch.cumprod(torch.flip(om, [-1]), -1), [-1])
        T_before = T_right[..., None] / sp_incl
        T_next_safe = torch.where(contrib, T_before * om, 1.0 + zero)
        om_safe = torch.where(contrib, om, 1.0 + zero)
        w = torch.where(contrib, T_before * alpha, zero)

        wc = w[..., None] * ct["rgb"]
        wnn = w[..., None] * ct["nn"]
        S_rgb = S_rgb_c[..., None, :] + rev_cumsum_excl(wc)
        S_nn = S_nn_c[..., None, :] + rev_cumsum_excl(wnn)

        # dL/dalpha (backward.cu:822-893): colour, normal and background
        d_alpha = (torch.einsum('tpj,tpcj->tpc', gL_rgb,
                                ct["rgb"] - S_rgb / T_next_safe[..., None])
                   + torch.einsum('tpj,tpcj->tpc', gL_nn,
                                  ct["nn"] - S_nn / T_next_safe[..., None]))
        d_alpha = d_alpha * T_before - T_final[..., None] / om_safe * bg_dot
        d_alpha = torch.where(contrib, d_alpha, zero)
        # distortion -> m with detached weights (backward.cu:839-852)
        d_m = torch.where(contrib, 2.0 * w * (ct["m"] * final_A - final_D1)
                          * gL_reg[..., None], zero)
        d_t = torch.where((pos == aux.max_pos[..., None]) & contrib,
                          gL_depth[..., None], zero)
        cots = {"alpha_raw": d_alpha, "G": torch.zeros_like(d_alpha),
                "t": d_t, "m": d_m, "nn": w[..., None] * gL_nn[:, :, None, :],
                "rgb": (w[..., None] * gL_rgb[:, :, None, :]).sum(
                    1, keepdim=True)}
        (d_feat_c,) = vjp_fn(cots)

        # densification stats through the conic (backward.cu:896-909)
        dL_dG = feat_c[:, None, :, ROW_OPA] * d_alpha
        G = ct["G"]
        dx = ex_c[..., 3][:, None, :] - px
        dy = ex_c[..., 4][:, None, :] - py
        gdx, gdy = G * dx, G * dy
        ca, cb, cc = (ex_c[..., i][:, None, :] for i in range(3))
        gx = dL_dG * (-gdx * ca - gdy * cb) * (0.5 * s.width)
        gy = dL_dG * (-gdy * cc - gdx * cb) * (0.5 * s.height)
        d_win[:, sl] = torch.cat([d_feat_c, torch.stack(
            [gx.sum(1), gy.sum(1), (gx.abs() + gy.abs()).sum(1)], -1)], -1)

        S_rgb_c = S_rgb_c + wc.sum(-2)
        S_nn_c = S_nn_c + wnn.sum(-2)
        T_right = T_right / torch.prod(om_safe, -1)

    seg = torch.where(win_valid, gids, P).reshape(-1)
    d_all = torch.zeros((P + 1, NFEAT + 3), dtype=dt, device=dev)
    d_all.index_add_(0, seg, d_win.reshape(-1, NFEAT + 3))
    return d_all[:P, :NFEAT], d_all[:P, NFEAT:]


class _Composite(torch.autograd.Function):
    """Compositing differentiable in the (P, NFEAT) feature table, with a
    (P, 3) stats dummy whose cotangent receives the densification
    statistics (the JAX package's composite_from_features,
    pallas_raster.py:636-711).  The conic/means2d table, the binning, bg
    and the RenderAux outputs take no gradient.  `kernel` picks the CUDA
    kernels in both directions, else the plain versions."""

    @staticmethod
    def forward(ctx, feat, stats, extra, point_list, tile_start, tile_count,
                bg, s, kernel):
        fwd = cuda_raster.composite_fwd if kernel else _composite_fwd_impl
        out, aux = fwd(feat, point_list, tile_start, tile_count, bg, s)
        ctx.save_for_backward(feat, extra, point_list, tile_start,
                              tile_count, bg, *aux)
        ctx.statics, ctx.kernel = s, kernel
        ctx.mark_non_differentiable(*aux)
        return (out, *aux)

    @staticmethod
    def backward(ctx, g_out, *_):
        feat, extra, point_list, tile_start, tile_count, bg, *aux = \
            ctx.saved_tensors
        bwd = cuda_raster.composite_bwd if ctx.kernel else _composite_bwd_impl
        d_feat, d_stats = bwd(feat, extra, point_list, tile_start, tile_count,
                              bg, RenderAux(*aux), g_out.contiguous(),
                              ctx.statics)
        return d_feat, d_stats, None, None, None, None, None, None, None


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
    """What compositing consumes, the same on every route of prepare: the
    (P, NFEAT) feature table (differentiable in the Gaussian inputs on the
    composed route), the (P, 5) conic | means2d table, the (P,) int32
    radii (0 for culled and masked-out Gaussians), the stats dummy, the
    binning, the statics and the background."""
    feat: torch.Tensor
    extra: torch.Tensor
    radii: torch.Tensor
    stats: torch.Tensor    # (P, 3) its gradient is the densification stats
    binning: B.Binning
    statics: RasterStatics
    bg: torch.Tensor


def _kernel_preprocess(dev, gaussians, colors_precomp) -> bool:
    """Whether prepare takes the preprocess kernel (cuda_raster.
    preprocess): the tensors are on CUDA, autograd records nothing of the
    five Gaussian inputs, and no colours are given.  Otherwise it composes
    the tables in _preprocess_impl, the differentiable route."""
    return (dev.type == "cuda" and colors_precomp is None
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in gaussians)))


def _preprocess_impl(means3d, scales, quats, opacities, shs, sh_degree,
                     camera, kernel_size=0.0, scale_modifier=1.0,
                     colors_precomp=None):
    """The composed preprocess, differentiable in the five Gaussian inputs
    and colors_precomp, and the plain version of cuda_raster.preprocess:
    core.gaussians.preprocess, then the tables compositing reads, (feat
    (P, NFEAT), extra (P, 5) conic | means2d, depths (P,), radii (P,)
    int32).  The feature table holds colors_precomp, where given, in place
    of the SH colours, and the opacity with the reference's gradient: the
    value is opacity * coef, but the cotangent reaches the opacity
    directly, skipping the low-pass coefficient (backward.cu:912; coef is
    1 at kernel_size 0 anyway)."""
    pre = G.preprocess(means3d, scales, quats, opacities, shs, sh_degree,
                       camera, kernel_size, scale_modifier)
    rgb = pre.rgb if colors_precomp is None else colors_precomp
    opa_flat = opacities.reshape(-1)
    opa = opa_flat + (pre.opa_coef - opa_flat).detach()
    return (_all_features(pre.v2g_mb, rgb, opa),
            torch.cat([pre.conic, pre.means2d], 1), pre.depths, pre.radii)


@profiling.spanned("prepare")
def prepare(means3d, scales, quats, opacities, shs, camera, bg=None, *,
            sh_degree: int = 1, kernel_size: float = 0.0,
            scale_modifier: float = 1.0, pair_cap: int = 1 << 18,
            max_per_tile: int = 1024, chunk: int = 128, colors_precomp=None,
            means2d_stats=None, mask=None, device=None,
            tile_rows=None, camera_row=None) -> CompositeInputs:
    """Preprocess and bin one Gaussian set for one camera (the part of
    `render` before compositing; same arguments).  CUDA tensors that
    autograd records nothing of, with no colors_precomp, take the
    preprocess kernel (cuda_raster.preprocess, one launch, which reads the
    camera from `camera_row`, or from a row it stages when that is None);
    everything else composes the same tables in _preprocess_impl from
    `camera`.  Spans (utils.profiling): `prepare`, with `preprocess` and
    bin_gaussians's `binning` inside."""
    dev = resolve_device(device, means3d if torch.is_tensor(means3d) else None)
    gaussians = [_as_tensor(a, dev)
                 for a in (means3d, scales, quats, opacities, shs)]
    with profiling.span("preprocess"):
        if _kernel_preprocess(dev, gaussians, colors_precomp):
            feat, extra, depths, radii = cuda_raster.preprocess(
                *(a.contiguous() for a in gaussians), sh_degree, camera,
                kernel_size, scale_modifier, camera_row)
        else:
            feat, extra, depths, radii = _preprocess_impl(
                *gaussians, sh_degree, camera, kernel_size, scale_modifier,
                None if colors_precomp is None
                else _as_tensor(colors_precomp, dev))
    if mask is not None:
        # dead slots are culled like frustum-failed Gaussians (no tile pairs)
        radii = torch.where(torch.as_tensor(mask, device=dev), radii,
                            torch.zeros_like(radii))
    stats = (torch.zeros((feat.shape[0], 3), device=dev)
             if means2d_stats is None else means2d_stats)

    bng, statics = bin_band(extra[:, 3:5], radii, depths, camera, tile_rows,
                            pair_cap=pair_cap, max_per_tile=max_per_tile,
                            chunk=chunk)
    bg = (torch.zeros(3, device=dev) if bg is None
          else _as_tensor(bg, dev).detach().reshape(3).contiguous())
    return CompositeInputs(feat, extra, radii, stats, bng, statics, bg)


def bin_band(means2d, radii, depths, camera, tile_rows=None, *,
             pair_cap: int, max_per_tile: int, chunk: int):
    """The binning and statics of a frame (tile_rows None) or of the band
    (row_off, n_rows): for a band the Gaussians move into band-local pixel
    space for the binning only, whose grid is the band's n_rows tile rows;
    the statics keep the frame's geometry and carry row_off."""
    row_off, n_rows = band_rows(tile_rows, camera)
    bin_m2d, bin_h = means2d, camera.height
    if tile_rows is not None:
        bin_m2d = means2d - means2d.new_tensor([0.0, float(row_off * BLOCK)])
        bin_h = n_rows * BLOCK
    # window and slab alignment: 256 whenever the window allows it
    lanes = 256 if max_per_tile % 256 == 0 else 128
    pair_cap = ((pair_cap + lanes - 1) // lanes) * lanes
    bng = B.bin_gaussians(bin_m2d, radii, depths, camera.width, bin_h,
                          pair_cap, max_per_tile=max_per_tile, align=lanes)
    statics = RasterStatics(width=camera.width, height=camera.height,
                            grid_x=bng.grid[0], grid_y=bng.grid[1],
                            focal_x=float(camera.focal_x),
                            focal_y=float(camera.focal_y),
                            max_per_tile=max_per_tile, chunk=chunk,
                            lanes=lanes, row_off=row_off)
    return bng, statics


def band_rows(tile_rows, camera):
    """(row_off, n_rows) of a band as Python ints, (0, all rows) for None;
    raises on a band that does not lie inside the frame's tile rows."""
    grid_y = -(-camera.height // BLOCK)
    if tile_rows is None:
        return 0, grid_y
    row_off, n_rows = (int(r) for r in tile_rows)
    if row_off < 0 or n_rows < 1 or row_off + n_rows > grid_y:
        raise ValueError(f"tile_rows {(row_off, n_rows)} is not a band of "
                         f"the frame's {grid_y} tile rows")
    return row_off, n_rows


def composite_from_features(feat, extra, binning: B.Binning,
                            statics: RasterStatics, bg, backend: str = "auto",
                            stats=None):
    """Composite from the (P, NFEAT) feature table (_all_features) and
    the (P, 5) conic | means2d table, differentiably in `feat` and in
    `stats` (an optional (P, 3) dummy whose gradient receives the
    densification statistics); extra, the binning and bg take none.
    The entry the tile-sharded renderer gathers its table into (the JAX
    package's pallas_raster.composite_from_features).  backend 'auto' runs
    the kernels (cuda_raster.composite_fwd, and composite_bwd for the
    gradient) for CUDA tensors and the plain versions for CPU tensors;
    'torch' always takes the plain versions.  Returns (out (num_tiles,
    PIX, 9), RenderAux)."""
    if backend not in ("auto", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    if stats is None:
        stats = feat.new_zeros((feat.shape[0], 3))
    kernel = backend == "auto" and feat.device.type != "cpu"
    out, *aux = _Composite.apply(feat, stats, extra.detach(),
                                 binning.point_list, binning.tile_start,
                                 binning.tile_count, bg, statics, kernel)
    return out, RenderAux(*aux)


def composite(inp: CompositeInputs, backend: str = "auto"):
    """Composite prepared inputs: composite_from_features on their tables,
    differentiably in inp.feat (so in what prepare built it from) and in
    inp.stats.  Returns (out (num_tiles, PIX, 9), RenderAux)."""
    return composite_from_features(inp.feat, inp.extra, inp.binning,
                                   inp.statics, inp.bg, backend, inp.stats)


def render(means3d, scales, quats, opacities, shs, camera, bg=None, *,
           sh_degree: int = 1, kernel_size: float = 0.0,
           scale_modifier: float = 1.0, pair_cap: int = 1 << 18,
           max_per_tile: int = 1024, chunk: int = 128, colors_precomp=None,
           means2d_stats=None, mask=None, backend: str = "auto", device=None,
           tile_rows=None, camera_row=None):
    """Render one Gaussian set through one camera, differentiably in the
    five Gaussian inputs (and colors_precomp).

    backend: 'auto' composites CUDA tensors in the hand-written kernels and
    CPU tensors in the plain PyTorch versions; 'torch' forces the plain
    versions (tests and chip_smoke.py compare the two with it).  The inputs
    may be tensors (their device is used) or arrays, which go to `device`
    (default `cuda`).  means2d_stats: an optional (P, 3) tensor whose
    gradient receives the densification statistics (the reference's
    screenspace_points dummy).

    tile_rows: None for the full frame, or (row_off, n_rows) to render only
    the band of n_rows 16-pixel tile rows from global tile row row_off (the
    unit of parallel/sharded.py); the images are then n_rows * 16 rows
    high.  A band of CUDA tensors runs the same kernels as a frame.

    camera_row: optional, for the preprocess kernel's route only: the
    (cuda_raster.CAMERA_FLOATS,) float32 device row of
    cuda_raster.camera_scalars(camera, kernel_size, scale_modifier), which
    the kernel reads when it runs (pipeline/renderer.py's stage table);
    None stages it from `camera`.

    Returns a dict with keys render (3,H,W), rendered_normal (camera space,
    unnormalized), rendered_depth, rendered_alpha, distortion_map, out9,
    radii, aux, binning and overflow (a 0-dim bool tensor: True iff
    pair_cap or max_per_tile was too small and the image is truncated).
    """
    inp = prepare(means3d, scales, quats, opacities, shs, camera, bg,
                  sh_degree=sh_degree, kernel_size=kernel_size,
                  scale_modifier=scale_modifier, pair_cap=pair_cap,
                  max_per_tile=max_per_tile, chunk=chunk,
                  colors_precomp=colors_precomp, means2d_stats=means2d_stats,
                  mask=mask, device=device, tile_rows=tile_rows,
                  camera_row=camera_row)
    out, aux = composite(inp, backend)
    s = inp.statics
    # a band's image is its own grid_y * 16 rows high
    img = _tiles_to_image(out, s if tile_rows is None else s._replace(
        height=s.grid_y * BLOCK))
    bng = inp.binning
    overflow = bng.overflow | torch.any(bng.tile_count > max_per_tile)
    return {
        "render": img[0:3],
        "rendered_normal": img[3:6],
        "rendered_depth": img[6:7],
        "rendered_alpha": img[7:8],
        "distortion_map": img[8:9],
        "out9": img,
        "radii": inp.radii,
        "aux": aux,
        "binning": bng,
        "overflow": overflow,
    }
