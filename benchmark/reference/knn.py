# Frozen copy of f3d_gaus_torch/ops/knn.py at commit b6ed6e2, the
# benchmark's plain reference; imports rewritten for this flat package.
"""Nearest-neighbour mean distance for per-point scale initialisation
(counterpart of f3d_gaus_tpu/ops/knn.py).

For every point, the mean of the squared distances to its 3 nearest
neighbours: the contract of simple-knn's `distCUDA2`, from which the
per-scene trainer initialises log-scales.  The JAX package's windowed
search, as torch ops (it runs once per scene, so it owes no kernel):

  * 10-bit-per-axis Morton codes on the bounding box, the uint32
    arithmetic done in int64 and masked to 32 bits after each multiply;
  * a stable argsort of the codes along each of several shifted Morton
    curves, and the candidates within +/- `window` ranks on each;
  * a row sort of the (P, shifts * 2 window) candidate distances by
    (distance, id) -- a stable sort by id, then a stable sort by distance
    -- duplicate ids masked, and the mean of the 3 smallest.

A missed neighbour can only make the reported distance larger.
`mean_dist3_exact` is the O(P^2) oracle, chunked over rows.
"""
from __future__ import annotations

import torch

K = 3  # neighbours, fixed by the reference contract
_U32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v (int64 holding uint32 values) so
    consecutive bits are 3 apart."""
    for mul, mask in ((0x00010001, 0xFF0000FF), (0x00000101, 0x0F00F00F),
                      (0x00000011, 0xC30C30C3), (0x00000005, 0x49249249)):
        v = ((v * mul) & _U32) & mask
    return v


def morton_codes(points: torch.Tensor, shift: float = 0.0,
                 scale: float = 1023.0) -> torch.Tensor:
    """30-bit 3D Morton codes on the bounding box of `points` (P, 3), as
    int64 holding the JAX package's uint32 values.  `shift` (in
    quantisation-grid units) translates the domain before quantisation, so
    shifted curves cut their coarse cells in different places."""
    points = points.float()
    lo = points.amin(0)
    hi = points.amax(0)
    ext = torch.clamp_min(hi - lo, 1e-12)
    q = torch.clamp(((points - lo) / ext) * scale + shift, 0.0, 1023.0)
    q = q.to(torch.int64)                       # truncation, as astype(uint32)
    x, y, z = (_expand_bits(q[:, i]) for i in range(3))
    return (x | (y << 1) | (z << 2)) & _U32


def _top3_mean(d2: torch.Tensor) -> torch.Tensor:
    """Mean of the 3 smallest entries along the last axis; each round masks
    only the first occurrence of its minimum."""
    big = torch.finfo(torch.float32).max
    total = torch.zeros(d2.shape[:-1], dtype=torch.float32, device=d2.device)
    for _ in range(K):
        m = d2.amin(-1)
        total = total + m
        is_min = d2 == m[..., None]
        first = torch.cumsum(is_min.to(torch.int32), -1) == 1
        d2 = torch.where(is_min & first, big, d2)
    return total / K


def _sq_dist(a, b):
    d = a - b
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def mean_dist3(points: torch.Tensor, window: int = 32,
               shifts: int = 6) -> torch.Tensor:
    """Approximate mean squared distance to the 3 nearest neighbours:
    points (P, 3) -> (P,) float32 on the points' device.  `window`
    candidates on each side of every point along each of `shifts` shifted
    Morton curves; the union is deduplicated by id before the top 3."""
    points = points.float()
    P, dev = points.shape[0], points.device
    big = torch.finfo(torch.float32).max
    offs = torch.cat([torch.arange(-window, 0, device=dev),
                      torch.arange(1, window + 1, device=dev)])
    scale = 1023.0 * (2.0 / (shifts + 1.0))
    cand_ids = []
    for s in range(shifts):
        shift = s * (1023.0 - scale) / max(shifts - 1, 1)
        order = torch.argsort(morton_codes(points, shift=shift, scale=scale),
                              stable=True)
        rank = torch.empty(P, dtype=torch.int64, device=dev)
        rank[order] = torch.arange(P, device=dev)
        idx = rank[:, None] + offs[None, :]                 # (P, 2W) ranks
        valid = (idx >= 0) & (idx < P)
        ids = order[idx.clamp(0, P - 1)]
        cand_ids.append(torch.where(valid, ids, P))         # P = sentinel
    cand = torch.cat(cand_ids, 1)                           # (P, S*2W)

    d2 = _sq_dist(points[cand.clamp_max(P - 1)], points[:, None, :])
    d2 = torch.where(cand == P, big, d2)
    # the row sort by (d2, id): stable by id, then stable by d2
    by_id = torch.argsort(cand, dim=1, stable=True)
    cand, d2 = cand.gather(1, by_id), d2.gather(1, by_id)
    by_d2 = torch.argsort(d2, dim=1, stable=True)
    ids_s, d2s = cand.gather(1, by_d2), d2.gather(1, by_d2)
    dup = torch.cat([torch.zeros((P, 1), dtype=torch.bool, device=dev),
                     ids_s[:, 1:] == ids_s[:, :-1]], 1)
    d2s = torch.where(dup, big, d2s)
    # after masking, the 3 smallest are among the first 3 + (#masked <= S-1)
    return _top3_mean(d2s[:, :3 * shifts])


def mean_dist3_exact(points: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Exact O(P^2) oracle, chunked over rows.  Test and small-P use only."""
    points = points.float()
    P = points.shape[0]
    big = torch.finfo(torch.float32).max
    out = []
    for c0 in range(0, P, chunk):
        rows = points[c0:c0 + chunk]
        d2 = _sq_dist(rows[:, None, :], points[None, :, :])
        ids = torch.arange(c0, c0 + rows.shape[0], device=points.device)
        self_mask = ids[:, None] == torch.arange(P, device=points.device)
        out.append(_top3_mean(torch.where(self_mask, big, d2)))
    return torch.cat(out)


def initial_log_scales(points: torch.Tensor, window: int = 32) -> torch.Tensor:
    """log(sqrt(clamp(dist2, 1e-7))) per point, tiled to 3 axes: the
    isotropic scale init of GaussianModel.create_from_pcd."""
    # an initial value: no gradient flows back to the points
    d2 = torch.clamp_min(mean_dist3(points, window=window), 1e-7)
    return torch.log(torch.sqrt(d2))[:, None].expand(-1, 3).contiguous()
