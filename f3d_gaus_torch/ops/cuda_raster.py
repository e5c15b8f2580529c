"""The kernels on the card: loader and launch wrappers of the compositing
kernels csrc/gof_decide.cu, csrc/raster_fwd.cu and csrc/raster_bwd.cu,
which all include csrc/gof_pair.cuh (counterpart of
f3d_gaus_tpu/ops/pallas_raster.py), and of the opacity-field query
csrc/integrate.cu (counterpart of f3d_gaus_tpu/ops/integrate.py).

Each kernel source is compiled with nvcc for sm_90a into a shared library
with a plain C interface at the first CUDA call (all at once, one nvcc
process per source), under build/kernels/ keyed by a hash of every file
under csrc/ and the flags (`build_key`), and loaded with ctypes.  Importing
this module needs no CUDA toolchain.

`decide` launches the decision pass: one bit per (slab slot, pixel) that
says whether the pair passes t > 0.2 and alpha >= 1/255 inside its tile's
window.  `composite_fwd` and `composite_bwd` launch it and then the
compositing or backward pass over the set bits; all three accept only CUDA
tensors.  rasterize.composite picks between them and the plain PyTorch
versions (rasterize._contrib_mask_impl, _composite_fwd_impl,
_composite_bwd_impl).  `integrate` launches the field query; ops/
integrate.py picks between it and its plain version (_alpha_impl).
`launches_decide`, `launches`, `launches_bwd` and `launches_integrate`
count the launches of the four kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import rasterize as R

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {"decide": CSRC / "gof_decide.cu", "fwd": CSRC / "raster_fwd.cu",
           "bwd": CSRC / "raster_bwd.cu", "integrate": CSRC / "integrate.cu"}
ENTRY = {"decide": "f3d_gof_decide", "fwd": "f3d_raster_fwd",
         "bwd": "f3d_raster_bwd", "integrate": "f3d_integrate"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches_decide = 0       # decision-pass launches since the last reset
launches = 0              # compositing-pass launches since the last reset
launches_bwd = 0          # backward-pass launches since the last reset
launches_integrate = 0    # field-query launches since the last reset
build_log = ""            # nvcc/ptxas output of the builds this process made
_libs = None


def _all_features(v2g_mb, rgb, opa):
    """(P, NFEAT) feature table: the monomial-coefficient columns of
    rasterize._expand_feature_columns, one row per Gaussian.  The kernels
    read only the ids inside each tile's window, never the slab's padding
    id P, so the table needs no sentinel row."""
    return torch.stack(R._expand_feature_columns(v2g_mb, rgb, opa), 1)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc was not found on PATH or under $CUDA_HOME/bin; the CUDA "
        "compositing kernels (csrc/*.cu) cannot be built")


def build_key(csrc: Path = CSRC, flags=NVCC_FLAGS) -> str:
    """The build's cache key: a hash of the flags and of every file under
    `csrc` (names and bytes, headers included), so a changed header never
    loads a library built from the old one."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(p for p in Path(csrc).rglob("*") if p.is_file()):
        h.update(str(path.relative_to(csrc)).encode() + b"\0")
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "decide": [_I, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _I, _I, _P, _P],
    "fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _I, _P,
            _P, _P, _P, _P, _P, _P, _P, _P],
    "bwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _I, _P, _P,
            _P, _P, _P, _P, _P, _P, _P],
    "integrate": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                  _P, _I, _I, _P],
}


def load(rebuild: bool = False) -> dict:
    """Build (once per build_key, or anew with `rebuild`) and load the
    kernel libraries: {'decide': CDLL, 'fwd': CDLL, 'bwd': CDLL,
    'integrate': CDLL}.  The nvcc
    runs go in parallel; any failure raises with its log."""
    global _libs, build_log
    if _libs is not None and not rebuild:
        return _libs
    key = build_key()
    sos = {name: BUILD_DIR / f"raster_{name}_{key}.so" for name in SOURCES}
    procs = {}
    for name, so in sos.items():
        if rebuild or not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(SOURCES[name])]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    logs, failed = [], []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"[{SOURCES[name].name}]\n{out}")
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode})")
        else:
            os.replace(tmp, sos[name])
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{build_log}")
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, ENTRY[name])
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        libs[name] = lib
    _libs = libs
    return libs


def _check(name, t, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def _check_slab(allf, point_list, tile_start, tile_count, T, s, mask=None,
                bg=None):
    """The checks every wrapper shares; returns the device."""
    _check("allf", allf, torch.float32)
    if allf.dim() != 2 or allf.shape[1] != R.NFEAT:
        raise ValueError(f"allf must be (P, {R.NFEAT}), got "
                         f"{tuple(allf.shape)}")
    _check("point_list", point_list, torch.int32)
    if point_list.dim() != 1 or point_list.shape[0] % R.MASK_SLOTS:
        raise ValueError(f"point_list must be a slab of a multiple of "
                         f"{R.MASK_SLOTS} slots, got "
                         f"{tuple(point_list.shape)}")
    if s.lanes % R.MASK_SLOTS:
        raise ValueError(f"the slab alignment must be a multiple of "
                         f"{R.MASK_SLOTS}, got {s.lanes}")
    _check("tile_start", tile_start, torch.int32, (T,))
    _check("tile_count", tile_count, torch.int32, (T,))
    named = [("point_list", point_list), ("tile_start", tile_start),
             ("tile_count", tile_count)]
    if mask is not None:
        _check("mask", mask, torch.int32, R.mask_shape(point_list))
        named.append(("mask", mask))
    if bg is not None:
        _check("bg", bg, torch.float32, (3,))
        named.append(("bg", bg))
    dev = allf.device
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, allf on {dev}")
    return dev


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def decide(allf, point_list, tile_start, tile_count, s: "R.RasterStatics"):
    """The decision pass in the kernel: the (mask_words, PIX) int32 words of
    rasterize.mask_shape, bit k of word [w, pixel] set where slab slot
    32 w + k passes t > 0.2 and alpha >= 1/255 for that pixel of its tile
    and lies inside the tile's window.  Only the words up to
    rasterize.mask_words_used are written; the rest stay uninitialised."""
    global launches_decide
    T = s.grid_x * s.grid_y
    dev = _check_slab(allf, point_list, tile_start, tile_count, T, s)
    mask = torch.empty(R.mask_shape(point_list), dtype=torch.int32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load()["decide"].f3d_gof_decide(
        _device_index(dev), allf.data_ptr(), point_list.data_ptr(),
        tile_start.data_ptr(), tile_count.data_ptr(), T, s.grid_x,
        s.width / 2.0, s.height / 2.0, s.focal_x, s.focal_y, s.max_per_tile,
        point_list.shape[0], mask.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"gof_decide kernel launch failed: CUDA error {err}")
    launches_decide += 1
    return mask


def composite_fwd(allf, point_list, tile_start, tile_count, bg,
                  s: "R.RasterStatics", mask=None):
    """Compositing forward in the kernels from the (P, NFEAT) feature table
    and the aligned slab: the decision pass (`decide`, skipped when its
    `mask` is given) and the compositing pass over its set bits.  Returns
    (out (num_tiles, PIX, 9), RenderAux), the contract of
    rasterize._composite_fwd_impl."""
    global launches
    T = s.grid_x * s.grid_y
    dev = _check_slab(allf, point_list, tile_start, tile_count, T, s, mask,
                      bg)
    if mask is None:
        mask = decide(allf, point_list, tile_start, tile_count, s)
    out = torch.empty((T, R.PIX, 9), dtype=torch.float32, device=dev)
    fl = [torch.empty((T, R.PIX), dtype=torch.float32, device=dev)
          for _ in range(4)]
    it = [torch.empty((T, R.PIX), dtype=torch.int32, device=dev)
          for _ in range(2)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load()["fwd"].f3d_raster_fwd(
        _device_index(dev), allf.data_ptr(), point_list.data_ptr(),
        tile_start.data_ptr(), tile_count.data_ptr(), mask.data_ptr(), T,
        s.grid_x, s.width / 2.0, s.height / 2.0, s.focal_x, s.focal_y,
        s.max_per_tile, bg.data_ptr(), out.data_ptr(),
        *(t.data_ptr() for t in fl), *(t.data_ptr() for t in it), stream)
    if err != 0:
        raise RuntimeError(f"raster_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    aux = R.RenderAux(final_T=fl[0], dist1=fl[1], dist2=fl[2],
                      raw_distortion=fl[3], last_pos=it[0], max_pos=it[1])
    return out, aux


def composite_bwd(allf, extra, point_list, tile_start, tile_count, bg,
                  aux: "R.RenderAux", g_out, s: "R.RasterStatics", mask=None):
    """Compositing backward in the kernels: the (P, NFEAT) feature table,
    the (P, 5) conic/means2d table, the aligned slab, bg, the forward's
    RenderAux and g_out (num_tiles, PIX, 9), the cotangent of out9.  The
    decision pass runs again on the forward's table and slab (skipped when
    its `mask` is given), then the backward pass over the set bits up to
    each pixel's last_pos.  Returns (d_feat (P, NFEAT), d_stats (P, 3)),
    the contract of rasterize._composite_bwd_impl."""
    global launches_bwd
    T = s.grid_x * s.grid_y
    dev = _check_slab(allf, point_list, tile_start, tile_count, T, s, mask,
                      bg)
    P = allf.shape[0]
    _check("extra", extra, torch.float32, (P, 5))
    _check("g_out", g_out, torch.float32, (T, R.PIX, 9))
    for name in ("final_T", "dist1"):
        _check(name, getattr(aux, name), torch.float32, (T, R.PIX))
    for name in ("last_pos", "max_pos"):
        _check(name, getattr(aux, name), torch.int32, (T, R.PIX))
    for name, t in (("extra", extra), ("g_out", g_out),
                    ("final_T", aux.final_T), ("last_pos", aux.last_pos)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, allf on {dev}")
    if mask is None:
        mask = decide(allf, point_list, tile_start, tile_count, s)
    d_feat = torch.zeros((P, R.NFEAT), dtype=torch.float32, device=dev)
    d_stats = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load()["bwd"].f3d_raster_bwd(
        _device_index(dev), allf.data_ptr(), extra.data_ptr(),
        point_list.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
        mask.data_ptr(), T, s.grid_x, s.width / 2.0, s.height / 2.0,
        s.focal_x, s.focal_y, s.max_per_tile, bg.data_ptr(),
        g_out.data_ptr(), aux.final_T.data_ptr(), aux.dist1.data_ptr(),
        aux.last_pos.data_ptr(), aux.max_pos.data_ptr(), d_feat.data_ptr(),
        d_stats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"raster_bwd kernel launch failed: CUDA error {err}")
    launches_bwd += 1
    return d_feat, d_stats


INTEGRATE_POINTS_PER_CTA = 128     # integrate.cu:kThreads


def integrate(v2g_mb, opa, point_list, tile_start, tile_count, u, v, depth,
              tile, inside, max_per_tile: int, out=None):
    """The field query of one view in the kernel: per query point, 1 - the
    product of (1 - alpha) over its tile's window (integrate.py:
    _alpha_impl's contract), 0 for points not `inside`.  v2g_mb (P, 12),
    opa (P,), the slab with its tile_start / tile_count (T,), and the
    points' u, v, depth (Q,) f32, tile (Q,) int32 and inside (Q,) bool.
    Returns a new (Q,) tensor, or with `out` ((Q,) f32) writes
    min(out, alpha) into it and returns it.

    The points are sorted by tile here (torch.sort); each tile's points
    are cut into CTAs of INTEGRATE_POINTS_PER_CTA, the points outside
    forming one last segment with an empty window."""
    global launches_integrate
    P = v2g_mb.shape[0]
    _check("v2g_mb", v2g_mb, torch.float32, (P, 12))
    _check("opa", opa, torch.float32, (P,))
    _check("point_list", point_list, torch.int32)
    if point_list.dim() != 1:
        raise ValueError(
            f"point_list must be 1-D, got {tuple(point_list.shape)}")
    T = tile_start.shape[0]
    _check("tile_start", tile_start, torch.int32, (T,))
    _check("tile_count", tile_count, torch.int32, (T,))
    Q = u.shape[0]
    for name, t in (("u", u), ("v", v), ("depth", depth)):
        _check(name, t, torch.float32, (Q,))
    _check("tile", tile, torch.int32, (Q,))
    _check("inside", inside, torch.bool, (Q,))
    if out is not None:
        _check("out", out, torch.float32, (Q,))
    dev = v2g_mb.device
    for name, t in (("opa", opa), ("point_list", point_list),
                    ("tile_start", tile_start), ("tile_count", tile_count),
                    ("u", u), ("v", v), ("depth", depth), ("tile", tile),
                    ("inside", inside), ("out", out)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, v2g_mb on {dev}")

    K = INTEGRATE_POINTS_PER_CTA
    key, perm = torch.sort(torch.where(inside, tile, T))
    seg_start = torch.searchsorted(
        key, torch.arange(T + 2, dtype=key.dtype, device=dev)).to(torch.int32)
    blocks = (seg_start[1:] - seg_start[:-1] + K - 1) // K
    item_start = torch.zeros(T + 2, dtype=torch.int32, device=dev)
    item_start[1:] = torch.cumsum(blocks, 0)
    perm = perm.to(torch.int32)
    running_min = out is not None
    if out is None:
        out = torch.empty(Q, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load()["integrate"].f3d_integrate(
        _device_index(dev), v2g_mb.data_ptr(), opa.data_ptr(),
        point_list.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
        T, P, max_per_tile, perm.data_ptr(), seg_start.data_ptr(),
        item_start.data_ptr(), u.data_ptr(), v.data_ptr(), depth.data_ptr(),
        out.data_ptr(), int(running_min), Q // K + T + 1, stream)
    if err != 0:
        raise RuntimeError(f"integrate kernel launch failed: CUDA error {err}")
    launches_integrate += 1
    return out
