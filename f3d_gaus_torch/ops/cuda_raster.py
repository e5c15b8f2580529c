"""The kernels on the card: loader and launch wrappers of the compositing
kernels csrc/gof_decide.cu, csrc/raster_fwd.cu and csrc/raster_bwd.cu,
which all include csrc/gof_pair.cuh (counterpart of
f3d_gaus_tpu/ops/pallas_raster.py), of the opacity-field query
csrc/integrate.cu (counterpart of f3d_gaus_tpu/ops/integrate.py), and of
the preprocess of an undifferentiated render csrc/preprocess.cu (no
counterpart: XLA fuses that code for the JAX package), and of the stage cap
planner csrc/footprint.cu (no counterpart: the JAX package's caps are
static).

Each kernel source is compiled with nvcc for sm_90a into a shared library
with a plain C interface at the first CUDA call (all at once, one nvcc
process per source), under build/kernels/ keyed by a hash of every file
under csrc/ and the flags (`build_key`), and loaded with ctypes.  Importing
this module needs no CUDA toolchain.

This is the bottom of the ops layer: it imports nothing above it.
ops/rasterize.py and ops/integrate.py choose between these wrappers and
their plain versions, and bind their names to what the kernels' ABI fixes,
defined here beside the launches that hard-code it: the feature table's
width and rows, the tile's pixels, the decision mask's layout and the field
query's plan.  The wrappers take the statics by their fields (rasterize.
RasterStatics) and return the forward's per-pixel side outputs as a tuple
in rasterize.RenderAux's order.

`decide` launches the decision pass: one bit per (slab slot, pixel) that
says whether the pair passes t > 0.2 and alpha >= 1/255 inside its tile's
window.  `composite_fwd` and `composite_bwd` launch it and then the
compositing or backward pass over the set bits.  `integrate` launches the
field query.  `preprocess` launches the per-Gaussian preprocess, which
reads its camera from a row in device memory, and writes the tables
compositing reads.  `footprint_need` counts what binning a render stage
needs from the stage's footprints, and reads the two counts back.  Every
wrapper accepts only CUDA tensors.
A band of a frame (rasterize.render(tile_rows=...)) launches the same
kernels with the statics' row_off, the global tile row of the band's
first row; the rays keep the full frame's half width and height.
While tracing is on (utils.profiling) each launch counts under
`launches.decide`, `launches.fwd`, `launches.bwd`, `launches.integrate`,
`launches.preprocess` or `launches.footprint`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..core.device import upload
from ..utils import profiling

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {"decide": CSRC / "gof_decide.cu", "fwd": CSRC / "raster_fwd.cu",
           "bwd": CSRC / "raster_bwd.cu", "integrate": CSRC / "integrate.cu",
           "preprocess": CSRC / "preprocess.cu",
           "footprint": CSRC / "footprint.cu"}
# each library's C entry points, in the order its source defines them
ENTRY = {"decide": ("f3d_gof_decide",), "fwd": ("f3d_raster_fwd",),
         "bwd": ("f3d_raster_bwd",),
         "integrate": ("f3d_integrate_prep", "f3d_integrate"),
         "preprocess": ("f3d_preprocess",),
         "footprint": ("f3d_footprint_need",)}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

build_log = ""            # nvcc/ptxas output of the builds this process made
_libs = None

# The compositing kernels' ABI (csrc/gof_pair.cuh: kPix, kNFeat, kRow*):
# the pixels of a 16 x 16 tile, and the (P, NFEAT) feature table's width
# and column offsets (the layout note of ops/rasterize.py:_all_features).
# The kernels read only the ids inside each tile's window, never the slab's
# padding id P, so the table needs no sentinel row.
PIX = 16 * 16
NFEAT = 19
ROW_QA = 0
ROW_QK = 6
ROW_B = 12
ROW_RGB = 15
ROW_OPA = 18
# The decision mask: bit s % 32 of word [s // 32, pixel] holds the decision
# of slab slot s for that pixel of its tile.  The decision pass walks the
# slab in blocks of MASK_SLOTS slots (csrc/gof_decide.cu:kSlots); tile
# segments start at multiples of it, so neither a block nor a word
# straddles two tiles.
MASK_SLOTS = 128


def mask_shape(point_list):
    """Shape of the decision mask of a slab: (slab / 32 words, PIX)."""
    return (point_list.shape[0] // 32, PIX)


# The field query's plan (csrc/integrate.cu): points per item, and the
# window slices an item takes.
POINTS_PER_ITEM = 512      # csrc/integrate.cu:kItemPoints
SLICE_LEN = 128            # least window rows per kernel item
MAX_SLICES = 8             # most slices per window (partial products a point)


def key_bits(num_tiles: int) -> int:
    """Bits per ray coordinate in the sort key: what int32 leaves beside
    the segment (0..T), at most 15."""
    return min(15, (31 - (num_tiles + 1).bit_length()) // 2)


def plan_bounds(num_points: int, num_tiles: int, max_per_tile: int,
                slice_len: int, per_item: int = POINTS_PER_ITEM):
    """Host bounds, with no sync, on a plan's (items, partial products):
    a window has at most min(MAX_SLICES, ceil(max_per_tile / slice_len))
    slices."""
    max_slices = min(MAX_SLICES, max(1, -(-max_per_tile // slice_len)))
    return ((num_points // per_item + num_tiles + 1) * max_slices,
            num_points * max_slices if max_slices > 1 else 0)


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
_ARGTYPES = {   # by entry point
    "f3d_gof_decide": [_I, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _I,
                       _I, _P, _P],
    "f3d_raster_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                       _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "f3d_raster_bwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                       _F, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "f3d_integrate_prep": [_I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P,
                           _P, _P],
    "f3d_integrate": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I,
                      _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "f3d_preprocess": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                       _P, _P],
    "f3d_footprint_need": [_I, _P, _P, _P, _I, _I, _P, _I, _I, _I, _P, _P],
}


def load(rebuild: bool = False) -> dict:
    """Build (once per build_key, or anew with `rebuild`) and load the
    kernel libraries: {'decide': CDLL, 'fwd': CDLL, 'bwd': CDLL,
    'integrate': CDLL, 'preprocess': CDLL, 'footprint': CDLL}.  The nvcc
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
        for entry in ENTRY[name]:
            fn = getattr(lib, entry)
            fn.argtypes = _ARGTYPES[entry]
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
    if allf.dim() != 2 or allf.shape[1] != NFEAT:
        raise ValueError(f"allf must be (P, {NFEAT}), got "
                         f"{tuple(allf.shape)}")
    _check("point_list", point_list, torch.int32)
    if point_list.dim() != 1 or point_list.shape[0] % MASK_SLOTS:
        raise ValueError(f"point_list must be a slab of a multiple of "
                         f"{MASK_SLOTS} slots, got "
                         f"{tuple(point_list.shape)}")
    if s.lanes % MASK_SLOTS:
        raise ValueError(f"the slab alignment must be a multiple of "
                         f"{MASK_SLOTS}, got {s.lanes}")
    _check("tile_start", tile_start, torch.int32, (T,))
    _check("tile_count", tile_count, torch.int32, (T,))
    named = [("point_list", point_list), ("tile_start", tile_start),
             ("tile_count", tile_count)]
    if mask is not None:
        _check("mask", mask, torch.int32, mask_shape(point_list))
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


def decide(allf, point_list, tile_start, tile_count, s):
    """The decision pass in the kernel: the (mask_words, PIX) int32 words of
    mask_shape, bit k of word [w, pixel] set where slab slot
    32 w + k passes t > 0.2 and alpha >= 1/255 for that pixel of its tile
    and lies inside the tile's window.  Only the words up to
    rasterize.mask_words_used are written; the rest stay uninitialised."""
    T = s.grid_x * s.grid_y
    dev = _check_slab(allf, point_list, tile_start, tile_count, T, s)
    mask = torch.empty(mask_shape(point_list), dtype=torch.int32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load()["decide"].f3d_gof_decide(
        _device_index(dev), allf.data_ptr(), point_list.data_ptr(),
        tile_start.data_ptr(), tile_count.data_ptr(), T, s.grid_x, s.row_off,
        s.width / 2.0, s.height / 2.0, s.focal_x, s.focal_y, s.max_per_tile,
        point_list.shape[0], mask.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"gof_decide kernel launch failed: CUDA error {err}")
    profiling.count("launches.decide")
    return mask


def composite_fwd(allf, point_list, tile_start, tile_count, bg, s,
                  mask=None):
    """Compositing forward in the kernels from the (P, NFEAT) feature table
    and the aligned slab: the decision pass (`decide`, skipped when its
    `mask` is given) and the compositing pass over its set bits.  Returns
    (out (num_tiles, PIX, 9), (final_T, dist1, dist2, raw_distortion,
    last_pos, max_pos)), the contract of rasterize._composite_fwd_impl with
    its RenderAux as a plain tuple."""
    T = s.grid_x * s.grid_y
    dev = _check_slab(allf, point_list, tile_start, tile_count, T, s, mask,
                      bg)
    if mask is None:
        mask = decide(allf, point_list, tile_start, tile_count, s)
    out = torch.empty((T, PIX, 9), dtype=torch.float32, device=dev)
    fl = [torch.empty((T, PIX), dtype=torch.float32, device=dev)
          for _ in range(4)]
    it = [torch.empty((T, PIX), dtype=torch.int32, device=dev)
          for _ in range(2)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load()["fwd"].f3d_raster_fwd(
        _device_index(dev), allf.data_ptr(), point_list.data_ptr(),
        tile_start.data_ptr(), tile_count.data_ptr(), mask.data_ptr(), T,
        s.grid_x, s.row_off, s.width / 2.0, s.height / 2.0, s.focal_x,
        s.focal_y, s.max_per_tile, bg.data_ptr(), out.data_ptr(),
        *(t.data_ptr() for t in fl), *(t.data_ptr() for t in it), stream)
    if err != 0:
        raise RuntimeError(f"raster_fwd kernel launch failed: CUDA error {err}")
    profiling.count("launches.fwd")
    return out, (*fl, *it)


def composite_bwd(allf, extra, point_list, tile_start, tile_count, bg,
                  aux, g_out, s, mask=None):
    """Compositing backward in the kernels: the (P, NFEAT) feature table,
    the (P, 5) conic/means2d table, the aligned slab, bg, the forward's
    six side outputs in RenderAux's order (composite_fwd's tuple or a
    RenderAux) and g_out (num_tiles, PIX, 9), the cotangent of out9.  The
    decision pass runs again on the forward's table and slab (skipped when
    its `mask` is given), then the backward pass over the set bits up to
    each pixel's last_pos.  Returns (d_feat (P, NFEAT), d_stats (P, 3)),
    the contract of rasterize._composite_bwd_impl."""
    T = s.grid_x * s.grid_y
    dev = _check_slab(allf, point_list, tile_start, tile_count, T, s, mask,
                      bg)
    P = allf.shape[0]
    final_T, dist1, _, _, last_pos, max_pos = aux
    _check("extra", extra, torch.float32, (P, 5))
    _check("g_out", g_out, torch.float32, (T, PIX, 9))
    for name, t in (("final_T", final_T), ("dist1", dist1)):
        _check(name, t, torch.float32, (T, PIX))
    for name, t in (("last_pos", last_pos), ("max_pos", max_pos)):
        _check(name, t, torch.int32, (T, PIX))
    for name, t in (("extra", extra), ("g_out", g_out),
                    ("final_T", final_T), ("last_pos", last_pos)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, allf on {dev}")
    if mask is None:
        mask = decide(allf, point_list, tile_start, tile_count, s)
    d_feat = torch.zeros((P, NFEAT), dtype=torch.float32, device=dev)
    d_stats = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load()["bwd"].f3d_raster_bwd(
        _device_index(dev), allf.data_ptr(), extra.data_ptr(),
        point_list.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
        mask.data_ptr(), T, s.grid_x, s.row_off, s.width / 2.0,
        s.height / 2.0, s.focal_x, s.focal_y, s.max_per_tile, bg.data_ptr(),
        g_out.data_ptr(), final_T.data_ptr(), dist1.data_ptr(),
        last_pos.data_ptr(), max_pos.data_ptr(), d_feat.data_ptr(),
        d_stats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"raster_bwd kernel launch failed: CUDA error {err}")
    profiling.count("launches.bwd")
    return d_feat, d_stats


def integrate(v2g_mb, opa, point_list, tile_start, tile_count, u, v, depth,
              tile, inside, max_per_tile: int, out=None,
              slice_len: int | None = None):
    """The field query of one view in the kernel: per query point, 1 - the
    product of (1 - alpha) over its tile's window (integrate.py:
    _alpha_impl's contract), 0 for points not `inside`.  v2g_mb (P, 12),
    opa (P,), the slab with its tile_start / tile_count (T,), and the
    points' u, v, depth (Q,) f32, tile (Q,) int32 and inside (Q,) bool.
    Returns a new (Q,) tensor, or with `out` ((Q,) f32) writes
    min(out, alpha) into it and returns it.

    One launch packs the rows (with the rejection's per-row threshold)
    and the points' sort keys (integrate_prep), torch.sort orders the
    points by key, and one more launches the plan kernel (blocks of
    POINTS_PER_ITEM points, windows cut into slices of at least `slice_len`
    rows, default SLICE_LEN, and at most MAX_SLICES slices;
    integrate._integrate_items is its plain version), the field and its
    second pass for the split windows.  No host sync."""
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
    slice_len = SLICE_LEN if slice_len is None else int(slice_len)
    if slice_len <= 0:
        raise ValueError(f"slice_len must be positive, got {slice_len}")
    dev = v2g_mb.device
    for name, t in (("opa", opa), ("point_list", point_list),
                    ("tile_start", tile_start), ("tile_count", tile_count),
                    ("u", u), ("v", v), ("depth", depth), ("tile", tile),
                    ("inside", inside), ("out", out)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, v2g_mb on {dev}")

    rows, keys = integrate_prep(v2g_mb, opa, u, v, tile, inside, T)
    keys, perm = torch.sort(keys)
    out = _integrate_launch(rows, keys, perm, point_list, tile_start,
                            tile_count, u, v, depth, max_per_tile, slice_len,
                            out)
    profiling.count("launches.integrate")
    return out


def integrate_prep(v2g_mb, opa, u, v, tile, inside, num_tiles: int):
    """The field query's row table and sort keys in one launch of
    csrc/integrate.cu's prep kernel (the plain versions integrate.
    _pack_rows and _point_keys): ((P + 1, 16) f32, (Q,) int32).  On
    checked tensors."""
    dev, P, Q = v2g_mb.device, v2g_mb.shape[0], u.shape[0]
    rows = torch.empty((P + 1, 16), dtype=torch.float32, device=dev)
    keys = torch.empty(Q, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load()["integrate"].f3d_integrate_prep(
        _device_index(dev), v2g_mb.data_ptr(), opa.data_ptr(), P,
        u.data_ptr(), v.data_ptr(), tile.data_ptr(), inside.data_ptr(), Q,
        num_tiles, key_bits(num_tiles), rows.data_ptr(), keys.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError(
            f"integrate_prep kernel launch failed: CUDA error {err}")
    return rows, keys


def _integrate_launch(rows, keys, perm, point_list, tile_start, tile_count,
                      u, v, depth, max_per_tile: int, slice_len: int,
                      out=None, plan=None):
    """The launch of `integrate` given its row table and its points' sorted
    keys and order (the wrapper's steps before it): the plan kernel, the
    field and the split windows' second pass, on checked tensors; counted
    by the wrapper, not here.  `plan`, when given, a (3 (T + 2) + 1,)
    int32 tensor, receives the plan's segment, item and partial starts
    (and the kernel's item counter)."""
    dev, Q, T = rows.device, u.shape[0], tile_start.shape[0]
    max_items, max_parts = plan_bounds(Q, T, max_per_tile, slice_len)
    part = torch.empty(max(max_parts, 1), dtype=torch.float32, device=dev)
    if plan is None:
        plan = torch.empty(3 * (T + 2) + 1, dtype=torch.int32, device=dev)
    running_min = out is not None
    if out is None:
        out = torch.empty(Q, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load()["integrate"].f3d_integrate(
        _device_index(dev), rows.data_ptr(), point_list.data_ptr(),
        tile_start.data_ptr(), tile_count.data_ptr(), T, rows.shape[0] - 1,
        max_per_tile, slice_len, MAX_SLICES, keys.data_ptr(),
        perm.data_ptr(), 2 * key_bits(T), plan.data_ptr(), u.data_ptr(),
        v.data_ptr(),
        depth.data_ptr(), part.data_ptr(), out.data_ptr(), int(running_min),
        Q, max_items, stream)
    if err != 0:
        raise RuntimeError(f"integrate kernel launch failed: CUDA error {err}")
    return out


CAMERA_FLOATS = 43   # csrc/screen.cuh:kCameraFloats


def camera_scalars(camera, kernel_size: float = 0.0,
                   scale_modifier: float = 1.0) -> list:
    """The camera constants of core.gaussians.preprocess as the f32 values
    its arithmetic uses, the row csrc/preprocess.cu reads from device
    memory, in its `Camera` order:
    world_view and full_proj (row-major), cam_center, focal_x, focal_y,
    the clip limits 1.3 tan_fov, kernel_size, scale_modifier, width and
    height.  Each is the composed route's own expression, rounded to f32
    where PyTorch rounds a Python scalar (round to nearest)."""
    def f32(x):
        return float(np.float32(x))
    mats = [np.asarray(m, np.float32).reshape(-1) for m in
            (camera.world_view, camera.full_proj, camera.cam_center)]
    return ([float(v) for m in mats for v in m]
            + [f32(v) for v in (camera.focal_x, camera.focal_y,
                                1.3 * camera.tan_fovx, 1.3 * camera.tan_fovy,
                                kernel_size, scale_modifier, camera.width,
                                camera.height)])


def camera_rows(camera, world_views, full_projs, cam_centers=None,
                kernel_size: float = 0.0, tangents=None) -> np.ndarray:
    """A (V, CAMERA_FLOATS) float32 array whose row v is camera_scalars of
    `camera` with view v's world_view, full_proj and cam_center (zeros
    where cam_centers is None) and, where `tangents` gives V (tan_fovx,
    tan_fovy) pairs, view v's tangents (its focal lengths and clip
    limits): V cameras that share the size and kernel_size, each row bit
    for bit its camera's."""
    wv = np.asarray(world_views, np.float32)
    V = wv.shape[0]
    centers = (np.zeros((V, 3), np.float32) if cam_centers is None
               else np.asarray(cam_centers, np.float32).reshape(V, 3))
    # the 35 values of world_view, full_proj and cam_center differ by view;
    # the scalars after them only where the tangents do
    if tangents is None:
        tail = np.asarray(camera_scalars(camera, kernel_size)[35:],
                          np.float32)
        tail = np.broadcast_to(tail, (V, len(tail)))
    else:
        tail = np.asarray([camera_scalars(camera._replace(
            tan_fovx=tx, tan_fovy=ty), kernel_size)[35:]
            for tx, ty in tangents], np.float32).reshape(V, -1)
    return np.concatenate(
        [wv.reshape(V, 16), np.asarray(full_projs, np.float32).reshape(V, 16),
         centers, tail], 1)


def preprocess(means, scales, quats, opacities, shs, sh_degree: int, camera,
               kernel_size: float = 0.0, scale_modifier: float = 1.0,
               camera_row=None):
    """The preprocess of a render that no gradient flows through, in one
    launch of csrc/preprocess.cu: (feat, extra, depths, radii), the
    (P, NFEAT) feature table (its opacity column the opacity times its
    low-pass coefficient), the (P, 5) conic | means2d table, the view-space
    depths and the int32 radii (0 where not valid), bit for bit what the
    plain version rasterize._preprocess_impl gives.  All five inputs must
    be CUDA tensors, float32 and contiguous: means and scales (P, 3), quats
    (P, 4), opacities P values, shs (P, K, 3) with K >= (sh_degree + 1)^2,
    sh_degree 0-3.

    The kernel reads the camera from device memory: `camera_row`, the
    (CAMERA_FLOATS,) float32 row of camera_scalars(camera, kernel_size,
    scale_modifier) on the inputs' device, read when the kernel runs (a
    CUDA graph that captured the launch reads what the row holds at its
    replay); None stages that row with core.device.upload.  No host
    sync."""
    P = means.shape[0]
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"sh_degree must be 0-3, got {sh_degree}")
    _check("means", means, torch.float32, (P, 3))
    _check("scales", scales, torch.float32, (P, 3))
    _check("quats", quats, torch.float32, (P, 4))
    _check("opacities", opacities, torch.float32)
    if opacities.numel() != P:
        raise ValueError(f"opacities must hold {P} values, got "
                         f"{tuple(opacities.shape)}")
    _check("shs", shs, torch.float32)
    if (shs.dim() != 3 or shs.shape[0] != P or shs.shape[2] != 3
            or shs.shape[1] < (sh_degree + 1) ** 2):
        raise ValueError(f"shs must be (P, >= {(sh_degree + 1) ** 2}, 3), "
                         f"got {tuple(shs.shape)}")
    dev = means.device
    if camera_row is None:
        camera_row = upload(camera_scalars(camera, kernel_size,
                                           scale_modifier), dev)
    _check("camera_row", camera_row, torch.float32, (CAMERA_FLOATS,))
    for name, t in (("scales", scales), ("quats", quats),
                    ("opacities", opacities), ("shs", shs),
                    ("camera_row", camera_row)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, means on {dev}")
    feat = torch.empty((P, NFEAT), dtype=torch.float32, device=dev)
    extra = torch.empty((P, 5), dtype=torch.float32, device=dev)
    depths = torch.empty(P, dtype=torch.float32, device=dev)
    radii = torch.empty(P, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load()["preprocess"].f3d_preprocess(
        _device_index(dev), means.data_ptr(), scales.data_ptr(),
        quats.data_ptr(), opacities.data_ptr(), shs.data_ptr(), P,
        shs.shape[1] * 3, sh_degree, camera_row.data_ptr(), feat.data_ptr(),
        extra.data_ptr(), depths.data_ptr(), radii.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"preprocess kernel launch failed: CUDA error {err}")
    profiling.count("launches.preprocess")
    return feat, extra, depths, radii


def footprint_need(xyz, scaling, rotation, world_views, full_projs, camera,
                   kernel_size: float, grid_x: int, grid_y: int,
                   tangents=None) -> dict:
    """binning.footprint_need in one launch of csrc/footprint.cu and its
    reduction: {'pairs': the most (Gaussian, tile) pairs of any (batch
    element, view), 'tile': the fullest tile's Gaussians of any}, exactly
    what the plain version binning._footprint_need_impl counts.  xyz,
    scaling (B, P, 3) and rotation (B, P, 4) must be CUDA tensors, float32
    and contiguous; world_views and full_projs V >= 1 (4, 4) matrices;
    `camera` gives the size all V share and, unless `tangents` gives each
    view's (tan_fovx, tan_fovy), the field of view, grid_x and grid_y its
    frame's tiles (binning's).  The cameras go up as a camera_rows table;
    the one host read is the two counts."""
    if xyz.dim() != 3:
        raise ValueError(f"xyz must be (B, P, 3), got {tuple(xyz.shape)}")
    B, P = xyz.shape[:2]
    _check("xyz", xyz, torch.float32, (B, P, 3))
    _check("scaling", scaling, torch.float32, (B, P, 3))
    _check("rotation", rotation, torch.float32, (B, P, 4))
    dev = xyz.device
    for name, t in (("scaling", scaling), ("rotation", rotation)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xyz on {dev}")
    rows = camera_rows(camera, world_views, full_projs,
                       kernel_size=kernel_size, tangents=tangents)
    V = rows.shape[0]
    if B == 0 or V == 0:
        raise ValueError(f"footprint_need needs a batch element and a view, "
                         f"got B = {B}, V = {V}")
    cells = (grid_x + 1) * (grid_y + 1)
    # the two counts, each (element, view)'s pairs, then its difference
    # grid of int32 cells
    scratch = torch.empty(2 + B * V + -(-B * V * cells // 2),
                          dtype=torch.int64, device=dev)
    table = upload(rows, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load()["footprint"].f3d_footprint_need(
        _device_index(dev), xyz.data_ptr(), scaling.data_ptr(),
        rotation.data_ptr(), B, P, table.data_ptr(), V, grid_x, grid_y,
        scratch.data_ptr(), stream)
    if err != 0:
        hint = (f" (a {camera.width} x {camera.height} frame's tile grid "
                "must fit in a block's shared memory)" if err == 1 else "")
        raise RuntimeError(
            f"footprint kernel launch failed: CUDA error {err}{hint}")
    profiling.count("launches.footprint")
    pairs, tile = scratch[:2].tolist()
    return {"pairs": pairs, "tile": tile}
