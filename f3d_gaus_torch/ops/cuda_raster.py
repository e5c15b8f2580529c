"""The compositing kernels on the card: loader and launch wrappers of
csrc/raster_fwd.cu and csrc/raster_bwd.cu (counterpart of
f3d_gaus_tpu/ops/pallas_raster.py).

Each kernel source is compiled with nvcc for sm_90a into a shared library
with a plain C interface at the first CUDA call (both at once, one nvcc
process per source), under build/kernels/ keyed by a hash of both sources
and the flags, and loaded with ctypes.  Importing this module needs no
CUDA toolchain.

`composite_fwd` and `composite_bwd` launch the kernels and accept only
CUDA tensors; rasterize.composite picks between them and the plain
PyTorch versions (rasterize._composite_fwd_impl / _composite_bwd_impl).
`launches` and `launches_bwd` count kernel launches.
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
SOURCES = {"fwd": CSRC / "raster_fwd.cu", "bwd": CSRC / "raster_bwd.cu"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = 0              # forward kernel launches since the last reset
launches_bwd = 0          # backward kernel launches since the last reset
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
        "compositing kernels (csrc/raster_*.cu) cannot be built")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "fwd": [_I, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _I, _P,
            _P, _P, _P, _P, _P, _P, _P, _P],
    "bwd": [_I, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _I, _P, _P,
            _P, _P, _P, _P, _P, _P, _P],
}


def load(rebuild: bool = False) -> dict:
    """Build (once per hash of the sources and flags, or anew with
    `rebuild`) and load both kernel libraries: {'fwd': CDLL, 'bwd': CDLL}.
    The nvcc runs go in parallel; any failure raises with its log."""
    global _libs, build_log
    if _libs is not None and not rebuild:
        return _libs
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SOURCES):
        h.update(SOURCES[name].read_bytes())
    key = h.hexdigest()[:16]
    sos = {name: BUILD_DIR / f"raster_{name}_{key}.so" for name in SOURCES}
    procs = {}
    for name, so in sos.items():
        if rebuild or not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
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
        fn = getattr(lib, f"f3d_raster_{name}")
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


def _check_slab(allf, point_list, tile_start, tile_count, bg, T):
    """The checks both wrappers share; returns the device."""
    _check("allf", allf, torch.float32)
    if allf.dim() != 2 or allf.shape[1] != R.NFEAT:
        raise ValueError(f"allf must be (P, {R.NFEAT}), got "
                         f"{tuple(allf.shape)}")
    _check("point_list", point_list, torch.int32)
    _check("tile_start", tile_start, torch.int32, (T,))
    _check("tile_count", tile_count, torch.int32, (T,))
    _check("bg", bg, torch.float32, (3,))
    dev = allf.device
    for name, t in (("point_list", point_list), ("tile_start", tile_start),
                    ("tile_count", tile_count), ("bg", bg)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, allf on {dev}")
    return dev


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def composite_fwd(allf, point_list, tile_start, tile_count, bg,
                  s: "R.RasterStatics"):
    """Compositing forward in the kernel from the (P, NFEAT) feature table
    and the aligned slab.  Returns (out (num_tiles, PIX, 9), RenderAux),
    the contract of rasterize._composite_fwd_impl."""
    global launches
    T = s.grid_x * s.grid_y
    dev = _check_slab(allf, point_list, tile_start, tile_count, bg, T)
    out = torch.empty((T, R.PIX, 9), dtype=torch.float32, device=dev)
    fl = [torch.empty((T, R.PIX), dtype=torch.float32, device=dev)
          for _ in range(4)]
    it = [torch.empty((T, R.PIX), dtype=torch.int32, device=dev)
          for _ in range(2)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load()["fwd"].f3d_raster_fwd(
        _device_index(dev), allf.data_ptr(), point_list.data_ptr(),
        tile_start.data_ptr(), tile_count.data_ptr(), T, s.grid_x,
        s.width / 2.0, s.height / 2.0, s.focal_x, s.focal_y, s.max_per_tile,
        bg.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in fl),
        *(t.data_ptr() for t in it), stream)
    if err != 0:
        raise RuntimeError(f"raster_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    aux = R.RenderAux(final_T=fl[0], dist1=fl[1], dist2=fl[2],
                      raw_distortion=fl[3], last_pos=it[0], max_pos=it[1])
    return out, aux


def composite_bwd(allf, extra, point_list, tile_start, tile_count, bg,
                  aux: "R.RenderAux", g_out, s: "R.RasterStatics"):
    """Compositing backward in the kernel: the (P, NFEAT) feature table,
    the (P, 5) conic/means2d table, the aligned slab, bg, the forward's
    RenderAux and g_out (num_tiles, PIX, 9), the cotangent of out9.
    Returns (d_feat (P, NFEAT), d_stats (P, 3)), the contract of
    rasterize._composite_bwd_impl."""
    global launches_bwd
    T = s.grid_x * s.grid_y
    dev = _check_slab(allf, point_list, tile_start, tile_count, bg, T)
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
    d_feat = torch.zeros((P, R.NFEAT), dtype=torch.float32, device=dev)
    d_stats = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = load()["bwd"].f3d_raster_bwd(
        _device_index(dev), allf.data_ptr(), extra.data_ptr(),
        point_list.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
        T, s.grid_x, s.width / 2.0, s.height / 2.0, s.focal_x, s.focal_y,
        s.max_per_tile, bg.data_ptr(), g_out.data_ptr(),
        aux.final_T.data_ptr(), aux.dist1.data_ptr(), aux.last_pos.data_ptr(),
        aux.max_pos.data_ptr(), d_feat.data_ptr(), d_stats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"raster_bwd kernel launch failed: CUDA error {err}")
    launches_bwd += 1
    return d_feat, d_stats
