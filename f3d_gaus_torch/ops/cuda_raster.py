"""The compositing forward on the card: loader and launch wrapper of
csrc/raster_fwd.cu (counterpart of f3d_gaus_tpu/ops/pallas_raster.py).

The kernel source is compiled with nvcc for sm_90a into a shared library
with a plain C interface at the first CUDA call, under build/kernels/ keyed
by a hash of the source and flags, and loaded with ctypes.  Importing this
module needs no CUDA toolchain.

`composite_fwd` launches the kernel and accepts only CUDA tensors;
rasterize.composite picks between it and the plain PyTorch version
(rasterize._composite_fwd_impl).  `launches` counts kernel launches.
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

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "raster_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = 0              # kernel launches since the count was last reset
build_log = ""            # nvcc/ptxas output of the build this process made
_lib = None


def _all_features(v2g_mb, rgb, opa):
    """(P, NFEAT) feature table: the monomial-coefficient columns of
    rasterize._expand_feature_columns, one row per Gaussian.  The kernel
    reads only the ids inside each tile's window, never the slab's padding
    id P, so the table needs no sentinel row."""
    return torch.stack(R._expand_feature_columns(v2g_mb, rgb, opa), 1)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc was not found on PATH or under $CUDA_HOME/bin; the CUDA "
        "compositing kernel (csrc/raster_fwd.cu) cannot be built")


def load(rebuild: bool = False):
    """Build (once per source hash, or anew with `rebuild`) and load the
    kernel library."""
    global _lib, build_log
    if _lib is not None and not rebuild:
        return _lib
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"raster_fwd_{key}.so"
    if rebuild or not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.f3d_raster_fwd
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [I, P, P, P, P, I, I, F, F, F, F, I, P,
                   P, P, P, P, P, P, P, P]
    fn.restype = I
    _lib = lib
    return lib


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


def composite_fwd(allf, point_list, tile_start, tile_count, bg,
                  s: "R.RasterStatics"):
    """Compositing forward in the kernel from the (P, NFEAT) feature table
    and the aligned slab.  Returns (out (num_tiles, PIX, 9), RenderAux),
    the contract of rasterize._composite_fwd_impl."""
    global launches
    T = s.grid_x * s.grid_y
    _check("allf", allf, torch.float32)
    if allf.dim() != 2 or allf.shape[1] != R.NFEAT:
        raise ValueError(f"allf must be (P, {R.NFEAT}), got "
                         f"{tuple(allf.shape)}")
    _check("point_list", point_list, torch.int32)
    _check("tile_start", tile_start, torch.int32, (T,))
    _check("tile_count", tile_count, torch.int32, (T,))
    dev = allf.device
    _check("bg", bg, torch.float32, (3,))
    for name, t in (("point_list", point_list), ("tile_start", tile_start),
                    ("tile_count", tile_count), ("bg", bg)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, allf on {dev}")

    out = torch.empty((T, R.PIX, 9), dtype=torch.float32, device=dev)
    fl = [torch.empty((T, R.PIX), dtype=torch.float32, device=dev)
          for _ in range(4)]
    it = [torch.empty((T, R.PIX), dtype=torch.int32, device=dev)
          for _ in range(2)]
    lib = load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.f3d_raster_fwd(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        allf.data_ptr(), point_list.data_ptr(),
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
