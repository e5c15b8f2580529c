"""f3d_gaus_torch: the PyTorch/CUDA port of f3d_gaus_tpu for NVIDIA Hopper.

The JAX package `f3d_gaus_tpu` stays the reference; this package mirrors its
layout and public names module by module, so each function here has a
counterpart of the same name there.  It imports `torch` and never `jax`,
and nothing of `f3d_gaus_tpu`.

Layer map (bottom to top):
  core/      cameras (numpy), quaternions, SH, per-Gaussian preprocess
  ops/       tile binning and the differentiable GOF compositing; forward
             and backward run in hand-written CUDA kernels
             (csrc/raster_fwd.cu, csrc/raster_bwd.cu, built with nvcc on
             first CUDA use) and in plain PyTorch versions for CPU tensors;
             the opacity-field query (csrc/integrate.cu); the KNN scale init
  models/    SongUNet predictor as nn.Modules keyed by the reference's
             torch state_dict names, plus the JAX -> torch weight converter
  pipeline/  config, demo dataset, renderer wrappers, cycle aggregation + NVS,
             the COLMAP / Blender scene readers
  train/     the feed-forward trainer and the per-scene (densifying GOF)
             trainer: losses, train steps, checkpoints
  mesh/      mesh extraction from the opacity field
  io/        PLY export (numpy)
  utils/     the viewer socket and logging sinks (numpy)
  cli.py     single image -> Gaussians -> NVS orbit frames (and a mesh)
  eval.py    PSNR / SSIM over render directories
  full_eval.py  per-scene fit -> test renders -> metrics over scenes

Entry points run on `cuda` unless the caller passes `device="cpu"` (or CPU
tensors); without a card they raise.
"""

__version__ = "0.1.0"
