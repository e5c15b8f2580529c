"""f3d_gaus_torch: the PyTorch/CUDA port of f3d_gaus_tpu for NVIDIA Hopper.

The JAX package `f3d_gaus_tpu` stays the reference; this package mirrors its
layout and public names module by module, so each function here has a
counterpart of the same name there.  It imports `torch` and never `jax`,
and nothing of `f3d_gaus_tpu`.

Layer map (bottom to top):
  core/      cameras (numpy), quaternions, SH, per-Gaussian preprocess
  ops/       tile binning and the differentiable GOF compositing, of a
             frame or of a band of its tile rows; forward and backward run
             in hand-written CUDA kernels (csrc/gof_decide.cu,
             csrc/raster_fwd.cu, csrc/raster_bwd.cu, built with nvcc on
             first CUDA use) and in plain PyTorch versions for CPU tensors;
             the opacity-field query (csrc/integrate.cu); the KNN scale init
  models/    SongUNet predictor as nn.Modules keyed by the reference's
             torch state_dict names, the VGG16 / CLIP ViT-B/32 loss towers
             (torchvision / OpenAI keys), and the JAX -> torch converters
  pipeline/  config, demo dataset, renderer wrappers, cycle aggregation + NVS,
             the COLMAP / Blender scene readers
  train/     the feed-forward trainer and the per-scene (densifying GOF)
             trainer: losses, train steps, checkpoints
  mesh/      mesh extraction from the opacity field
  io/        PLY export (numpy)
  parallel/  torch.distributed: the device mesh, data-parallel training
             and the tile-sharded renderer
  utils/     tracing and timing, the viewer socket and logging sinks
  cli.py     single image -> Gaussians -> NVS orbit frames (and a mesh)
  eval.py    PSNR / SSIM (and LPIPS from given weights) over render
             directories
  full_eval.py  per-scene fit -> test renders -> metrics over scenes

Entry points run on `cuda` unless the caller passes `device="cpu"` (or CPU
tensors); without a card they raise.
"""

__version__ = "0.1.0"
