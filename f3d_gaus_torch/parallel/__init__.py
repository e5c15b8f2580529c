"""Multi-rank parallelism on torch.distributed (counterpart of
f3d_gaus_tpu/parallel/): the device mesh, data-parallel training and the
tile-sharded renderer."""
from . import mesh  # noqa: F401
