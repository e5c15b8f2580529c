"""Training: the feed-forward and per-scene trainers, their losses and
checkpoints (counterpart of f3d_gaus_tpu/train/)."""
