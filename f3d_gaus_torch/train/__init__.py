"""Training: the feed-forward trainer, its losses and checkpoints
(counterpart of f3d_gaus_tpu/train/)."""
